"""Binary bag-of-words vocabulary: flat-array tree and batched descent.

Port of orb_slam3_modified_tpu/bow/vocabulary.py (DBoW2's
TemplatedVocabulary: a k-ary tree of binary centroids, tf-idf weights, L1
scoring). Host numpy, as in the reference:
- the offline builder: hierarchical k-medians over binary descriptors with
  bit-majority centroids (the binary k-means that trains ORBvoc);
- the transform: descriptors -> word ids by batched tree descent, one
  (N, k) Hamming block and argmin per level;
- npz and ORBvoc.txt load / save, and the default vocabulary shipped with
  this package (assets/default_vocab.npz, the same bytes as the
  reference's asset).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np


def _popcount_rows(x: np.ndarray) -> np.ndarray:
    """uint32 array -> per-element popcount summed along last axis."""
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(axis=-1)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 8) x (M, 8) -> (N, M) Hamming distances (numpy, offline)."""
    x = a[:, None, :] ^ b[None, :, :]
    return _popcount_rows(x)


def _bit_majority(descs: np.ndarray) -> np.ndarray:
    """Majority-vote centroid of binary descriptors: (N, 8) -> (8,)."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)  # (N, 256)
    maj = (bits.sum(axis=0) * 2 >= len(descs)).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


@dataclasses.dataclass
class Vocabulary:
    """Flat-array k-ary vocabulary tree.

    nodes are stored level-contiguous; children[n] gives k child node ids
    (-1 padding). Leaves carry word ids and idf weights.
    """

    k: int
    depth: int
    node_desc: np.ndarray  # (Nodes, 8) uint32
    children: np.ndarray  # (Nodes, k) int32, -1 = none
    word_id: np.ndarray  # (Nodes,) int32, -1 for internal nodes
    word_weight: np.ndarray  # (W,) float32 idf
    n_words: int

    def transform_np(self, descs: np.ndarray, valid=None) -> np.ndarray:
        """Descriptors (N, 8) -> word ids (N,). Numpy path (host)."""
        n = len(descs)
        node = np.zeros(n, np.int64)  # root = 0
        for _ in range(self.depth):
            ch = self.children[node]  # (N, k)
            has_child = ch >= 0
            if not has_child.any():
                break
            ch_safe = np.where(has_child, ch, 0)
            cd = self.node_desc[ch_safe]  # (N, k, 8)
            d = _popcount_rows(descs[:, None, :] ^ cd)
            d = np.where(has_child, d, 10_000)
            pick = np.argmin(d, axis=1)
            nxt = ch_safe[np.arange(n), pick]
            node = np.where(has_child.any(axis=1), nxt, node)
        w = self.word_id[node]
        if valid is not None:
            w = np.where(valid, w, -1)
        return w.astype(np.int32)

    def bow_vector(self, word_ids: np.ndarray) -> dict:
        """tf-idf BowVector (word -> weight, L1-normalized).

        Reference: TemplatedVocabulary::transform with TF_IDF + L1 norm.
        """
        ids = word_ids[word_ids >= 0]
        if len(ids) == 0:
            return {}
        uniq, counts = np.unique(ids, return_counts=True)
        w = counts.astype(np.float64) * self.word_weight[uniq]
        s = w.sum()
        if s <= 0:
            return {}
        return dict(zip(uniq.tolist(), (w / s).tolist()))

    @staticmethod
    def score_l1(v1: dict, v2: dict) -> float:
        """L1 similarity in [0, 1] (reference: ScoringObject.cpp L1Scoring)."""
        score = 0.0
        for w, x in v1.items():
            y = v2.get(w)
            if y is not None:
                score += abs(x) + abs(y) - abs(x - y)
        return 0.5 * score


def build_vocabulary(
    descriptors: np.ndarray, k: int = 10, depth: int = 4, seed: int = 0,
    kmeans_iters: int = 8,
) -> Vocabulary:
    """Hierarchical binary k-medians (offline, numpy).

    Equivalent in role to TemplatedVocabulary::create; idf weights are
    computed treating each training descriptor as one "document" feature.
    """
    rng = np.random.default_rng(seed)
    node_desc = [np.zeros(8, np.uint32)]
    children = [[]]
    word_of_node = {}
    leaf_counts = []

    def cluster(descs, node_id, level):
        if level == depth or len(descs) <= k:
            # leaf: one word
            wid = len(leaf_counts)
            word_of_node[node_id] = wid
            leaf_counts.append(max(len(descs), 1))
            return
        kk = min(k, len(descs))
        # k-medians init: random distinct picks
        sel = rng.choice(len(descs), kk, replace=False)
        cents = descs[sel]
        for _ in range(kmeans_iters):
            d = _hamming_np(descs, cents)
            assign = np.argmin(d, axis=1)
            new_c = []
            for c in range(kk):
                members = descs[assign == c]
                new_c.append(_bit_majority(members) if len(members) else cents[c])
            cents = np.stack(new_c)
        d = _hamming_np(descs, cents)
        assign = np.argmin(d, axis=1)
        for c in range(kk):
            child_id = len(node_desc)
            node_desc.append(cents[c])
            children.append([])
            children[node_id].append(child_id)
            members = descs[assign == c]
            if len(members) == 0:
                members = cents[c : c + 1]
            cluster(members, child_id, level + 1)

    cluster(descriptors.astype(np.uint32), 0, 0)

    n_nodes = len(node_desc)
    ch_arr = np.full((n_nodes, k), -1, np.int32)
    for i, ch in enumerate(children):
        ch_arr[i, : len(ch)] = ch
    wid_arr = np.full(n_nodes, -1, np.int32)
    for nid, wid in word_of_node.items():
        wid_arr[nid] = wid
    n_words = len(leaf_counts)
    # idf: log(N / n_i)
    total = sum(leaf_counts)
    weights = np.log(np.maximum(total / np.maximum(np.array(leaf_counts, np.float64), 1.0), 1.0 + 1e-9)).astype(np.float32)
    return Vocabulary(
        k=k, depth=depth,
        node_desc=np.stack(node_desc).astype(np.uint32),
        children=ch_arr, word_id=wid_arr,
        word_weight=weights, n_words=n_words,
    )


def save_vocabulary_npz(path: str, voc: Vocabulary) -> None:
    """Persist a vocabulary as npz (the flat arrays serialize directly —
    the TPU-native analog of the reference's ORBvoc.txt distribution)."""
    np.savez_compressed(
        path,
        k=voc.k, depth=voc.depth, node_desc=voc.node_desc,
        children=voc.children, word_id=voc.word_id,
        word_weight=voc.word_weight, n_words=voc.n_words,
    )


def load_vocabulary_npz(path: str) -> Vocabulary:
    d = np.load(path)
    return Vocabulary(
        k=int(d["k"]), depth=int(d["depth"]),
        node_desc=d["node_desc"].astype(np.uint32),
        children=d["children"].astype(np.int32),
        word_id=d["word_id"].astype(np.int32),
        word_weight=d["word_weight"].astype(np.float32),
        n_words=int(d["n_words"]),
    )


def save_orbvoc_text(path: str, voc: Vocabulary) -> None:
    """Write the upstream ORBvoc.txt text format (DBoW2 text export):
    header 'k L scoring weighting' then one line per non-root node in
    node-id order: <parent> <is_leaf> <32 descriptor bytes> <weight>.

    Wire-compatible with TemplatedVocabulary::loadFromTextFile
    (Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1338) — the loader
    assigns node ids in line order and word ids in leaf-line order, so
    emitting nodes in id order round-trips both. Scoring/weighting are
    fixed to L1-norm (0) and TF-IDF (0), the ORB-SLAM settings.
    """
    n = len(voc.node_desc)
    parent = np.full(n, -1, np.int64)
    for p in range(n):
        ch = voc.children[p]
        parent[ch[ch >= 0]] = p
    with open(path, "w") as f:
        f.write(f"{voc.k} {voc.depth} 0 0\n")
        for i in range(1, n):
            byts = voc.node_desc[i].view(np.uint8)
            leaf = int(voc.word_id[i] >= 0)
            w = float(voc.word_weight[voc.word_id[i]]) if leaf else 0.0
            f.write(
                f"{parent[i]} {leaf} "
                + " ".join(str(int(b)) for b in byts)
                + f" {w}\n"
            )


DEFAULT_VOCAB_PATH = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets",
                                  "default_vocab.npz")


def default_vocabulary() -> Vocabulary:
    """The corpus-trained vocabulary shipped with this package
    (assets/default_vocab.npz, trained by scripts/train_default_vocab.py over
    rendered-scene ORB descriptors). A missing asset is a broken install and
    raises FileNotFoundError."""
    if not os.path.exists(DEFAULT_VOCAB_PATH):
        raise FileNotFoundError(f"the package's vocabulary asset is missing: {DEFAULT_VOCAB_PATH}")
    return load_vocabulary_npz(DEFAULT_VOCAB_PATH)


def load_orbvoc_text(path: str) -> Vocabulary:
    """Load the upstream ORBvoc.txt format (DBoW2 text export):
    header 'k L scoring weighting', then one node per line:
    parent_is_leaf? ... (format: <parent> <is_leaf> <32 byte values> <weight>).

    Reference: TemplatedVocabulary::loadFromTextFile
    (Thirdparty/DBoW2/DBoW2/TemplatedVocabulary.h:1338).
    """
    with open(path) as f:
        header = f.readline().split()
        k, depth = int(header[0]), int(header[1])
        nodes_desc = [np.zeros(8, np.uint32)]
        parents = [-1]
        weights_raw = [0.0]
        is_leaf = [False]
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            is_leaf.append(bool(int(parts[1])))
            byts = np.array([int(x) for x in parts[2:34]], np.uint8)
            nodes_desc.append(byts.view(np.uint32))
            weights_raw.append(float(parts[34]))
    n = len(nodes_desc)
    children = np.full((n, k), -1, np.int32)
    fill = np.zeros(n, np.int32)
    for i in range(1, n):
        p = parents[i]
        children[p, fill[p] % k] = i
        fill[p] += 1
    word_id = np.full(n, -1, np.int32)
    wts = []
    wid = 0
    for i in range(n):
        if is_leaf[i]:
            word_id[i] = wid
            wts.append(weights_raw[i])
            wid += 1
    return Vocabulary(
        k=k, depth=depth,
        node_desc=np.stack(nodes_desc).astype(np.uint32),
        children=children, word_id=word_id,
        word_weight=np.array(wts, np.float32), n_words=wid,
    )
