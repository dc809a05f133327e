"""Keyframe database: inverted word index for place recognition.

Port of orb_slam3_modified_tpu/bow/kfdb.py (KeyFrameDatabase,
src/KeyFrameDatabase.cc: DetectNBestCandidates :433 region with N = 3,
DetectRelocalizationCandidates; shared-word counting gated at 0.8 * max,
covisibility-group score accumulation). Host numpy: word -> keyframe
posting lists in a dict of lists, dense per-keyframe accumulators.
"""
from __future__ import annotations

import numpy as np

from .vocabulary import Vocabulary


class KeyFrameDatabase:
    def __init__(self, voc: Vocabulary, max_kf: int):
        self.voc = voc
        self.max_kf = max_kf
        self.inverted: dict[int, list[int]] = {}
        self.kf_words: dict[int, np.ndarray] = {}  # kf -> unique word ids
        self.kf_bow: dict[int, dict] = {}  # kf -> BowVector

    def add(self, kf: int, word_ids: np.ndarray):
        self.erase(kf)
        uniq = np.unique(word_ids[word_ids >= 0])
        self.kf_words[kf] = uniq
        self.kf_bow[kf] = self.voc.bow_vector(word_ids)
        for w in uniq.tolist():
            self.inverted.setdefault(w, []).append(kf)

    def erase(self, kf: int):
        if kf in self.kf_words:
            for w in self.kf_words[kf].tolist():
                lst = self.inverted.get(w)
                if lst and kf in lst:
                    lst.remove(kf)
            del self.kf_words[kf]
            self.kf_bow.pop(kf, None)

    def shared_word_counts(self, word_ids: np.ndarray, exclude: set):
        counts = np.zeros(self.max_kf, np.int32)
        for w in np.unique(word_ids[word_ids >= 0]).tolist():
            for kf in self.inverted.get(w, ()):
                if kf not in exclude:
                    counts[kf] += 1
        return counts

    def query(
        self,
        word_ids: np.ndarray,
        exclude: set,
        n_best: int = 3,
        covis_groups=None,
    ):
        """Top-N candidates by accumulated covisibility-group score.

        Mirrors DetectNBestCandidates: gate at 0.8 * max shared words,
        score with L1 BoW similarity, accumulate over each candidate's
        covisibility group, return best kf of each top group.

        covis_groups: dict kf -> [neighbor kfs], or a CALLABLE kf -> list —
        the callable form is evaluated only for the word-gated candidate set
        (a handful of keyframes), so callers never pay an O(K^2) covis-graph
        rebuild per query (the reference accumulates over
        GetBestCovisibilityKeyFrames of candidates only,
        src/KeyFrameDatabase.cc:433 region).
        """
        counts = self.shared_word_counts(word_ids, exclude)
        max_common = counts.max() if counts.size else 0
        if max_common < 5:
            return []
        th = max(int(0.8 * max_common), 5)
        cand = np.flatnonzero(counts >= th)
        qbow = self.voc.bow_vector(word_ids)
        scores = {int(k): Vocabulary.score_l1(qbow, self.kf_bow.get(int(k), {})) for k in cand}
        if callable(covis_groups):
            covis_groups = {k: covis_groups(k) for k in scores}
        # group accumulation
        results = []
        for k, s in scores.items():
            group = covis_groups.get(k, [k]) if covis_groups else [k]
            acc = s
            best_k, best_s = k, s
            for g in group:
                if g in scores and g != k:
                    acc += scores[g]
                    if scores[g] > best_s:
                        best_k, best_s = g, scores[g]
            results.append((acc, best_k))
        results.sort(key=lambda x: -x[0])
        out, seen = [], set()
        for acc, k in results:
            if k not in seen:
                out.append(k)
                seen.add(k)
            if len(out) >= n_best:
                break
        return out
