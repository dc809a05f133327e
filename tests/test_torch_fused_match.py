"""Port parity for the fused windowed mutual-best match (csrc/hamming.cu entry 2).

On the CPU the wrappers take the plain versions, so this file holds:
1. windowed_mutual_best_match_plain against the JAX computation it replaces
   (tracking/fused.py: the spatial window mask, then mutual_best_match), on
   ties (duplicated descriptors), all-masked rows and columns and features
   placed exactly at the radius, at the ratios the step uses. Exact.
2. The identity the kernel computes with (popc(a) + popc(b) - 2 popc(a & b),
   the tensor cores giving popc(a & b)) against hamming_matrix_plain. Exact.
3. A blocked torch rendering of the kernel's reductions (row partials
   (best, first idx, second) pushed per lane and merged across lanes, warps
   and column splits in any order; the column argmin as a min of
   (d << 32 | row) keys over row tiles) against the plain argmins on heavily
   tied inputs. Exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.features import matcher as jm
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.features import matcher as tm
from orb_slam3_modified_tpu_torch.ops import hamming as th

torch.set_num_threads(2)


def _t(desc_u32):
    return convert.desc_from_uint32(desc_u32, device="cpu")


@jax.jit
def _j_window(uv1, uv2, r):
    # tracking/fused.py's mask, as the step computes it under jit
    d2 = uv1[:, None, :] - uv2[None, :, :]
    return jnp.sum(d2 * d2, axis=-1) < (r * r)[None, :]


def _window_scene(seed, n1=300, n2=200):
    """A cache of n1 points and n2 features in a 120 px square (many pairs
    share a window), descriptors drawn from a small pool so distances tie,
    a few rows and columns invalid, and features placed exactly at the
    radius of the point they copy."""
    rng = np.random.default_rng(seed)
    pool = rng.integers(0, 2**32, (40, 8), dtype=np.uint32)
    d2 = pool[rng.integers(0, 40, n2)]
    src = rng.integers(0, n2, n1)
    d1 = d2[src].copy()
    flip = rng.random(n1) < 0.5  # half the points: a few bits off their feature
    for i in np.nonzero(flip)[0]:
        d1[i, rng.integers(0, 8)] ^= np.uint32(1 << int(rng.integers(0, 32)))
    uv1 = (rng.random((n1, 2)) * 120).astype(np.float32)
    level = rng.integers(0, 8, n2)
    r = (np.float32(4.0) * np.float32(1.2) ** level.astype(np.float32)).astype(np.float32)
    uv2 = (rng.random((n2, 2)) * 120).astype(np.float32)
    for k, j in enumerate(rng.choice(n2, 30, replace=False)):  # exactly at the radius
        i = int(rng.integers(0, n1))
        off = [(r[j], 0), (0, -r[j]), (r[j] * np.float32(0.999), 0)][k % 3]
        uv2[j] = uv1[i] + np.asarray(off, np.float32)
        d1[i] = d2[j]
    v1 = rng.random(n1) > 0.1
    v2 = rng.random(n2) > 0.1
    v1[:5] = False  # rows with nothing allowed
    v2[-3:] = False  # columns with nothing allowed
    return d1, v1, d2, v2, uv1, uv2, r


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("max_dist,ratio", [(100, 0.9), (50, 0.8), (100, 1.0)])
def test_windowed_plain_matches_reference(seed, max_dist, ratio):
    d1, v1, d2, v2, uv1, uv2, r = _window_scene(seed)
    spatial = _j_window(jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(r))
    jidx, jok, jdist = jm.mutual_best_match(
        jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2), jnp.asarray(v2),
        max_dist=max_dist, ratio=ratio, extra_mask=spatial,
    )
    args = (_t(d1), torch.from_numpy(v1), _t(d2), torch.from_numpy(v2),
            torch.from_numpy(uv1), torch.from_numpy(uv2), torch.from_numpy(r))
    idx, ok, dist = tm.windowed_mutual_best_match_plain(*args, max_dist=max_dist, ratio=ratio)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
    np.testing.assert_array_equal(
        tm.window_mask(*args[4:]).numpy(), np.asarray(spatial))
    assert 0 < int(ok.sum()) < len(ok)
    # the wrapper takes the plain version on CPU tensors
    for a, b in zip(tm.windowed_mutual_best_match(*args, max_dist=max_dist, ratio=ratio),
                    (idx, ok, dist)):
        assert torch.equal(a, b)


def test_window_scene_has_the_edge_cases():
    d1, v1, d2, v2, uv1, uv2, r = _window_scene(0)
    spatial = tm.window_mask(torch.from_numpy(uv1), torch.from_numpy(uv2), torch.from_numpy(r))
    allowed = spatial & torch.from_numpy(v1)[:, None] & torch.from_numpy(v2)[None, :]
    assert (~allowed.any(1)).sum() >= 5 and (~allowed.any(0)).sum() >= 3
    dm = th.hamming_matrix_plain(_t(d1), _t(d2))
    dm = torch.where(allowed, dm, 256)
    row_min = dm.amin(1, keepdim=True)
    assert ((dm == row_min).sum(1) > 1).sum() > 10  # rows whose best ties
    # pairs exactly at the radius (where uv1 + r rounds exactly) are outside the window
    on_edge = (torch.from_numpy(uv2) - torch.from_numpy(uv1)[:, None]).pow(2).sum(-1)
    assert ((on_edge == torch.from_numpy(r * r)[None]) & ~spatial).sum() >= 5


@pytest.mark.parametrize("max_dist,ratio", [(50, 1.0), (100, 0.9), (50, 0.8)])
def test_unwindowed_plain_matches_reference(max_dist, ratio):
    d1, v1, d2, v2, _, _, _ = _window_scene(2)
    jidx, jok, jdist = jm.mutual_best_match(
        jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2), jnp.asarray(v2),
        max_dist=max_dist, ratio=ratio)
    idx, ok, dist = tm.mutual_best_match_plain(
        _t(d1), torch.from_numpy(v1), _t(d2), torch.from_numpy(v2), max_dist, ratio)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))


def test_wrappers_do_not_fall_back_off_cpu():
    d = torch.empty((4, 8), dtype=torch.int32, device="meta")
    v = torch.empty((4,), dtype=torch.bool, device="meta")
    uv = torch.empty((4, 2), dtype=torch.float32, device="meta")
    r = torch.empty((4,), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        tm.mutual_best_match(d, v, d, v)
    with pytest.raises(ValueError):
        tm.windowed_mutual_best_match(d, v, d, v, uv, uv, r)


# --- 2. the AND identity -------------------------------------------------------------

def _and_identity(a, b):
    pa = torch.sum(th.popcount32(a), dim=1, dtype=torch.int32)
    pb = torch.sum(th.popcount32(b), dim=1, dtype=torch.int32)
    both = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32)
    for w in range(th.N_WORDS):
        both += th.popcount32(a[:, None, w] & b[None, :, w])
    return pa[:, None] + pb[None, :] - 2 * both


@pytest.mark.parametrize("kind", ["random", "all_ones", "zeros", "sign_bit", "mixed"])
def test_and_identity_equals_plain(kind):
    rng = np.random.default_rng(9)
    rand = rng.integers(0, 2**32, (37, 8), dtype=np.uint32).view(np.int32)
    special = {
        "all_ones": np.full((5, 8), -1, np.int32),
        "zeros": np.zeros((5, 8), np.int32),
        "sign_bit": np.full((5, 8), -(2**31), np.int32),
    }
    if kind == "random":
        a, b = rand, rng.integers(0, 2**32, (29, 8), dtype=np.uint32).view(np.int32)
    elif kind == "mixed":
        a = np.concatenate([rand[:7], *special.values()])
        b = np.concatenate([*special.values(), rand[7:12]])
    else:
        a, b = special[kind], np.concatenate([special[kind], rand[:6]])
    a, b = torch.from_numpy(np.ascontiguousarray(a)), torch.from_numpy(np.ascontiguousarray(b))
    assert torch.equal(_and_identity(a, b), th.hamming_matrix_plain(a, b))


# --- 3. the kernel's reductions, blocked ---------------------------------------------

EMPTY, NO_IDX = 1023, 2**31 - 1


def _push(p, d, j):
    best, idx, second = p
    lower = d < best
    return (torch.where(lower, d, best), torch.where(lower, j, idx),
            torch.where(lower, torch.minimum(second, best), torch.minimum(second, d)))


def _merge(p, o):
    (b1, i1, s1), (b2, i2, s2) = p, o
    second = torch.minimum(torch.minimum(s1, s2), torch.maximum(b1, b2))
    take = (b2 < b1) | ((b2 == b1) & (i2 < i1))
    return torch.where(take, b2, b1), torch.where(take, i2, i1), second


def _blocked_match(dm, max_dist, ratio, rows_per_block, cols_per_block, perm_seed):
    """The kernel's reductions over the masked matrix dm: per column block,
    4 warps x 4 lanes each push their columns (8-column tiles, 2 columns per
    lane) in increasing order; lane, warp and block partials are merged in a
    shuffled order. Column argmins come from min keys over row blocks."""
    n1, n2 = dm.shape
    rng = np.random.default_rng(perm_seed)
    empty = (torch.full((n1,), EMPTY), torch.full((n1,), NO_IDX), torch.full((n1,), 256))
    parts = []
    for j0 in range(0, n2, cols_per_block):
        tiles = cols_per_block // 8
        for w in range(4):
            for q in range(4):
                p = empty
                for nt in range(w * tiles // 4, (w + 1) * tiles // 4):
                    for e in range(2):
                        j = j0 + nt * 8 + 2 * q + e
                        if j < n2:
                            p = _push(p, dm[:, j], torch.full((n1,), j))
                parts.append(p)
    total = empty
    for k in rng.permutation(len(parts)):
        total = _merge(total, parts[k])
    best, idx, second = total
    rows = torch.arange(n1, dtype=torch.int64)
    key = torch.full((n2,), 2**63 - 1, dtype=torch.int64)
    for i0 in rng.permutation(np.arange(0, n1, rows_per_block)):
        blk = (dm[i0 : i0 + rows_per_block].to(torch.int64) << 32) | rows[i0 : i0 + rows_per_block, None]
        key = torch.minimum(key, blk.amin(0))
    mutual = (key[idx] & 0xFFFFFFFF) == rows
    ratio32 = torch.tensor(ratio, dtype=torch.float32)
    ok = (best <= max_dist) & (best.float() < ratio32 * second.float()) & mutual
    return idx, ok, best


@pytest.mark.parametrize("n1,n2,rows_per_block,cols_per_block",
                         [(96, 300, 32, 256), (70, 77, 32, 64), (33, 17, 16, 32)])
def test_blocked_reduction_equals_plain_on_ties(n1, n2, rows_per_block, cols_per_block):
    rng = np.random.default_rng(n1 + n2)
    pool = rng.integers(0, 2**32, (4, 8), dtype=np.uint32)  # 4 descriptors: ties everywhere
    d1, d2 = _t(pool[rng.integers(0, 4, n1)]), _t(pool[rng.integers(0, 4, n2)])
    v1 = torch.from_numpy(rng.random(n1) > 0.2)
    v2 = torch.from_numpy(rng.random(n2) > 0.2)
    mask = torch.from_numpy(rng.random((n1, n2)) > 0.4)
    mask[:3] = False  # rows with nothing allowed
    mask[:, :2] = False  # columns with nothing allowed
    allowed = v1[:, None] & v2[None, :] & mask
    dm = torch.where(allowed, _and_identity(d1, d2), 256)
    for max_dist, ratio in [(256, 1.0), (100, 0.9), (50, 0.8)]:
        want = tm.mutual_best_match_plain(d1, v1, d2, v2, max_dist, ratio, extra_mask=mask)
        for seed in range(3):
            got = _blocked_match(dm, max_dist, ratio, rows_per_block, cols_per_block, seed)
            for g, w in zip(got, want):
                assert torch.equal(g.to(w.dtype), w)
