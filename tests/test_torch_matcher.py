"""Port parity: Hamming distances and the tracking matchers, JAX vs torch.

Distances are integers, so every gate here is exact: the plain torch Hamming
against ops/hamming.py and against the Pallas kernel in interpret mode, and
mutual_best_match / resolve_duplicate_targets (both argmins take the first
index). Descriptors cross as numpy: uint32 for JAX, the same bits as int32
for the port.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.features import matcher as jm
from orb_slam3_modified_tpu.ops import hamming as jh
from orb_slam3_modified_tpu.ops.pallas_kernels import TILE, _hamming_kernel
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.features import matcher as tm
from orb_slam3_modified_tpu_torch.ops import hamming as th

torch.set_num_threads(2)


def _desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def _t(desc_u32):
    return convert.desc_from_uint32(desc_u32, device="cpu")


def _flip_bits(desc, n_bits, rng):
    d = desc.copy()
    for i in range(d.shape[0]):
        for _ in range(n_bits):
            d[i, rng.integers(0, 8)] ^= np.uint32(1 << int(rng.integers(0, 32)))
    return d


def _pallas_interpret(d1, d2):
    from jax.experimental import pallas as pl

    n1, n2 = d1.shape[0], d2.shape[0]
    return pl.pallas_call(
        _hamming_kernel,
        out_shape=jax.ShapeDtypeStruct((n1, n2), jnp.int32),
        grid_spec=pl.GridSpec(
            grid=(n1 // TILE, n2 // TILE),
            in_specs=[
                pl.BlockSpec((TILE, 8), lambda i, j: (i, 0)),
                pl.BlockSpec((TILE, 8), lambda i, j: (j, 0)),
            ],
            out_specs=pl.BlockSpec((TILE, TILE), lambda i, j: (i, j)),
        ),
        interpret=True,
    )(jnp.asarray(d1), jnp.asarray(d2))


class TestHammingParity:
    @pytest.mark.parametrize("n1,n2", [(128, 256), (128, 128), (200, 77)])
    def test_plain_matches_xla_bit_exact(self, n1, n2):
        rng = np.random.default_rng(n1 + n2)
        a, b = _desc(rng, n1), _desc(rng, n2)
        ref = np.asarray(jh.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
        out = th.hamming_matrix_plain(_t(a), _t(b)).numpy()
        np.testing.assert_array_equal(out, ref)

    @pytest.mark.parametrize("n1,n2", [(128, 256), (128, 128)])
    def test_plain_matches_pallas_interpret_bit_exact(self, n1, n2):
        rng = np.random.default_rng(7 * n1 + n2)
        a, b = _desc(rng, n1), _desc(rng, n2)
        ref = np.asarray(_pallas_interpret(a, b))
        np.testing.assert_array_equal(th.hamming_matrix_plain(_t(a), _t(b)).numpy(), ref)

    def test_wrapper_uses_plain_on_cpu_tensors(self):
        rng = np.random.default_rng(3)
        a, b = _t(_desc(rng, 33)), _t(_desc(rng, 45))
        np.testing.assert_array_equal(
            th.hamming_matrix(a, b).numpy(), th.hamming_matrix_plain(a, b).numpy()
        )

    def test_wrapper_does_not_fall_back_off_cpu(self):
        a = torch.empty((4, 8), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError):
            th.hamming_matrix(a, a)

    def test_pairs_and_popcount_edges(self):
        words = np.array([0, 1, -1, -(2**31), 2**31 - 1, 0x55555555], np.int32)
        want = np.array([bin(int(w) & 0xFFFFFFFF).count("1") for w in words])
        np.testing.assert_array_equal(th.popcount32(torch.from_numpy(words)).numpy(), want)
        rng = np.random.default_rng(4)
        a, b = _desc(rng, 50), _desc(rng, 50)
        ref = np.asarray(jh.hamming_pairs(jnp.asarray(a), jnp.asarray(b)))
        np.testing.assert_array_equal(th.hamming_pairs(_t(a), _t(b)).numpy(), ref)

    def test_descriptor_bits_round_trip(self):
        d = _desc(np.random.default_rng(5), 17)
        np.testing.assert_array_equal(convert.desc_to_uint32(_t(d)), d)


def _match_inputs(seed, n1=96, n2=80, flips=10):
    rng = np.random.default_rng(seed)
    d2 = _desc(rng, n2)
    src = rng.integers(0, n2, n1)
    d1 = _flip_bits(d2[src], flips, rng)
    d1[: n1 // 4] = _desc(rng, n1 // 4)  # unrelated rows
    v1 = rng.random(n1) > 0.1
    v2 = rng.random(n2) > 0.1
    mask = rng.random((n1, n2)) > 0.3
    return d1, v1, d2, v2, mask


class TestMatcherParity:
    @pytest.mark.parametrize("use_mask", [False, True])
    @pytest.mark.parametrize("max_dist,ratio", [(50, 1.0), (100, 0.9), (50, 0.8)])
    def test_mutual_best_match_exact(self, use_mask, max_dist, ratio):
        d1, v1, d2, v2, mask = _match_inputs(11)
        jidx, jok, jdist = jm.mutual_best_match(
            jnp.asarray(d1), jnp.asarray(v1), jnp.asarray(d2), jnp.asarray(v2),
            max_dist=max_dist, ratio=ratio,
            extra_mask=jnp.asarray(mask) if use_mask else None,
        )
        idx, ok, dist = tm.mutual_best_match(
            _t(d1), torch.from_numpy(v1), _t(d2), torch.from_numpy(v2),
            max_dist=max_dist, ratio=ratio,
            extra_mask=torch.from_numpy(mask) if use_mask else None,
        )
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))
        assert ok.sum() > 0

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_resolve_duplicate_targets_exact(self, seed):
        rng = np.random.default_rng(seed)
        n, n_t = 300, 40  # many sources per target: ties are common
        idx = rng.integers(0, n_t, n).astype(np.int32)
        ok = rng.random(n) > 0.3
        dist = rng.integers(0, 12, n).astype(np.int32)
        ref = np.asarray(jm.resolve_duplicate_targets(
            jnp.asarray(idx), jnp.asarray(ok), jnp.asarray(dist), n_t))
        keep = tm.resolve_duplicate_targets(
            torch.from_numpy(idx).long(), torch.from_numpy(ok), torch.from_numpy(dist), n_t)
        np.testing.assert_array_equal(keep.numpy(), ref)


# The cases of tests/test_matcher.py that the port covers, re-run on it.
class TestMatcherCases:
    def test_identical_zero(self):
        d = _t(_desc(np.random.default_rng(0), 16))
        assert (th.hamming_pairs(d, d) == 0).all()

    def test_known_flips(self):
        rng = np.random.default_rng(1)
        d = _desc(rng, 16)
        dist = th.hamming_pairs(_t(d), _t(_flip_bits(d, 5, rng))).numpy()
        assert (dist <= 5).all() and (dist >= 1).all()

    def test_matrix_agrees_with_pairs(self):
        rng = np.random.default_rng(2)
        a, b = _t(_desc(rng, 8)), _t(_desc(rng, 8))
        dm = th.hamming_matrix(a, b)
        for i in range(8):
            for j in range(8):
                assert dm[i, j] == th.hamming_pairs(a[i : i + 1], b[j : j + 1])[0]

    def test_perfect_permutation(self):
        rng = np.random.default_rng(3)
        d1 = _desc(rng, 64)
        perm = rng.permutation(64)
        v = torch.ones(64, dtype=torch.bool)
        idx, ok, _ = tm.mutual_best_match(_t(d1), v, _t(d1[perm]), v, max_dist=50)
        assert ok.all()
        np.testing.assert_array_equal(idx.numpy(), np.argsort(perm))

    def test_noise_tolerance(self):
        rng = np.random.default_rng(4)
        d1 = _desc(rng, 64)
        v = torch.ones(64, dtype=torch.bool)
        idx, ok, _ = tm.mutual_best_match(_t(d1), v, _t(_flip_bits(d1, 10, rng)), v, max_dist=50)
        assert (ok.numpy() & (idx.numpy() == np.arange(64))).mean() > 0.95

    def test_invalid_masked_out(self):
        d1 = _t(_desc(np.random.default_rng(5), 16))
        v1 = torch.ones(16, dtype=torch.bool)
        v1[3] = False
        _, ok, _ = tm.mutual_best_match(d1, v1, d1, torch.ones(16, dtype=torch.bool), max_dist=50)
        assert not bool(ok[3])

    def test_unmatched_below_threshold(self):
        rng = np.random.default_rng(6)
        v = torch.ones(32, dtype=torch.bool)
        _, ok, _ = tm.mutual_best_match(_t(_desc(rng, 32)), v, _t(_desc(rng, 32)), v, max_dist=50)
        assert ok.sum() == 0

    def test_duplicate_resolution(self):
        keep = tm.resolve_duplicate_targets(
            torch.tensor([5, 5, 3]), torch.tensor([True, True, True]),
            torch.tensor([10, 4, 7], dtype=torch.int32), 8,
        )
        assert keep.tolist() == [False, True, True]


# The host half's searches (search_for_initialization, search_by_projection)
# and the mapper's batched neighbour / fuse matches: exact idx / ok / dist.
def _frame(rng, n, d_src=None, noise=2.0, flips=6):
    """n features in a 752x480 frame; with d_src, copies of those
    descriptors (a few bits off) a few px from `uv_src`."""
    uv = (rng.random((n, 2)) * [752, 480]).astype(np.float32)
    desc = _desc(rng, n)
    if d_src is not None:
        src_uv, src_desc = d_src
        m = min(n, len(src_uv)) * 3 // 4
        uv[:m] = src_uv[:m] + rng.normal(0, noise, (m, 2)).astype(np.float32)
        desc[:m] = _flip_bits(src_desc[:m], flips, rng)
    return uv, desc, (rng.random(n) * 2 * np.pi).astype(np.float32), rng.integers(0, 8, n).astype(np.int32)


class TestHostSearchParity:
    def test_search_for_initialization_exact(self):
        rng = np.random.default_rng(21)
        uv1, d1, a1, _ = _frame(rng, 300)
        uv2, d2, a2, _ = _frame(rng, 280, (uv1 + 20.0, d1))
        a2[: 200] = a1[: 200] - 0.3  # a dominant rotation
        v1, v2 = rng.random(300) > 0.05, rng.random(280) > 0.05
        want = jm.search_for_initialization(*(jnp.asarray(x) for x in (uv1, a1, d1, v1, uv2, a2, d2, v2)))
        got = tm.search_for_initialization(
            torch.from_numpy(uv1), torch.from_numpy(a1), _t(d1), torch.from_numpy(v1),
            torch.from_numpy(uv2), torch.from_numpy(a2), _t(d2), torch.from_numpy(v2))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[1].sum() > 100

    @pytest.mark.parametrize("radius,ratio", [(15.0, 0.9), (4.0, 0.8)])
    def test_search_by_projection_exact(self, radius, ratio):
        rng = np.random.default_rng(int(radius))
        f_uv, f_d, _, f_lvl = _frame(rng, 256)
        p_uv, p_d, _, p_lvl = _frame(rng, 200, (f_uv, f_d))
        p_lvl[:150] = np.clip(f_lvl[:150] + rng.integers(-1, 2, 150), 0, 7)
        p_valid, f_valid = rng.random(200) > 0.1, rng.random(256) > 0.1
        r = (radius * 1.2 ** np.arange(8)).astype(np.float32)
        want = jm.search_by_projection(
            *(jnp.asarray(x) for x in (p_uv, p_lvl, p_d, p_valid, f_uv, f_lvl, f_d, f_valid, r)),
            level_tol=1, max_dist=jm.TH_HIGH, ratio=ratio)
        got = tm.search_by_projection(
            torch.from_numpy(p_uv), torch.from_numpy(p_lvl), _t(p_d), torch.from_numpy(p_valid),
            torch.from_numpy(f_uv), torch.from_numpy(f_lvl), _t(f_d), torch.from_numpy(f_valid),
            torch.from_numpy(r), level_tol=1, max_dist=tm.TH_HIGH, ratio=ratio)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert got[1].sum() > 50

    def test_rotation_consistency_mask_exact(self):
        rng = np.random.default_rng(5)
        a1 = (rng.random(400) * 2 * np.pi).astype(np.float32)
        a2 = (rng.random(300) * 2 * np.pi).astype(np.float32)
        idx = rng.integers(0, 300, 400)
        a1[:250] = a2[idx[:250]] + 0.5 + rng.normal(0, 0.02, 250).astype(np.float32)
        ok = rng.random(400) > 0.2
        want = jm.rotation_consistency_mask(jnp.asarray(a1), jnp.asarray(a2), jnp.asarray(idx),
                                            jnp.asarray(ok))
        got = tm.rotation_consistency_mask(torch.from_numpy(a1), torch.from_numpy(a2),
                                           torch.from_numpy(idx), torch.from_numpy(ok))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0 < got.sum() < ok.sum()


def _mapper_inputs(seed, F=128, NB=8):
    rng = np.random.default_rng(seed)
    d_k = _desc(rng, F)
    d_n = np.stack([_flip_bits(d_k[rng.permutation(F)], 6, rng) for _ in range(NB)])
    d_n[:, : F // 4] = _desc(rng, F // 4)[None]
    valid_n = rng.random((NB, F)) > 0.1
    return rng, d_k, d_n, valid_n


def test_batched_neighbor_match_exact():
    from orb_slam3_modified_tpu.mapping import local_mapper as jlm
    from orb_slam3_modified_tpu_torch.mapping import local_mapper as tlm

    rng, d_k, d_n, valid_n = _mapper_inputs(1)
    F, NB = d_k.shape[0], d_n.shape[0]
    free_k = rng.random(F) > 0.2
    r_k = np.concatenate([rng.normal(0, 0.3, (F, 2)), np.ones((F, 1))], 1).astype(np.float32)
    r_n = np.concatenate([rng.normal(0, 0.3, (NB, F, 2)), np.ones((NB, F, 1))], 2).astype(np.float32)
    E_n = rng.normal(0, 1, (NB, 3, 3)).astype(np.float32)
    th_n = rng.uniform(0.0, 0.5, (NB, F)).astype(np.float32)  # half the pairs pass the gate
    args = (d_k, free_k, r_k, d_n, valid_n, r_n, E_n, th_n)
    want = jlm._batched_neighbor_match(*(jnp.asarray(x) for x in args))
    got = tlm._batched_neighbor_match(_t(d_k), *(torch.from_numpy(x) for x in args[1:3]),
                                      _t(d_n.reshape(-1, 8)).view(NB, F, 8),
                                      *(torch.from_numpy(x) for x in args[4:]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].sum() > 0


def test_batched_fuse_match_exact():
    from orb_slam3_modified_tpu.mapping import local_mapper as jlm
    from orb_slam3_modified_tpu_torch.mapping import local_mapper as tlm

    rng, d_p, d_n, valid_n = _mapper_inputs(2)
    F, NB = d_p.shape[0], d_n.shape[0]
    uv_n = (rng.random((NB, F, 2)) * 100).astype(np.float32)
    uv_pred = uv_n + rng.normal(0, 2.0, (NB, F, 2)).astype(np.float32)
    val_p = rng.random((NB, F)) > 0.2
    args = (d_p, val_p, d_n, valid_n, uv_pred, uv_n)
    want = jlm._batched_fuse_match(*(jnp.asarray(x) for x in args))
    got = tlm._batched_fuse_match(_t(d_p), torch.from_numpy(val_p),
                                  _t(d_n.reshape(-1, 8)).view(NB, F, 8),
                                  *(torch.from_numpy(x) for x in args[3:]))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1].sum() > 0
