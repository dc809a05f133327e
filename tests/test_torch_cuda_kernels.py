"""Card-only tests of the port's hand-written CUDA kernels (marker `cuda`):
the Hamming matrix (csrc/hamming.cu entry 1) and the fused windowed
mutual-best match (entry 2), each exact against its plain torch version.

A CUDA kernel has no CPU mode, so each test checks inside its body for a
card and skips without one. The machine with the card has no JAX, so this
file imports only the port; run it there with

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q -p no:cacheprovider
"""
from unittest import mock

import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.features import matcher
from orb_slam3_modified_tpu_torch.ops import hamming as th
from orb_slam3_modified_tpu_torch.tracking import fused


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _desc(rng, n, dev):
    return convert.desc_from_uint32(rng.integers(0, 2**32, (n, 8), dtype=np.uint32), device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n1,n2", [(4096, 1024), (1024, 1024), (1000, 333), (1, 1), (65, 129), (17, 4097)])
def test_hamming_kernel_matches_plain(n1, n2):
    dev = _card()
    rng = np.random.default_rng(n1 * 7 + n2)
    a, b = _desc(rng, n1, dev), _desc(rng, n2, dev)
    before = th.HAMMING_KERNEL.launches
    out = th.hamming_matrix(a, b)
    torch.cuda.synchronize()
    assert th.HAMMING_KERNEL.launches == before + 1
    assert out.dtype == torch.int32 and out.shape == (n1, n2)
    assert torch.equal(out, th.hamming_matrix_plain(a, b))


@pytest.mark.cuda
def test_hamming_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _card()
    a = _desc(np.random.default_rng(0), 64, dev)
    with pytest.raises(ValueError):
        th.hamming_matrix(a.to(torch.int64), a.to(torch.int64))
    with pytest.raises(ValueError):
        th.hamming_matrix(a[:, :4].contiguous(), a[:, :4].contiguous())
    with pytest.raises(ValueError):
        th.hamming_matrix(a.t().contiguous().t(), a)
    with pytest.raises(ValueError):
        th.hamming_matrix(a, a.cpu())


def _match_scene(n1, n2, seed, dev):
    """Cache rows copying features (a few bits off), a third of the features
    drawn from a small pool (ties), invalid rows and columns, points in a
    200 px square."""
    rng = np.random.default_rng(seed)
    d2 = rng.integers(0, 2**32, (n2, 8), dtype=np.uint32)
    pool = rng.integers(0, 2**32, (max(n2 // 24, 2), 8), dtype=np.uint32)
    d2[: n2 // 3] = pool[rng.integers(0, len(pool), n2 // 3)]
    d1 = d2[rng.integers(0, n2, n1)].copy()
    for i in np.nonzero(rng.random(n1) < 0.5)[0]:
        d1[i, rng.integers(0, 8)] ^= np.uint32(1 << int(rng.integers(0, 32)))
    v1, v2 = rng.random(n1) > 0.1, rng.random(n2) > 0.1
    v1[: max(n1 // 50, 1)] = False
    uv1 = (rng.random((n1, 2)) * 200).astype(np.float32)
    uv2 = (rng.random((n2, 2)) * 200).astype(np.float32)
    r = (np.float32(15.0) * np.float32(1.2) ** rng.integers(0, 8, n2).astype(np.float32))
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    return (convert.desc_from_uint32(d1, device=dev), t(v1), convert.desc_from_uint32(d2, device=dev),
            t(v2), t(uv1), t(uv2), t(r.astype(np.float32)))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n1,n2", [(4096, 1024), (1000, 333), (1, 1), (65, 129), (17, 4097), (300, 2)])
@pytest.mark.parametrize("windowed", [True, False])
def test_fused_match_kernel_matches_plain(n1, n2, windowed):
    dev = _card()
    d1, v1, d2, v2, uv1, uv2, r = _match_scene(n1, n2, n1 + 3 * n2, dev)
    for max_dist, ratio in [(100, 0.9), (50, 0.8), (256, 1.0)]:
        before = matcher.MATCH_KERNEL.launches
        if windowed:
            got = matcher.windowed_mutual_best_match(d1, v1, d2, v2, uv1, uv2, r, max_dist, ratio)
            want = matcher.windowed_mutual_best_match_plain(
                d1, v1, d2, v2, uv1, uv2, r, max_dist, ratio)
        else:
            got = matcher.mutual_best_match(d1, v1, d2, v2, max_dist, ratio)
            want = matcher.mutual_best_match_plain(d1, v1, d2, v2, max_dist, ratio)
        torch.cuda.synchronize()
        assert matcher.MATCH_KERNEL.launches == before + 1
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert torch.equal(g, w)
        if n1 >= 1000:
            assert 0 < int(got[1].sum()) < n1


@pytest.mark.cuda
def test_fused_match_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _card()
    d1, v1, d2, v2, uv1, uv2, r = _match_scene(64, 32, 0, dev)
    with pytest.raises(ValueError):
        matcher.mutual_best_match(d1, v1.to(torch.uint8), d2, v2)
    with pytest.raises(ValueError):
        matcher.mutual_best_match(d1, v1, d2.to(torch.int64), v2)
    with pytest.raises(ValueError):
        matcher.windowed_mutual_best_match(d1, v1, d2, v2, uv1.t().contiguous().t(), uv2, r)
    with pytest.raises(ValueError):
        matcher.windowed_mutual_best_match(d1, v1, d2, v2, uv1, uv2, r.double())
    with pytest.raises(ValueError):
        matcher.windowed_mutual_best_match(d1, v1, d2, v2, uv1, uv2.cpu(), r)


@pytest.mark.cuda
@pytest.mark.parametrize("cols", [128, 512])
def test_fused_match_launcher_rejects_scratch_of_another_tiling(cols):
    dev = _card()
    d1, v1, d2, v2, _, _, _ = _match_scene(64, 300, 1, dev)
    before = matcher.MATCH_KERNEL.launches
    with mock.patch.object(matcher, "MATCH_COLS", cols), pytest.raises(RuntimeError):
        matcher.mutual_best_match(d1, v1, d2, v2)
    assert matcher.MATCH_KERNEL.launches == before


def _small_scene(dev):
    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.features.extractor import ExtractorConfig, ORBExtractor
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3
    from orb_slam3_modified_tpu_torch.tracking.fused import DeviceTrackState
    from orb_slam3_modified_tpu_torch.tracking.tracker import inv_level_sigma2
    from orb_slam3_modified_tpu_torch.utils.synthetic import orbit_trajectory
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import (
        make_texture, render_sequence, seed_map_cache,
    )

    k = 320 / 752
    cam = Camera.pinhole(458.654 * k, 457.296 * k, 367.215 * k, 248.375 * k, 320, 240, device=dev)
    cfg = ExtractorConfig(n_features=256, n_levels=4)
    T_all = orbit_trajectory(400, radius=4.0, sweep=np.pi / 2)
    T = SE3(T_all.R[:30], T_all.t[:30])
    frames = torch.from_numpy(render_sequence(cam, T, make_texture(0, 96, 1024))).to(dev)
    kf = [0, 8, 16, 24]
    cache = seed_map_cache(cam, ORBExtractor(cfg, 240, 320, device=dev)(frames[kf]),
                           SE3(T.R[kf], T.t[kf]), 2.0, 1024)
    state = DeviceTrackState(T.R[1].to(dev), T.t[1].to(dev), T.R[0].to(dev), T.t[0].to(dev),
                             torch.ones((), dtype=torch.bool, device=dev))
    return cam, cfg, T, frames, cache, state, inv_level_sigma2(4, 1.2)


@pytest.mark.cuda
def test_branch_free_step_captures_in_a_cuda_graph():
    """Under capture the step takes its branch-free form (no host read); the
    graph's replay gives that form's eager result bit for bit, and the fused
    match is in the graph (2 windowed passes, the brute match and the
    recovery's windowed pass)."""
    dev = _card()
    from orb_slam3_modified_tpu_torch.features.extractor import ORBExtractor
    from orb_slam3_modified_tpu_torch.tracking.fused import TrackStep

    cam, cfg, _, frames, cache, state, inv_s2 = _small_scene(dev)
    f = ORBExtractor(cfg, 240, 320, device=dev)(frames[2:3])
    args = (state, cache, f.uv[0], f.desc[0], f.level[0], f.valid[0])
    step = TrackStep(cam, inv_s2, cfg.n_features, device=dev)
    with mock.patch.object(fused, "_branch_free", lambda t: True):
        want = step(*args)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(*args)  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = matcher.MATCH_KERNEL.launches
    with torch.cuda.graph(graph):
        got = step(*args)
    assert matcher.MATCH_KERNEL.launches == before + 4
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_chunk_step_kernel_path_equals_plain_path():
    """A small chunk on the card: the fused match launches and gives the
    poses and cache associations of the plain matchers bit for bit."""
    dev = _card()
    from orb_slam3_modified_tpu_torch.tracking.chunked import make_chunk_step

    cam, cfg, T, frames, cache, state, inv_s2 = _small_scene(dev)
    before = matcher.MATCH_KERNEL.launches
    _, outs, _ = make_chunk_step(cam, inv_s2, cfg, device=dev)(state, cache, frames[2:6])
    assert matcher.MATCH_KERNEL.launches >= before + 2 * 4
    with mock.patch.multiple(
        fused, mutual_best_match=matcher.mutual_best_match_plain,
        windowed_mutual_best_match=matcher.windowed_mutual_best_match_plain,
    ):
        _, outs_p, _ = make_chunk_step(cam, inv_s2, cfg, device=dev)(state, cache, frames[2:6])
    assert torch.equal(outs.R, outs_p.R) and torch.equal(outs.t, outs_p.t)
    assert torch.equal(outs.obs_cache_idx, outs_p.obs_cache_idx)
    err = torch.linalg.norm(outs.t.cpu() - T.t[2:6], dim=-1)
    assert float(err.max()) < 0.05


# ---- the host half's matches and local BA on the card


@pytest.mark.cuda
def test_search_by_projection_on_the_matrix_kernel_equals_plain():
    """search_by_projection on CUDA tensors takes the matrix entry (one
    launch) and the torch reductions; equal to the plain matcher bit for bit."""
    dev = _card()
    rng = np.random.default_rng(11)
    n_p, n_f = 2048, 1024
    f_uv = (rng.random((n_f, 2)) * [752, 480]).astype(np.float32)
    f_desc = rng.integers(0, 2**32, (n_f, 8), dtype=np.uint32)
    src = rng.integers(0, n_f, n_p)
    p_desc = f_desc[src].copy()
    p_desc[:, 0] ^= rng.integers(0, 2**8, n_p, dtype=np.uint32)
    p_uv = f_uv[src] + rng.normal(0, 3, (n_p, 2)).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    args = (t(p_uv), t(rng.integers(0, 8, n_p).astype(np.int32)),
            convert.desc_from_uint32(p_desc, device=dev), t(rng.random(n_p) > 0.1),
            t(f_uv), t(rng.integers(0, 8, n_f).astype(np.int32)),
            convert.desc_from_uint32(f_desc, device=dev), t(rng.random(n_f) > 0.1),
            t((15.0 * 1.2 ** np.arange(8)).astype(np.float32)))
    before = th.HAMMING_KERNEL.launches
    got = matcher.search_by_projection(*args, level_tol=1, max_dist=100, ratio=0.9)
    torch.cuda.synchronize()
    assert th.HAMMING_KERNEL.launches == before + 1
    with mock.patch.object(matcher, "mutual_best_match", matcher.mutual_best_match_plain):
        want = matcher.search_by_projection(*args, level_tol=1, max_dist=100, ratio=0.9)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1].sum()) > 100


@pytest.mark.cuda
@pytest.mark.parametrize("nb,f", [(8, 1024), (3, 77)])
def test_batched_mapper_match_is_one_launch_and_equals_plain(nb, f):
    """The mapper's neighbour match: NB target sets concatenated into one
    (F, NB*F) matrix launch, reductions per set; equal to NB plain matches."""
    dev = _card()
    rng = np.random.default_rng(nb * f)
    d1 = rng.integers(0, 2**32, (f, 8), dtype=np.uint32)
    d2 = np.stack([d1[rng.permutation(f)] for _ in range(nb)])
    d2[..., 1] ^= rng.integers(0, 2**6, (nb, f), dtype=np.uint32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    desc1 = convert.desc_from_uint32(d1, device=dev)
    desc2 = convert.desc_from_uint32(d2.reshape(-1, 8), device=dev).view(nb, f, 8)
    v1, v2 = t(rng.random(f) > 0.1), t(rng.random((nb, f)) > 0.1)
    mask = t(rng.random((nb, f, f)) > 0.5)
    before = th.HAMMING_KERNEL.launches
    got = matcher.batched_mutual_best_match(desc1, v1, desc2, v2, 50, 0.8, extra_mask=mask)
    torch.cuda.synchronize()
    assert th.HAMMING_KERNEL.launches == before + 1
    for j in range(nb):
        want = matcher.mutual_best_match_plain(desc1, v1, desc2[j].contiguous(), v2[j], 50, 0.8,
                                               extra_mask=mask[j])
        for g, w in zip(got, want):
            assert torch.equal(g[j], w)


def _ba_problem(rng, n_kf=6, n_pts=300):
    """A small numpy BA problem: points in front of an arc of cameras,
    perturbed; cameras 0 and 1 fixed (so the scale is fixed too)."""
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3np
    from orb_slam3_modified_tpu_torch.optim.ba import BAProblem

    pts = rng.uniform(-1.5, 1.5, (n_pts, 3)).astype(np.float32)
    Rs, ts, cams, idx, uvs = [], [], [], [], []
    for k in range(n_kf):
        a = 0.08 * k
        R = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]], np.float32)
        t = np.array([0.3 * k, 0.0, 5.0], np.float32)
        pc = pts @ R.T + t
        uv = np.stack([458.0 * pc[:, 0] / pc[:, 2] + 367.0, 457.0 * pc[:, 1] / pc[:, 2] + 248.0], -1)
        Rs.append(R)
        ts.append(t)
        cams.append(np.full(n_pts, k, np.int32))
        idx.append(np.arange(n_pts, dtype=np.int32))
        uvs.append(uv + rng.normal(0, 0.5, uv.shape))
    t_all = np.stack(ts) + np.concatenate([np.zeros((2, 3)), rng.normal(0, 0.02, (n_kf - 2, 3))])
    fixed = np.zeros(n_kf, bool)
    fixed[:2] = True
    O = n_kf * n_pts
    return BAProblem(SE3np(np.stack(Rs), t_all.astype(np.float32)), fixed,
                     (pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32), np.ones(n_pts, bool),
                     np.concatenate(cams), np.concatenate(idx),
                     np.concatenate(uvs).astype(np.float32), np.ones(O, np.float32),
                     np.ones(O, bool))


@pytest.mark.cuda
def test_local_ba_on_the_card_matches_the_cpu_port():
    dev = _card()
    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.mapping.local_mapper import _pad_problem
    from orb_slam3_modified_tpu_torch.optim.ba import bundle_adjust, to_device

    prob = _ba_problem(np.random.default_rng(0))
    out = {}
    for d in ("cpu", dev):
        cam = Camera.pinhole(458.0, 457.0, 367.0, 248.0, 752, 480, device=d)
        res = bundle_adjust(to_device(_pad_problem(prob, d), d), cam, 2, 5)
        out[str(d)] = [x.cpu() for x in (res.T_cw.R[:6], res.T_cw.t[:6], res.points[:300],
                                         res.obs_inlier[:1800])]
    cpu, card = out["cpu"], out[str(dev)]
    assert torch.equal(cpu[3], card[3])
    for a, b in zip(cpu[:3], card[:3]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_local_ba_on_the_card_repeats_bit_for_bit():
    """The BA's sums over observations add in one order every run, so two
    solves of one problem agree to the bit (the async mapper's maps then
    depend only on the frames)."""
    dev = _card()
    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.mapping.local_mapper import _pad_problem
    from orb_slam3_modified_tpu_torch.optim.ba import bundle_adjust, to_device

    prob = to_device(_pad_problem(_ba_problem(np.random.default_rng(1), n_kf=12, n_pts=600), dev), dev)
    cam = Camera.pinhole(458.0, 457.0, 367.0, 248.0, 752, 480, device=dev)
    a, b = (bundle_adjust(prob, cam, 2, 5) for _ in range(2))
    for x, y in zip((a.T_cw.R, a.T_cw.t, a.points, a.obs_inlier, a.chi2),
                    (b.T_cw.R, b.T_cw.t, b.points, b.obs_inlier, b.chi2)):
        assert torch.equal(x, y)
