"""Card-only tests of the port's hand-written CUDA kernels (marker `cuda`):
the Hamming matrix (csrc/hamming.cu entry 1) and the fused windowed
mutual-best match (entry 2), each exact against its plain torch version,
and the paths that launch them on the card: the chunk step, the host
searches, local BA, and loop closing (the closer's verification,
relocalization, the RANSACs, the pose graph, the global BA, and a
relocalize / merge / close course through SlamSystem).

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


# ---- loop closing and relocalization on the card


def _loop_scene(dev):
    """A small numpy map of the port's SyntheticFeatureWorld (ring layout):
    six keyframes along an orbit, each observing its visible world points
    (descriptors with bit flips, pixel noise), the points at their true
    positions; a loop closer and a keyframe database over it on `dev`, and
    one more frame near keyframe 2. The same seed gives the same scene on
    every device."""
    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3np
    from orb_slam3_modified_tpu_torch.loop.loop_closer import LoopCloser, LoopCloserConfig
    from orb_slam3_modified_tpu_torch.slam_map.map_state import MapState
    from orb_slam3_modified_tpu_torch.tracking.tracker import TrackerConfig
    from orb_slam3_modified_tpu_torch.bow.vocabulary import build_vocabulary
    from orb_slam3_modified_tpu_torch.utils.synthetic import orbit_trajectory
    from orb_slam3_modified_tpu_torch.utils.synthetic_features import SyntheticFeatureWorld

    cam = Camera.pinhole(458.654, 457.296, 367.215, 248.375, width=752, height=480, device="cpu")
    world = SyntheticFeatureWorld(n_points=12000, spread=10.0, seed=7, feat_cap=1024, noise_px=0.5,
                                  layout="ring")
    T = orbit_trajectory(90, radius=4.0, sweep=2.05 * np.pi)
    m = MapState.create(max_kf=16, max_mp=16384, feat_cap=1024)
    mp_of = {}
    for i in range(6):
        R, t = T.R[2 * i].numpy(), T.t[2 * i].numpy()
        f, idx = world.observe(cam, SE3np(R, t), max_feats=700)
        k = m.alloc_keyframe()
        m.kf_R[k], m.kf_t[k], m.kf_frame_id[k], m.kf_parent[k] = R, t, 2 * i, k - 1
        m.kf_uv[k], m.kf_desc[k], m.kf_level[k], m.kf_feat_valid[k] = f.uv, f.desc, f.level, f.valid
        for slot, p in enumerate(idx):
            if p not in mp_of:
                mp = int(m.alloc_points(1)[0])
                mp_of[p] = mp
                m.mp_pos[mp] = world.points[p]
                m.mp_desc[mp] = world.desc[p]
                m.mp_first_kf[mp] = k
            m.kf_obs[k, slot] = mp_of[p]
    closer = LoopCloser(LoopCloserConfig(), TrackerConfig(cam=cam),
                        build_vocabulary(world.desc[:4000], k=8, depth=3, seed=1), m, device=dev)
    for k in m.keyframe_indices():
        closer.kfdb.add(int(k), closer._words_of(int(k)))
    frame, _ = world.observe(cam, SE3np(T.R[5].numpy(), T.t[5].numpy()), max_feats=700)
    return m, closer, frame


def _recorded_matches(stack, module):
    """Patch module.mutual_best_match to record each call's (idx, ok) on the CPU."""
    calls = []
    fn = module.mutual_best_match

    def wrapper(*a, **k):
        out = fn(*a, **k)
        calls.append(tuple(x.cpu() for x in out[:2]))
        return out

    stack.enter_context(mock.patch.object(module, "mutual_best_match", wrapper))
    return calls


@pytest.mark.cuda
def test_closer_verify_and_relocalize_on_the_card_match_the_cpu_port():
    """_verify (BoW candidate -> fused match at (F, F) -> Sim3 RANSAC ->
    OptimizeSim3) and relocalize (query -> fused match -> PnP RANSAC ->
    polish) on CUDA tensors: the same match indices as the CPU port bit for
    bit, S and the pose within 1e-4, the same inliers and observations."""
    import contextlib

    from orb_slam3_modified_tpu_torch.loop import loop_closer, relocalization
    from orb_slam3_modified_tpu_torch.tracking.tracker import inv_level_sigma2

    dev = _card()
    out = {}
    for d in ("cpu", dev):
        m, closer, frame = _loop_scene(d)
        with contextlib.ExitStack() as stack:
            calls = _recorded_matches(stack, loop_closer)
            before = matcher.MATCH_KERNEL.launches
            ver = closer._verify(0, 3)
            rcalls = _recorded_matches(stack, relocalization)
            rel = relocalization.relocalize(closer.cam, closer.kfdb, closer.voc, m, frame,
                                            inv_level_sigma2(), 1234)
            launched = matcher.MATCH_KERNEL.launches - before
        out[str(d)] = (calls, ver, rcalls, rel, launched)
    c_calls, c_ver, c_rcalls, c_rel, _ = out["cpu"]
    g_calls, g_ver, g_rcalls, g_rel, g_launched = out[str(dev)]
    assert g_launched == len(g_calls) + len(g_rcalls) >= 2  # the fused entry, every match
    for a, b in zip(c_calls + c_rcalls, g_calls + g_rcalls, strict=True):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert c_ver is not None and g_ver is not None and c_ver[1] == g_ver[1]
    for a, b in zip(c_ver[0], g_ver[0]):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=0)
    assert all(np.array_equal(a, b) for a, b in zip(c_ver[2], g_ver[2]))
    assert c_rel is not None and g_rel is not None and np.array_equal(c_rel[1], g_rel[1])
    np.testing.assert_allclose(g_rel[0].R, c_rel[0].R, atol=1e-4)
    np.testing.assert_allclose(g_rel[0].t, c_rel[0].t, atol=1e-4)


def _chain_problem(dev, n=12, drift=0.03, seed=0):
    """tests/test_loop_components.py::TestPoseGraph's drifting chain with one
    loop edge, built with the port's Sim3 on `dev`."""
    from orb_slam3_modified_tpu_torch.lie import sim3
    from orb_slam3_modified_tpu_torch.lie import so3
    from orb_slam3_modified_tpu_torch.optim.pose_graph import PoseGraphProblem, make_relative

    rng = np.random.default_rng(seed)
    a = 2 * np.pi * np.arange(n) / n
    R = so3.exp(torch.tensor(np.stack([0 * a, 0 * a, a], 1), dtype=torch.float32))
    gt = sim3.Sim3(torch.ones(n), R, torch.tensor(np.stack([np.cos(a), np.sin(a), 0 * a], 1),
                                                  dtype=torch.float32))
    noise = sim3.exp(torch.tensor(np.concatenate([rng.normal(0, drift, (n, 6)),
                                                  rng.normal(0, drift * 0.3, (n, 1))], 1),
                                  dtype=torch.float32))
    est = [sim3.Sim3(gt.s[0], gt.R[0], gt.t[0])]
    for k in range(1, n):
        rel = sim3.Sim3(gt.s[k], gt.R[k], gt.t[k]) @ sim3.Sim3(gt.s[k - 1], gt.R[k - 1], gt.t[k - 1]).inverse()
        est.append((sim3.Sim3(noise.s[k], noise.R[k], noise.t[k]) @ rel) @ est[-1])
    S = sim3.Sim3(*(torch.stack(x) for x in zip(*est)))
    ei = torch.tensor(list(range(n - 1)) + [n - 1])
    ej = torch.tensor(list(range(1, n)) + [0])
    fixed = torch.zeros(n, dtype=torch.bool)
    fixed[0] = True
    prob = PoseGraphProblem(S, fixed, ei, ej, make_relative(gt, ei, ej), torch.ones(n), torch.ones(n, dtype=torch.bool))
    return type(prob)(*(x.to(dev) if isinstance(x, torch.Tensor) else sim3.Sim3(*(y.to(dev) for y in x))
                        for x in prob))


@pytest.mark.cuda
def test_ransacs_and_pose_graph_on_the_card_match_the_cpu_port():
    """Sim3 RANSAC and PnP RANSAC draw their minimal sets on a CPU generator
    and upload them, so the card solves the same hypotheses as the CPU port:
    the same inliers, S and the pose within 1e-4; the pose graph within 1e-4."""
    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.loop.relocalization import pnp_ransac
    from orb_slam3_modified_tpu_torch.loop.sim3_solver import solve_sim3_ransac
    from orb_slam3_modified_tpu_torch.optim.pose_graph import optimize_pose_graph

    dev = _card()
    rng = np.random.default_rng(5)
    p2 = rng.uniform(-2, 2, (512, 3)).astype(np.float32)
    c, s_ = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, -s_, 0], [s_, c, 0], [0, 0, 1]], np.float32)
    p1 = (0.8 * p2 @ R.T + [1.0, 0.5, -0.7]).astype(np.float32)
    p1[:150] += rng.uniform(1, 3, (150, 3)).astype(np.float32)
    valid = np.arange(512) < 400
    pw = np.concatenate([rng.uniform(-3, 3, (512, 2)), rng.uniform(4, 10, (512, 1))], 1).astype(np.float32)
    pc = pw @ R.T + [0.3, -0.1, 0.2]
    uv = np.stack([458.654 * pc[:, 0] / pc[:, 2] + 367.215, 457.296 * pc[:, 1] / pc[:, 2] + 248.375], 1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    uv[:100] += 50.0
    out = {}
    for d in ("cpu", dev):
        t = lambda a: torch.from_numpy(a).to(d)  # noqa: E731
        s3 = solve_sim3_ransac(t(p1), t(p2), t(valid), 7)
        cam = Camera.pinhole(458.654, 457.296, 367.215, 248.375, 752, 480, device=d)
        pnp = pnp_ransac(cam, t(pw), t(uv), t(valid), 9)
        pg = optimize_pose_graph(_chain_problem(d), False, 25)
        out[str(d)] = [x.cpu() for x in (s3.inliers, *s3.S_12, pnp.inliers, pnp.T_cw.R, pnp.T_cw.t, *pg)]
    cpu, card = out["cpu"], out[str(dev)]
    assert torch.equal(cpu[0], card[0]) and torch.equal(cpu[4], card[4])
    for a, b in zip(cpu, card):
        torch.testing.assert_close(b.float(), a.float(), atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_global_ba_in_a_grown_bucket_repeats_bit_for_bit():
    """The closer's global BA schedule (a Huber round, outliers reclassified,
    a plain round) over a problem past the local buckets (40 keyframes: the
    bucket grows to 64): two solves agree to the bit."""
    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.mapping.local_mapper import _pad_problem
    from orb_slam3_modified_tpu_torch.optim.ba import bundle_adjust, to_device

    dev = _card()
    base = _pad_problem(_ba_problem(np.random.default_rng(2), n_kf=40, n_pts=600), dev)
    assert base.T_cw.t.shape[0] == 64
    cam = Camera.pinhole(458.0, 457.0, 367.0, 248.0, 752, 480, device=dev)
    runs = []
    for _ in range(2):
        prob = to_device(base, dev)
        for round_idx in range(2):
            res = bundle_adjust(prob, cam, 1, 5, round_idx == 0)
            prob = prob._replace(T_cw=res.T_cw, points=res.points,
                                 obs_valid=prob.obs_valid & res.obs_inlier)
        runs.append((res.T_cw.R, res.T_cw.t, res.points, res.obs_inlier, res.chi2))
    for x, y in zip(*runs):
        assert torch.equal(x, y)


def _ring_pose(a):
    """tests/test_merge.py's ring pose at angle a: (R_cw, t_cw, centre)."""
    c = np.array([4 * np.sin(a), 0.4 * np.sin(3 * a), -4 * np.cos(a)])
    fwd = -c / np.linalg.norm(c)
    right = np.cross([0.0, -1.0, 0.0], fwd)
    right /= np.linalg.norm(right)
    R_cw = np.stack([right, np.cross(fwd, right), fwd], axis=1).T
    return R_cw.astype(np.float32), (-R_cw @ c).astype(np.float32), c


@pytest.mark.cuda
def test_system_relocalizes_merges_and_closes_on_the_card():
    """tests/test_merge.py::TestCrossMapMerge's course through the port's
    SlamSystem.track_features on the card: an arc (map 0), an 8-frame
    blackout (relocalization tried, then LOST: map 1), the arc again. The
    closer must merge map 1 back, close the loop, run its global BA, with
    every match on the fused entry, and keep test_merge's gates (one map,
    keyframe ATE < 0.5 m). Prints the closer's stage times (-s)."""
    import json

    from orb_slam3_modified_tpu_torch.bow.vocabulary import build_vocabulary
    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.eval.ate import ate_rmse
    from orb_slam3_modified_tpu_torch.features.extractor import Features
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3np
    from orb_slam3_modified_tpu_torch.system.slam_system import SlamSystem, SystemConfig
    from orb_slam3_modified_tpu_torch.utils.synthetic_features import SyntheticFeatureWorld

    dev = _card()
    cam = Camera.pinhole(458.654, 457.296, 367.215, 248.375, width=752, height=480, device=dev)
    world = SyntheticFeatureWorld(n_points=12000, spread=10.0, seed=7, feat_cap=768, noise_px=0.5,
                                  layout="ring")
    slam = SlamSystem(SystemConfig(cam=cam, feat_cap=768, max_kf=256, max_mp=65536,
                                   min_kfs_for_new_map=6, device=str(dev),
                                   vocabulary=build_vocabulary(world.desc[:4000], k=8, depth=3, seed=1)))
    # test_merge's tuning: a short lost budget, softer culling, a lower gate
    slam.tracker.cfg.recently_lost_budget = 3
    slam.mapper.cfg.kf_cull_redundancy = 0.97
    slam.closer.cfg.min_map_kfs = 5
    empty = Features(np.zeros((768, 2), np.float32), np.zeros((768, 8), np.uint32),
                     np.zeros(768, np.float32), np.zeros(768, np.int32), np.zeros(768, np.float32),
                     np.zeros(768, bool))
    gt, i = {}, 0
    launches0 = matcher.MATCH_KERNEL.launches
    for angles in (1.05 * np.pi * np.arange(70) / 70, None, 0.1 * np.pi + 0.9 * np.pi * np.arange(70) / 70):
        if angles is None:  # the blackout
            for _ in range(8):
                slam.track_features(empty, ts=i * 0.05)
                i += 1
            assert slam.map.n_maps == 2
            continue
        for a in angles:
            R, t, c = _ring_pose(a)
            feats, _ = world.observe(cam, SE3np(R, t), max_feats=600)
            slam.track_features(feats, ts=i * 0.05)
            gt[i] = c
            i += 1
    m, closer = slam.map, slam.closer
    live = m.keyframe_indices(all_maps=True)
    fids = m.kf_frame_id[live]
    sel = np.array([f in gt for f in fids])
    centres = np.stack([-m.kf_R[k].T @ m.kf_t[k] for k in live[sel]])
    ate, _ = ate_rmse(centres, np.stack([gt[f] for f in fids[sel]]))
    print(json.dumps({"card_merge_scene": {
        "merges": closer.n_merges, "loops_closed": closer.n_loops_closed, "gba_runs": closer.n_gba_runs,
        "loops": closer.loops, "reloc_attempts": slam.reloc_attempts,
        "keyframes": len(live), "keyframe_ate_m": ate,
        "fused_launches": matcher.MATCH_KERNEL.launches - launches0,
        "closer_stages": closer.stats.summary()}}))
    assert closer.n_merges >= 1 and closer.n_loops_closed >= 1 and closer.n_gba_runs >= 1
    assert slam.reloc_attempts >= 1
    assert matcher.MATCH_KERNEL.launches - launches0 >= closer.n_verifications
    assert len(np.unique(m.kf_map[live])) == 1
    assert ate < 0.5


@pytest.mark.cuda
def test_stereo_match_on_the_card_equals_the_cpu():
    """ops/stereo_match.py::match_stereo at the stereo phase's (1024, 1024):
    on the card the distance matrix is one launch of the matrix entry, and
    u_r, depth and valid equal the CPU's (the plain version) exactly."""
    dev = _card()
    from orb_slam3_modified_tpu_torch.ops.stereo_match import match_stereo

    rng = np.random.default_rng(11)
    n = 1024
    uv_l = np.stack([rng.uniform(0, 752, n), rng.uniform(0, 480, n)], -1).astype(np.float32)
    perm = rng.permutation(n)
    uv_r = uv_l[perm] - np.stack([rng.uniform(-5, 90, n), rng.normal(0, 1.0, n)], -1)
    lvl_l = rng.integers(0, 8, n)
    lvl_r = np.clip(lvl_l[perm] + rng.integers(-1, 2, n), 0, 7)
    d_l = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    d_r = np.where(rng.uniform(size=(n, 1)) < 0.5, d_l[perm] ^ (1 << rng.integers(0, 32, (n, 8))),
                   rng.integers(0, 2**32, (n, 8), dtype=np.uint32)).astype(np.uint32)
    cpu = [torch.from_numpy(uv_l), convert.desc_from_uint32(d_l, device="cpu"),
           torch.from_numpy(lvl_l.astype(np.int32)), torch.from_numpy(rng.uniform(size=n) < 0.95),
           torch.from_numpy(uv_r.astype(np.float32)), convert.desc_from_uint32(d_r, device="cpu"),
           torch.from_numpy(lvl_r.astype(np.int32)), torch.from_numpy(rng.uniform(size=n) < 0.95)]
    bf = 0.110074 * 458.654
    want = match_stereo(*cpu, bf, 0.3)
    before = th.HAMMING_KERNEL.launches
    got = match_stereo(*(a.to(dev) for a in cpu), bf, 0.3)
    torch.cuda.synchronize()
    assert th.HAMMING_KERNEL.launches == before + 1
    assert int(want[2].sum()) > 100
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
def test_remap_bilinear_on_the_card_matches_the_cpu():
    """cameras/rectify.py::remap_bilinear at 752x480 with EuRoC's
    rectification maps (tests/test_rectify.py's calibration): the card's
    result within 1e-3 grey levels of the CPU's (a lerp of four float32
    products, which the card may contract into fused multiply-adds)."""
    dev = _card()
    from orb_slam3_modified_tpu_torch.cameras.rectify import build_rectification

    K1 = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1]])
    D1 = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0])
    K2 = np.array([[457.587, 0, 379.999], [0, 456.134, 255.238], [0, 0, 1]])
    D2 = np.array([-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05, 0.0])
    c, s = np.cos(0.003), np.sin(0.003)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    rect = build_rectification(K1, D1, K2, D2, (752, 480), R,
                               np.array([-0.1100738, 0.000399121, -0.000853703]))
    rng = np.random.default_rng(3)
    left = torch.from_numpy(rng.integers(0, 256, (480, 752), dtype=np.uint8))
    right = torch.from_numpy(rng.integers(0, 256, (480, 752), dtype=np.uint8))
    cpu = rect.remap(left, right)
    card = rect.remap(left.to(dev), right.to(dev))
    for a, b in zip(cpu, card):
        assert b.device.type == "cuda" and b.shape == (480, 752)
        torch.testing.assert_close(b.cpu(), a, atol=1e-3, rtol=0)
