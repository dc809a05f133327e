"""Port parity for stereo: ops/stereo_match.py, the stereo rows of
optim/ba.py, the tracker with depth, the stereo chunk step and SlamSystem's
STEREO sensor, JAX vs torch on the same numpy inputs.

Tolerances: the rectified match is exact (u_r, depth, valid: the same
distances, the first index on ties, one float32 division); the SAD
refinement 1e-4 px and the non-rectified (KB8) match 1e-4 m (float32 sums);
the stereo BA 1e-4, absolute and relative, with the same inlier mask; the tracker on the reference's
stereo_seq 1e-4 with the same keyframes (no random draw: the map starts
from depth); the chunk step given the same features 1e-5, each frame's
step from the reference's own state (as test_torch_chunk_step.py; chained,
the frames' float32 roundings add up), end to end 1e-3 (each package
extracts its own pyramid levels >= 1, test_torch_extractor.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.cameras import Camera as JCamera
from orb_slam3_modified_tpu.cameras import project as jproject
from orb_slam3_modified_tpu.features.extractor import ExtractorConfig as JExtractorConfig
from orb_slam3_modified_tpu.lie.se3 import SE3 as JSE3
from orb_slam3_modified_tpu.ops import stereo_match as jsm
from orb_slam3_modified_tpu.utils.synthetic import orbit_trajectory as j_orbit_trajectory
from orb_slam3_modified_tpu.utils.synthetic_features import SyntheticFeatureWorld
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.ops import stereo_match as tsm

torch.set_num_threads(2)
JCAM = JCamera.pinhole(458.654, 457.296, 367.215, 248.375, width=752, height=480)
TCAM = convert.camera(JCAM, device="cpu")
BF = 458.654 * 0.11  # tests/test_stereo.py
POSE_TOL = 1e-4
STEP_TOL = 1e-5
CHUNK_POSE_TOL = 1e-3


def _t(a, dtype=None):
    return torch.from_numpy(np.ascontiguousarray(a if dtype is None else np.asarray(a, dtype)))


def _desc(d):
    return _t(np.asarray(d, np.uint32).view(np.int32))


def _both_match(uv_l, desc_l, lvl_l, v_l, uv_r, desc_r, lvl_r, v_r, bf, min_z):
    j = jsm.match_stereo(*(jnp.asarray(x) for x in (uv_l, desc_l, lvl_l, v_l, uv_r, desc_r,
                                                      lvl_r, v_r)), bf=bf, min_z=min_z)
    t = tsm.match_stereo(_t(uv_l), _desc(desc_l), _t(lvl_l), _t(v_l), _t(uv_r), _desc(desc_r),
                         _t(lvl_r), _t(v_r), bf, min_z)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def _rectified_case():
    """TestStereoMatch.test_rectified_pairs' inputs."""
    rng = np.random.default_rng(0)
    n = 100
    uv_l = rng.uniform(100, 600, (n, 2)).astype(np.float32)
    depth = rng.uniform(1.0, 20.0, n).astype(np.float32)
    uv_r = uv_l.copy()
    uv_r[:, 0] -= BF / depth
    desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    lvl = np.zeros(n, np.int32)
    v = np.ones(n, bool)
    return (uv_l, desc, lvl, v, uv_r, desc, lvl, v), depth


def _random_pair(n=1024, seed=1):
    """A seeded (1024, 1024) pair: right keypoints shifted by a disparity on
    the same rows (jittered), half the descriptors noisy copies, levels 0-7,
    some invalid."""
    rng = np.random.default_rng(seed)
    uv_l = np.stack([rng.uniform(0, 752, n), rng.uniform(0, 480, n)], -1).astype(np.float32)
    lvl_l = rng.integers(0, 8, n).astype(np.int32)
    perm = rng.permutation(n)
    uv_r = uv_l[perm].copy()
    uv_r[:, 0] -= rng.uniform(-5, 90, n).astype(np.float32)
    uv_r[:, 1] += rng.normal(0, 1.0, n).astype(np.float32)
    lvl_r = np.clip(lvl_l[perm] + rng.integers(-1, 2, n), 0, 7).astype(np.int32)
    desc_l = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    flips = rng.integers(0, 2**32, (n, 8), dtype=np.uint32) & rng.integers(0, 2**32, (n, 8),
                                                                          dtype=np.uint32)
    desc_r = np.where(rng.uniform(size=(n, 1)) < 0.5, desc_l[perm] ^ (flips & flips >> 3),
                      rng.integers(0, 2**32, (n, 8), dtype=np.uint32)).astype(np.uint32)
    v_l = rng.uniform(size=n) < 0.95
    v_r = rng.uniform(size=n) < 0.95
    return uv_l, desc_l, lvl_l, v_l, uv_r, desc_r, lvl_r, v_r


@pytest.mark.parametrize("case", ["rectified_pairs", "random_1024"])
def test_match_stereo_is_exact(case):
    if case == "rectified_pairs":
        args, depth = _rectified_case()
    else:
        args, depth = _random_pair(), None
    (ju, jd, jok), (tu, td, tok) = _both_match(*args, bf=BF, min_z=0.3)
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_array_equal(tu, ju)
    np.testing.assert_array_equal(td, jd)
    if depth is not None:  # the reference test's own gates, on the port
        assert tok.mean() > 0.9
        assert np.median(np.abs(td[tok] - depth[tok]) / depth[tok]) < 0.01
    else:
        assert 50 < tok.sum() < 1000  # the masks and TH_HIGH both bite


def test_refine_disparity_sad_matches_reference():
    """TestSubpixelRefinement.test_sad_parabola's inputs, within 1e-4 px."""
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, (60, 90)).astype(np.float32)
    img_l = np.asarray(jax.image.resize(jnp.asarray(base), (480, 720), "cubic"))
    img_r = np.roll(img_l, -13, axis=1)
    n = 50
    uv_l = np.stack([rng.uniform(60, 650, n), rng.uniform(60, 420, n)], axis=1).astype(np.float32)
    u_r = (uv_l[:, 0] - 13.0 + rng.integers(-2, 3, n)).astype(np.float32)
    matched = np.arange(n) % 7 != 0
    j = np.asarray(jsm.refine_disparity_sad(jnp.asarray(img_l), jnp.asarray(img_r),
                                            jnp.asarray(uv_l), jnp.asarray(u_r),
                                            jnp.asarray(matched)))
    t = tsm.refine_disparity_sad(_t(img_l), _t(img_r), _t(uv_l), _t(u_r), _t(matched)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-4)
    err = np.abs(t - (uv_l[:, 0] - 13.0))[matched]
    assert np.median(err) < 0.6


def test_match_stereo_general_kb8_matches_reference():
    """TestFisheyeStereoMatch.test_kb8_pair_depth. The triangulation takes the
    eigenvector of a 4x4 A^T A, which squares an ill-conditioned system (a
    10 cm baseline at 1.5-4.5 m): in float32 the two packages' eigensolvers
    land up to ~1e-3 m apart, so depth parity (1e-4 m) is held in float64 on
    both sides, as the PnP DLT's in test_torch_reloc.py; in float32 the
    valid masks are equal and the port meets the reference test's gates."""
    jcam = JCamera.kb8(190.978, 190.973, 254.931, 256.897, 0.00348, 0.000715, -0.00205,
                       0.000202, width=512, height=512)
    tcam = convert.camera(jcam, device="cpu")
    rng = np.random.default_rng(5)
    n = 150
    pts_l = rng.uniform([-2, -2, 1.5], [2, 2, 4.5], (n, 3)).astype(np.float32)
    R_rl = np.eye(3, dtype=np.float32)
    t_rl = np.array([-0.101, 0.0, 0.0], np.float32)
    uv_l = np.asarray(jproject(jcam, jnp.asarray(pts_l))).astype(np.float32)
    uv_r = np.asarray(jproject(jcam, jnp.asarray(pts_l @ R_rl.T + t_rl))).astype(np.float32)
    ok_gt = ((uv_l > 5) & (uv_l < 507)).all(axis=1) & ((uv_r > 5) & (uv_r < 507)).all(axis=1)
    desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    lvl = np.zeros(n, np.int32)

    def both(dt):
        with jax.enable_x64(dt == np.float64):
            j = jsm.match_stereo_general(
                jnp.asarray(uv_l, dt), jnp.asarray(desc), jnp.asarray(lvl), jnp.asarray(ok_gt),
                jnp.asarray(uv_r, dt), jnp.asarray(desc), jnp.asarray(lvl), jnp.asarray(ok_gt),
                jcam, jcam, jnp.asarray(R_rl, dt), jnp.asarray(t_rl, dt))
            j = [np.asarray(x) for x in j]
        t = tsm.match_stereo_general(_t(uv_l, dt), _desc(desc), _t(lvl), _t(ok_gt), _t(uv_r, dt),
                                     _desc(desc), _t(lvl), _t(ok_gt), tcam, tcam, _t(R_rl, dt),
                                     _t(t_rl, dt))
        return j, [x.numpy() for x in t]

    (jd, jok), (td, tok) = both(np.float64)
    np.testing.assert_array_equal(tok, jok)
    np.testing.assert_allclose(td, jd, atol=1e-4)
    (_, jok), (td, tok) = both(np.float32)
    np.testing.assert_array_equal(tok, jok)
    assert tok[ok_gt].mean() > 0.8
    assert np.median(np.abs(td[tok] - pts_l[tok, 2]) / pts_l[tok, 2]) < 0.02


def _stereo_ba_problem():
    """TestStereoBA.test_stereo_ba_fixes_scale's problem (numpy fields)."""
    rng = np.random.default_rng(3)
    n_pts, n_cams = 300, 4
    pts = rng.uniform([-4, -4, 5], [4, 4, 15], (n_pts, 3)).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (n_cams, 1, 1))
    t = np.zeros((n_cams, 3), np.float32)
    t[:, 0] = -np.arange(n_cams) * 0.4
    obs_cam, obs_pt, obs_uv, obs_ur = [], [], [], []
    for k in range(n_cams):
        pc = pts @ R[k].T + t[k]
        uv = np.asarray(jproject(JCAM, jnp.asarray(pc)))
        ok = ((pc[:, 2] > 0.5) & (uv[:, 0] > 0) & (uv[:, 0] < 752) & (uv[:, 1] > 0)
              & (uv[:, 1] < 480))
        idx = np.flatnonzero(ok)
        obs_cam.append(np.full(len(idx), k, np.int32))
        obs_pt.append(idx.astype(np.int32))
        obs_uv.append(uv[idx] + rng.normal(0, 0.3, (len(idx), 2)))
        obs_ur.append(uv[idx, 0] - BF / pc[idx, 2] + rng.normal(0, 0.3, len(idx)))
    n_obs = sum(len(o) for o in obs_cam)
    return dict(R=R, t=t * 1.25, cam_fixed=np.array([True] + [False] * (n_cams - 1)),
                points=pts * 1.25, pt_valid=np.ones(n_pts, bool),
                obs_cam=np.concatenate(obs_cam), obs_pt=np.concatenate(obs_pt),
                obs_uv=np.concatenate(obs_uv).astype(np.float32),
                obs_inv_s2=np.ones(n_obs, np.float32), obs_valid=np.ones(n_obs, bool),
                obs_ur=np.concatenate(obs_ur).astype(np.float32), bf=np.float32(BF)), (t, 3, 8)


def _mono_ba_problem():
    """TestStereoBA.test_mono_problem_unchanged's problem (obs_ur None)."""
    rng = np.random.default_rng(4)
    pts = rng.uniform([-3, -3, 4], [3, 3, 10], (100, 3)).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (2, 1, 1))
    t = np.array([[0, 0, 0], [-0.5, 0, 0]], np.float32)
    uv = [np.asarray(jproject(JCAM, jnp.asarray(pts @ R[k].T + t[k]))) for k in range(2)]
    return dict(R=R, t=t, cam_fixed=np.array([True, False]),
                points=(pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32),
                pt_valid=np.ones(100, bool), obs_cam=np.repeat(np.arange(2, dtype=np.int32), 100),
                obs_pt=np.tile(np.arange(100, dtype=np.int32), 2),
                obs_uv=np.concatenate(uv).astype(np.float32), obs_inv_s2=np.ones(200, np.float32),
                obs_valid=np.ones(200, bool), obs_ur=None, bf=None), (pts, 2, 5)


@pytest.mark.parametrize("case", ["stereo_fixes_scale", "mono_unchanged"])
def test_stereo_ba_matches_reference(case):
    from orb_slam3_modified_tpu.optim.ba import BAProblem as JBAProblem
    from orb_slam3_modified_tpu.optim.ba import bundle_adjust as j_bundle_adjust
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3np
    from orb_slam3_modified_tpu_torch.optim.ba import BAProblem, bundle_adjust, to_device

    p, (truth, rounds, iters) = _stereo_ba_problem() if case == "stereo_fixes_scale" \
        else _mono_ba_problem()
    fields = {k: v for k, v in p.items() if k not in ("R", "t")}
    jres = j_bundle_adjust(
        JBAProblem(T_cw=JSE3(jnp.asarray(p["R"]), jnp.asarray(p["t"])),
                   **{k: None if v is None else jnp.asarray(v) for k, v in fields.items()}),
        JCAM, rounds, iters)
    tres = bundle_adjust(to_device(BAProblem(T_cw=SE3np(p["R"], p["t"]), **fields), "cpu"), TCAM,
                         rounds, iters)
    np.testing.assert_array_equal(tres.obs_inlier.numpy(), np.asarray(jres.obs_inlier))
    # relative: the CPU GEMMs round with the buffers' alignment, so one run
    # of the port differs from another by ~1e-5 of a point 13 m away
    for a, b in ((tres.T_cw.R, jres.T_cw.R), (tres.T_cw.t, jres.T_cw.t),
                 (tres.points, jres.points)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=POSE_TOL, rtol=POSE_TOL)
    if case == "stereo_fixes_scale":  # the reference test's gates, on the port
        t_out = tres.T_cw.t.numpy()
        base_gt = np.linalg.norm(truth[1] - truth[0])
        assert abs(np.linalg.norm(t_out[1] - t_out[0]) - base_gt) / base_gt < 0.05
        assert tres.obs_inlier.numpy().mean() > 0.8
    else:
        assert np.abs(tres.points.numpy() - truth).max() < 0.02


# ---- the tracker with depth: tests/test_stereo.py's stereo_seq


def _track_seq(tracker, mapper, feats_all, depths):
    kf_frames = []

    def on_keyframe(k):
        kf_frames.append(int(tracker.map.kf_frame_id[k]))
        mapper.on_keyframe(k)

    tracker.on_keyframe = on_keyframe
    out = []
    for i, (f, d) in enumerate(zip(feats_all, depths)):
        T = tracker.track(f, ts=i * 0.05, depth=d)
        out.append(None if T is None else np.asarray(T))
    return out, kf_frames


@pytest.fixture(scope="module")
def stereo_seq_runs():
    """30 frames of an orbit with ideal per-feature depth (first-frame
    init), through both packages' Tracker + LocalMapper."""
    from orb_slam3_modified_tpu.mapping.local_mapper import LocalMapper as JLocalMapper
    from orb_slam3_modified_tpu.mapping.local_mapper import LocalMapperConfig as JLMConfig
    from orb_slam3_modified_tpu.slam_map.map_state import MapState as JMapState
    from orb_slam3_modified_tpu.tracking.tracker import Tracker as JTracker
    from orb_slam3_modified_tpu.tracking.tracker import TrackerConfig as JTrackerConfig
    from orb_slam3_modified_tpu_torch.mapping.local_mapper import LocalMapper, LocalMapperConfig
    from orb_slam3_modified_tpu_torch.slam_map.map_state import MapState
    from orb_slam3_modified_tpu_torch.tracking.tracker import Tracker, TrackerConfig

    n_frames = 30
    world = SyntheticFeatureWorld(n_points=4000, spread=5.0, seed=3, feat_cap=768, noise_px=0.4)
    T_all = j_orbit_trajectory(n_frames, radius=4.0, sweep=np.pi / 4)
    feats_all, depths, gt = [], [], []
    for i in range(n_frames):
        T_cw = JSE3(T_all.R[i], T_all.t[i])
        f, ids = world.observe(JCAM, T_cw, max_feats=600)
        pc = np.asarray(T_cw.apply(jnp.asarray(world.points[ids])))
        d = np.full(f.capacity, -1.0, np.float32)
        d[: len(ids)] = pc[:, 2]
        feats_all.append(convert.host_features(f))
        depths.append(d)
        gt.append(np.asarray(T_cw.inverse().t))
    jmap = JMapState.create(max_kf=128, max_mp=32768, feat_cap=768)
    jcfg = JTrackerConfig(cam=JCAM)
    jt = JTracker(jcfg, jmap)
    j = _track_seq(jt, JLocalMapper(JLMConfig(), jcfg, jmap), feats_all, depths)
    tmap = MapState.create(max_kf=128, max_mp=32768, feat_cap=768)
    tcfg = TrackerConfig(cam=TCAM)
    tt = Tracker(tcfg, tmap, device="cpu")
    t = _track_seq(tt, LocalMapper(LocalMapperConfig(), tcfg, tmap, device="cpu"), feats_all,
                   depths)
    # one more look at frame 28 (new noise), for the odometry on depth points
    f_vo, _ = world.observe(JCAM, JSE3(T_all.R[28], T_all.t[28]), max_feats=600)
    return j, t, tt, tmap, jt, jmap, np.array(gt), f_vo


def test_tracker_with_depth_matches_reference(stereo_seq_runs):
    """The same keyframes (created, in order), every pose within 1e-4, the
    map's points within 1e-4, and tests/test_stereo.py's gates on the port
    (>= 29 frames tracked from the first, metric: scale-aligned ATE < 0.02 m
    with |s - 1| < 0.02, OK at the end). Then Tracker._track_vo
    (localization mode's frame-to-frame odometry on the last frame's depth
    points, no map) from the end of the run against a new look at frame 28,
    in both packages: the same verdict, the pose within POSE_TOL. (One test:
    the fixture runs once per worker that draws a test of it.)"""
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3np

    from orb_slam3_modified_tpu_torch.eval.ate import ate_rmse
    from orb_slam3_modified_tpu_torch.tracking.tracker import OK

    (j_est, j_kf), (t_est, t_kf), tt, tmap, jt, jmap, gt, f_vo = stereo_seq_runs
    assert t_kf == j_kf
    assert [T is None for T in t_est] == [T is None for T in j_est]
    # relative too: the mapper's BA runs on CPU GEMMs that round with the
    # buffers' alignment (see test_stereo_ba_matches_reference)
    for a, b in zip(t_est, j_est):
        if a is not None:
            np.testing.assert_allclose(a, b, atol=POSE_TOL, rtol=POSE_TOL)
    np.testing.assert_array_equal(tmap.mp_valid, jmap.mp_valid)
    np.testing.assert_allclose(tmap.mp_pos[tmap.mp_valid], jmap.mp_pos[jmap.mp_valid],
                               atol=POSE_TOL, rtol=POSE_TOL)
    # the last frame's record carries its depth, as the reference's
    rec = convert.frame_record(jt.last)
    assert rec.frame_id == tt.last.frame_id and rec.ur is None and tt.last.ur is None
    np.testing.assert_array_equal(rec.depth, tt.last.depth)
    np.testing.assert_array_equal(rec.obs_mp, tt.last.obs_mp)
    np.testing.assert_allclose(rec.T_cw.t, tt.last.T_cw.t, atol=POSE_TOL)
    tracked = [i for i, T in enumerate(t_est) if T is not None]
    assert len(tracked) >= 29 and tracked[0] == 0
    pos = np.array([np.linalg.inv(t_est[i])[:3, 3] for i in tracked])
    rmse, s = ate_rmse(pos, gt[tracked])
    assert rmse < 0.02 and abs(s - 1.0) < 0.02, (rmse, s)
    assert tt.state == OK
    j_T, j_ok = jt._track_vo(f_vo, jt.last.T_cw)
    t_T, t_ok = tt._track_vo(convert.host_features(f_vo),
                             SE3np(tt.last.T_cw.R.copy(), tt.last.T_cw.t.copy()))
    assert bool(j_ok) and t_ok
    np.testing.assert_allclose(t_T.R, np.asarray(j_T.R), atol=POSE_TOL)
    np.testing.assert_allclose(t_T.t, np.asarray(j_T.t), atol=POSE_TOL)


# ---- the stereo chunk step: make_chunk_step_stereo


W, H, K = 320, 240, 4


@pytest.fixture(scope="module")
def stereo_chunk_results():
    """A rendered 320x240 rectified pair per frame (baseline 0.11 m), 4
    levels, 256 features, a 1024-point cache seeded from ground truth,
    K = 4, through both packages' stereo chunk steps; and the port's match
    and track fed the reference's own features."""
    from orb_slam3_modified_tpu.features.extractor import extract_batch as j_extract_batch
    from orb_slam3_modified_tpu.tracking import fused as jfused
    from orb_slam3_modified_tpu.tracking.chunked import make_chunk_step_stereo as j_make
    from orb_slam3_modified_tpu_torch.features.extractor import Features, ORBExtractor
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3
    from orb_slam3_modified_tpu_torch.tracking.chunked import make_chunk_step_stereo
    from orb_slam3_modified_tpu_torch.tracking.fused import DeviceTrackState
    from orb_slam3_modified_tpu_torch.tracking.tracker import inv_level_sigma2
    from orb_slam3_modified_tpu_torch.utils.synthetic import orbit_trajectory
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import (
        make_texture, render_stereo_sequence, seed_map_cache,
    )

    k = W / 752
    jcam = JCamera.pinhole(458.654 * k, 457.296 * k, 367.215 * k, 248.375 * k, width=W, height=H)
    cam = convert.camera(jcam, device="cpu")
    bf = 0.11 * 458.654 * k
    jcfg = JExtractorConfig(n_features=256, n_levels=4)
    cfg = convert.extractor_config(jcfg)
    T_all = orbit_trajectory(400, radius=4.0, sweep=np.pi / 2)
    T_seq = SE3(T_all.R[:30], T_all.t[:30])
    left, right = render_stereo_sequence(cam, T_seq, make_texture(0, 96, 1024), 0.11)
    kf = [0, 8, 16, 24]
    kf_feats = ORBExtractor(cfg, H, W, device="cpu")(torch.from_numpy(left[kf]))
    cache = seed_map_cache(cam, kf_feats, SE3(T_seq.R[kf], T_seq.t[kf]), 2.0, 1024)
    s0 = 2
    state = DeviceTrackState(R=T_seq.R[s0 - 1], t=T_seq.t[s0 - 1], R_prev=T_seq.R[s0 - 2],
                             t_prev=T_seq.t[s0 - 2], ok=torch.tensor(True))
    imgs_l, imgs_r = left[s0 : s0 + K], right[s0 : s0 + K]
    inv_s2 = inv_level_sigma2(jcfg.n_levels, jcfg.scale)
    step = make_chunk_step_stereo(cam, inv_s2, cfg, bf, 0.3, device="cpu")
    _, touts, tfeats, turs, tdepths = step(state, cache, torch.from_numpy(imgs_l),
                                           torch.from_numpy(imgs_r))
    jcache = jfused.MapCache(jnp.asarray(cache.pos.numpy()),
                             jnp.asarray(convert.desc_to_uint32(cache.desc)),
                             jnp.asarray(cache.valid.numpy()), jnp.asarray(cache.mp_id.numpy()))
    jstate = jfused.DeviceTrackState(*(jnp.asarray(x.numpy()) for x in state))
    _, jouts, _, jurs, jdepths = j_make(jcam, inv_s2, jcfg, bf, 0.3)(
        jstate, jcache, jnp.asarray(imgs_l), jnp.asarray(imgs_r))
    # the reference's own features (its chunk step's one 2K-image batch)
    jb = j_extract_batch(jnp.asarray(np.concatenate([imgs_l, imgs_r]), jnp.float32), jcfg)
    tb = convert.features(jb, device="cpu")
    fl, fr = Features(*(x[:K] for x in tb)), Features(*(x[K:] for x in tb))
    surs, sdepths = step.match(fl, fr)
    souts = _steps_from_reference_states(step, state, cache, fl, surs, jouts)
    return dict(touts=touts, jouts=jouts, turs=turs, tdepths=tdepths, jurs=jurs, jdepths=jdepths,
                surs=surs, sdepths=sdepths, souts=souts, t_gt=T_seq.t[s0 : s0 + K].numpy())


def _steps_from_reference_states(step, state, cache, feats, urs, jouts):
    """The port's fused step on each frame k of the chunk from the
    reference's own state after frame k - 1 (its pose, and the one before
    as the constant-velocity history; the scene never takes the recovery
    pass, which would reset that history), so a frame's float32 rounding
    does not carry into the next: (n_inliers, R, t) stacked over K."""
    from orb_slam3_modified_tpu_torch.tracking.fused import DeviceTrackState

    assert (np.asarray(jouts.n_inliers) >= 25).all()  # no recovery pass
    Rs = [state.R_prev, state.R] + [torch.from_numpy(np.asarray(r)) for r in jouts.R]
    ts = [state.t_prev, state.t] + [torch.from_numpy(np.asarray(t)) for t in jouts.t]
    outs = []
    for k in range(feats.uv.shape[0]):
        st = DeviceTrackState(R=Rs[k + 1], t=ts[k + 1], R_prev=Rs[k], t_prev=ts[k], ok=state.ok)
        outs.append(step.step(st, cache, feats.uv[k], feats.desc[k], feats.level[k],
                              feats.valid[k], urs[k])[1])
    return type(outs[0])(*(torch.stack(f) for f in zip(*outs)))


def test_stereo_chunk_step_matches_reference(stereo_chunk_results):
    """Given the reference's features: ur and depth of every frame within
    STEP_TOL, and each frame's step from the reference's state (inliers
    equal, pose within STEP_TOL). End to end (each package extracts its
    own): poses within CHUNK_POSE_TOL, every frame >= 20 inliers and within
    0.05 m of the truth, most features matched with a positive depth."""
    r = stereo_chunk_results
    np.testing.assert_allclose(r["surs"].numpy(), np.asarray(r["jurs"]), atol=STEP_TOL)
    np.testing.assert_allclose(r["sdepths"].numpy(), np.asarray(r["jdepths"]), atol=STEP_TOL)
    np.testing.assert_array_equal(r["souts"].n_inliers.numpy(), np.asarray(r["jouts"].n_inliers))
    np.testing.assert_allclose(r["souts"].R.numpy(), np.asarray(r["jouts"].R), atol=STEP_TOL)
    np.testing.assert_allclose(r["souts"].t.numpy(), np.asarray(r["jouts"].t), atol=STEP_TOL)
    np.testing.assert_allclose(r["touts"].R.numpy(), np.asarray(r["jouts"].R), atol=CHUNK_POSE_TOL)
    np.testing.assert_allclose(r["touts"].t.numpy(), np.asarray(r["jouts"].t), atol=CHUNK_POSE_TOL)
    assert (r["touts"].n_inliers.numpy() >= 20).all()
    assert np.linalg.norm(r["touts"].t.numpy() - r["t_gt"], axis=-1).max() < 0.05
    ok = r["turs"].numpy() >= 0
    assert ok.sum(axis=1).min() > 50  # most frames' features found their right match
    assert (r["tdepths"].numpy()[ok] > 0).all()


# ---- the slice as a whole: SlamSystem(sensor=STEREO).make_chunked_frontend


N_SYSTEM_FRAMES = 26
MAP_MARGIN = 0.25  # keyframes and points against the reference's, as a share of its


@pytest.fixture(scope="module")
def stereo_system_runs(tmp_path_factory):
    """tests/test_chunked.py::chunked_stereo_run's scene (26 rendered 752x480
    pairs, baseline 0.11 m, 512 features over 4 levels, chunk 4, loop
    closing off) through both packages, each mapper in the tracker's thread
    (async_mapping=False: both runs deterministic)."""
    from orb_slam3_modified_tpu.io.datasets import EurocDataset
    from orb_slam3_modified_tpu.system.slam_system import STEREO as JSTEREO
    from orb_slam3_modified_tpu.system.slam_system import SlamSystem as JSlamSystem
    from orb_slam3_modified_tpu.system.slam_system import SystemConfig as JSystemConfig
    from orb_slam3_modified_tpu.utils.synthetic_dataset import write_euroc_sequence
    from orb_slam3_modified_tpu_torch.features.extractor import ExtractorConfig
    from orb_slam3_modified_tpu_torch.system.slam_system import STEREO, SlamSystem, SystemConfig

    root = str(tmp_path_factory.mktemp("euroc_synth_torch_stereo"))
    gts = write_euroc_sequence(root, JCAM, n_frames=N_SYSTEM_FRAMES, radius=3.0,
                               stereo_baseline=0.11)
    pairs = [(f.image.astype(np.uint8), f.image_right.astype(np.uint8))
             for f in EurocDataset(root, stereo=True)]
    bf = 0.11 * float(JCAM.fx)
    jslam = JSlamSystem(JSystemConfig(cam=JCAM, sensor=JSTEREO, feat_cap=512, bf=bf,
                                      use_loop_closing=False,
                                      extractor=JExtractorConfig(n_features=512, n_levels=4)))
    tslam = SlamSystem(SystemConfig(cam=TCAM, sensor=STEREO, feat_cap=512, bf=bf,
                                    use_loop_closing=False, device="cpu",
                                    extractor=ExtractorConfig(n_features=512, n_levels=4)))
    tslam.tcfg.kf_tracked_ratio = 0.9  # the reference's, every sensor: like counts
    out = []
    for slam in (jslam, tslam):
        fe = slam.make_chunked_frontend(chunk=4, lag=1, async_mapping=False, stereo=True)
        retired = []
        for i, (img, img_r) in enumerate(pairs):
            retired += fe.track_image(img, i / 20.0, img_right=img_r)
        retired += fe.flush()
        slam.shutdown()
        out.append((retired, slam.tracker.absolute_trajectory(), slam.map))
    return out, gts


def test_stereo_system_meets_the_reference_gates_and_its_map(stereo_system_runs):
    """TestChunkedStereo's gates on the port (>= 20 of 26 frames tracked,
    scale-aligned ATE < 0.10 m with |s - 1| < 0.15: metric from the stereo
    rows, >= 2 keyframes, > 100 points), every frame retired in order as in
    the reference, and the keyframe and point counts within MAP_MARGIN of
    the reference's."""
    from orb_slam3_modified_tpu_torch.eval.ate import ate_rmse

    ((j_ret, _, jmap), (t_ret, t_traj, tmap)), gts = stereo_system_runs
    fids = [r[0] for r in t_ret]
    assert fids == list(range(N_SYSTEM_FRAMES)) and fids == [r[0] for r in j_ret]
    assert sum(r[2] is not None for r in t_ret) >= N_SYSTEM_FRAMES - 6
    est = np.array([np.linalg.inv(T)[:3, 3] for _, _, T in t_traj])
    gt = np.array([np.linalg.inv(gts[f])[:3, 3] for _, f, _ in t_traj])
    rmse, s = ate_rmse(est, gt)
    assert rmse < 0.10 and abs(s - 1.0) < 0.15, (rmse, s)
    assert tmap.n_keyframes() >= 2 and tmap.n_points() > 100
    for n_t, n_j in ((tmap.n_keyframes(), jmap.n_keyframes()), (tmap.n_points(), jmap.n_points())):
        assert abs(n_t - n_j) <= MAP_MARGIN * n_j, (n_t, n_j)


def test_track_stereo_entry_point_matches_reference():
    """SlamSystem.track_stereo, frame by frame, in both packages, on every
    6th frame of the headline orbit (4 frames) at 320x240 as rectified
    pairs (baseline 0.11 m), 256 features over 4 levels: the map starts at
    the first frame from its depth (pose I), every frame is tracked, and
    every pose is within CHUNK_POSE_TOL of the reference's (each package
    extracts its own features). At this size the disparities are 3-4 px and
    the stereo depths scatter by +-25%, so neither package's per-frame
    poses are metric here (both move about half as far as the camera): the
    chunked run above holds the port to metric gates."""
    from orb_slam3_modified_tpu.system.slam_system import STEREO as JSTEREO
    from orb_slam3_modified_tpu.system.slam_system import SlamSystem as JSlamSystem
    from orb_slam3_modified_tpu.system.slam_system import SystemConfig as JSystemConfig
    from orb_slam3_modified_tpu_torch.features.extractor import ExtractorConfig
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3
    from orb_slam3_modified_tpu_torch.system.slam_system import STEREO, SlamSystem, SystemConfig
    from orb_slam3_modified_tpu_torch.utils.synthetic import orbit_trajectory
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import (
        make_texture, render_stereo_sequence,
    )

    n, k = 4, W / 752
    jcam = JCamera.pinhole(458.654 * k, 457.296 * k, 367.215 * k, 248.375 * k, width=W, height=H)
    bf = 0.11 * 458.654 * k
    T_all = orbit_trajectory(400, radius=4.0, sweep=np.pi / 2)
    left, right = render_stereo_sequence(convert.camera(jcam, device="cpu"),
                                         SE3(T_all.R[::6][:n], T_all.t[::6][:n]),
                                         make_texture(0, 96, 1024), 0.11)
    jslam = JSlamSystem(JSystemConfig(cam=jcam, sensor=JSTEREO, feat_cap=256, bf=bf,
                                      use_loop_closing=False,
                                      extractor=JExtractorConfig(n_features=256, n_levels=4)))
    tslam = SlamSystem(SystemConfig(cam=convert.camera(jcam, device="cpu"), sensor=STEREO,
                                    feat_cap=256, bf=bf, use_loop_closing=False, device="cpu",
                                    extractor=ExtractorConfig(n_features=256, n_levels=4)))
    tslam.tcfg.kf_tracked_ratio = 0.9  # the reference's, every sensor
    for i in range(n):
        Tj = jslam.track_stereo(left[i].astype(np.float32), right[i].astype(np.float32), i / 20.0)
        Tt = tslam.track_stereo(left[i], right[i], i / 20.0)
        assert Tt is not None and Tj is not None
        np.testing.assert_allclose(Tt, Tj, atol=CHUNK_POSE_TOL)
        if i == 0:
            np.testing.assert_allclose(Tt, np.eye(4), atol=1e-6)
    assert tslam.map.n_points() > 100 and tslam.map.kf_ur[0].max() > 0


@pytest.mark.parametrize("scene", ["recovery", "healthy"])
def test_stereo_track_step_matches_reference(scene):
    """tracking/fused.py's step with bf > 0 and per-feature uR against JAX
    make_step_body: the recovery scene of tests/test_fused.py (a bogus
    40 deg / 1.5 m velocity, so the brute-force recovery pass runs, with
    stereo rows) and the same frame with the true velocity. Inliers and
    associations equal, poses within STEP_TOL."""
    from orb_slam3_modified_tpu.lie import se3 as jse3
    from orb_slam3_modified_tpu.tracking import fused as jfused
    from orb_slam3_modified_tpu.tracking.tracker import TrackerConfig as JTrackerConfig
    from orb_slam3_modified_tpu_torch.tracking.fused import make_step_body

    world = SyntheticFeatureWorld(n_points=3000, spread=5.0, seed=4, feat_cap=768, noise_px=0.3)
    T_all = j_orbit_trajectory(8, radius=4.0, sweep=np.pi / 8)
    T_last, T_cur = JSE3(T_all.R[5], T_all.t[5]), JSE3(T_all.R[6], T_all.t[6])
    if scene == "recovery":
        T_prev = jse3.exp(jnp.asarray(np.array([0.5, 0.3, -0.4, 0.7, 0.0, 0.2], np.float32))
                          ).inverse() @ T_last
    else:
        T_prev = JSE3(T_all.R[4], T_all.t[4])
    n, cap = len(world.points), jfused.CACHE_CAP
    cache = dict(pos=np.zeros((cap, 3), np.float32), desc=np.zeros((cap, 8), np.uint32),
                 valid=np.zeros(cap, bool), mp_id=np.full(cap, -1, np.int32))
    cache["pos"][:n], cache["desc"][:n] = world.points, world.desc
    cache["valid"][:n], cache["mp_id"][:n] = True, np.arange(n)
    feats, ids = world.observe(JCAM, T_cur, max_feats=600)
    z = np.asarray(T_cur.apply(jnp.asarray(world.points[ids])))[:, 2]
    ur = np.full(feats.capacity, -1.0, np.float32)
    ur[: len(ids)] = np.asarray(feats.uv)[: len(ids), 0] - BF / z
    ur[::3] = -1.0  # a third of the rows monocular
    state = [np.asarray(x, np.float32) for x in (T_last.R, T_last.t, T_prev.R, T_prev.t)]
    state.append(np.asarray(True))
    inv_s2 = JTrackerConfig(cam=JCAM).inv_level_sigma2()
    jstep = jax.jit(jfused.make_step_body(JCAM, inv_s2, feats.capacity, bf=BF))
    _, jout = jstep(jfused.DeviceTrackState(*(jnp.asarray(x) for x in state)),
                    jfused.MapCache(*(jnp.asarray(cache[k]) for k in ("pos", "desc", "valid",
                                                                      "mp_id"))),
                    feats.uv, feats.desc, feats.level, feats.valid, jnp.asarray(ur))
    tf = convert.features(feats, device="cpu")
    tst, tout = make_step_body(TCAM, inv_s2, feats.capacity, bf=BF, device="cpu")(
        convert.track_state(jfused.DeviceTrackState(*state), device="cpu"),
        convert.map_cache(jfused.MapCache(**cache), device="cpu"),
        tf.uv, tf.desc, tf.level, tf.valid, torch.from_numpy(ur))
    assert int(tout.n_inliers) == int(jout.n_inliers) >= 50
    np.testing.assert_array_equal(tout.obs_cache_idx.numpy(), np.asarray(jout.obs_cache_idx))
    np.testing.assert_allclose(tout.R.numpy(), np.asarray(jout.R), atol=STEP_TOL)
    np.testing.assert_allclose(tout.t.numpy(), np.asarray(jout.t), atol=STEP_TOL)
    assert np.linalg.norm(tout.t.numpy() - np.asarray(T_cur.t)) < 0.05
    # the recovery pass won (it resets the constant-velocity history) only there
    assert torch.equal(tst.R_prev, tst.R) == (scene == "recovery")
