"""Port parity for RGB-D: the depth lookup, the RGB-D chunk step and
SlamSystem's RGBD sensor, JAX vs torch on the same numpy inputs.

Tolerances: the depth lookup is exact (a gather and one product); the
chunk step given the same features 1e-5, each frame's step from the
reference's own state (as test_torch_chunk_step.py; chained, the frames'
float32 roundings add up), end to end 1e-3 (each package extracts its own
pyramid levels >= 1, test_torch_extractor.py). The system run is held to
tests/test_e2e_cli.py::test_rgbd_chunked's gates.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.cameras import Camera as JCamera
from orb_slam3_modified_tpu.features.extractor import ExtractorConfig as JExtractorConfig
from orb_slam3_modified_tpu.ops import stereo_match as jsm
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.ops import stereo_match as tsm

torch.set_num_threads(2)
STEP_TOL = 1e-5
CHUNK_POSE_TOL = 1e-3


@pytest.mark.parametrize("case", ["constant_map", "random"])
def test_depth_from_depthmap_is_exact(case):
    """TestStereoMatch.test_depth_map_sampling's case, and random keypoints
    (some off the image) on a random map with holes and a depth scale."""
    if case == "constant_map":
        dm = np.full((480, 752), 3.0, np.float32)
        uv = np.array([[100.5, 200.2], [10, 10]], np.float32)
        scale = 1.0
    else:
        rng = np.random.default_rng(0)
        dm = rng.uniform(0.0, 6000.0, (480, 752)).astype(np.float32)
        dm[rng.uniform(size=dm.shape) < 0.2] = 0.0
        uv = rng.uniform([-20, -20], [780, 500], (1024, 2)).astype(np.float32)
        scale = 1e-3
    j = np.asarray(jsm.depth_from_depthmap(jnp.asarray(uv), jnp.asarray(dm), scale))
    t = tsm.depth_from_depthmap(torch.from_numpy(uv), torch.from_numpy(dm), scale).numpy()
    np.testing.assert_array_equal(t, j)
    if case == "constant_map":
        np.testing.assert_allclose(t, [3.0, 3.0])  # the reference test's gate
    else:
        assert (t == -1.0).any() and (t > 0).any()


W, H, K = 320, 240, 4


@pytest.fixture(scope="module")
def rgbd_chunk_results():
    """A rendered 320x240 frame and metric depth map per frame, 4 levels,
    256 features, a 1024-point cache seeded from ground truth, K = 4,
    bf = 0.11 * fx, th_far 6 m (it drops the far half of the plane),
    through both packages' RGB-D chunk steps; and the port's lookup and
    track fed the reference's own features."""
    from orb_slam3_modified_tpu.features.extractor import extract_batch as j_extract_batch
    from orb_slam3_modified_tpu.tracking import fused as jfused
    from orb_slam3_modified_tpu.tracking.chunked import make_chunk_step_rgbd as j_make
    from orb_slam3_modified_tpu_torch.features.extractor import ORBExtractor
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3
    from orb_slam3_modified_tpu_torch.tracking.chunked import make_chunk_step_rgbd
    from orb_slam3_modified_tpu_torch.tracking.fused import DeviceTrackState
    from orb_slam3_modified_tpu_torch.tracking.tracker import inv_level_sigma2
    from orb_slam3_modified_tpu_torch.utils.synthetic import orbit_trajectory
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import (
        make_texture, render_rgbd_sequence, seed_map_cache,
    )

    k = W / 752
    jcam = JCamera.pinhole(458.654 * k, 457.296 * k, 367.215 * k, 248.375 * k, width=W, height=H)
    cam = convert.camera(jcam, device="cpu")
    bf, th_far = 0.11 * 458.654 * k, 6.0
    jcfg = JExtractorConfig(n_features=256, n_levels=4)
    cfg = convert.extractor_config(jcfg)
    T_all = orbit_trajectory(400, radius=4.0, sweep=np.pi / 2)
    T_seq = SE3(T_all.R[:30], T_all.t[:30])
    frames, depth = render_rgbd_sequence(cam, T_seq, make_texture(0, 96, 1024))
    kf = [0, 8, 16, 24]
    kf_feats = ORBExtractor(cfg, H, W, device="cpu")(torch.from_numpy(frames[kf]))
    cache = seed_map_cache(cam, kf_feats, SE3(T_seq.R[kf], T_seq.t[kf]), 2.0, 1024)
    s0 = 2
    state = DeviceTrackState(R=T_seq.R[s0 - 1], t=T_seq.t[s0 - 1], R_prev=T_seq.R[s0 - 2],
                             t_prev=T_seq.t[s0 - 2], ok=torch.tensor(True))
    imgs, dmaps = frames[s0 : s0 + K], depth[s0 : s0 + K]
    inv_s2 = inv_level_sigma2(jcfg.n_levels, jcfg.scale)
    step = make_chunk_step_rgbd(cam, inv_s2, cfg, bf, 1.0, th_far, device="cpu")
    _, touts, _, turs, tdepths = step(state, cache, torch.from_numpy(imgs),
                                      torch.from_numpy(dmaps))
    jcache = jfused.MapCache(jnp.asarray(cache.pos.numpy()),
                             jnp.asarray(convert.desc_to_uint32(cache.desc)),
                             jnp.asarray(cache.valid.numpy()), jnp.asarray(cache.mp_id.numpy()))
    jstate = jfused.DeviceTrackState(*(jnp.asarray(x.numpy()) for x in state))
    _, jouts, jfeats, jurs, jdepths = j_make(jcam, inv_s2, jcfg, bf, 1.0, th_far)(
        jstate, jcache, jnp.asarray(imgs), jnp.asarray(dmaps))
    # the reference's own features (the same extract_batch its step runs)
    feats = convert.features(j_extract_batch(jnp.asarray(imgs, jnp.float32), jcfg), device="cpu")
    surs, sdepths = step.lookup(feats, torch.from_numpy(dmaps))
    souts = _steps_from_reference_states(step, state, cache, feats, surs, jouts)
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


def test_rgbd_chunk_step_matches_reference(rgbd_chunk_results):
    """Given the reference's features: ur and depth of every frame within
    STEP_TOL, and each frame's step from the reference's state (inliers
    equal, pose within STEP_TOL). End to end (each package extracts its
    own): poses within CHUNK_POSE_TOL, every frame >= 20 inliers and within
    0.05 m of the truth; th_far dropped the far readings, and every uR rests
    on a depth."""
    r = rgbd_chunk_results
    np.testing.assert_allclose(r["surs"].numpy(), np.asarray(r["jurs"]), atol=STEP_TOL)
    np.testing.assert_allclose(r["sdepths"].numpy(), np.asarray(r["jdepths"]), atol=STEP_TOL)
    np.testing.assert_array_equal(r["souts"].n_inliers.numpy(), np.asarray(r["jouts"].n_inliers))
    np.testing.assert_allclose(r["souts"].R.numpy(), np.asarray(r["jouts"].R), atol=STEP_TOL)
    np.testing.assert_allclose(r["souts"].t.numpy(), np.asarray(r["jouts"].t), atol=STEP_TOL)
    np.testing.assert_allclose(r["touts"].R.numpy(), np.asarray(r["jouts"].R), atol=CHUNK_POSE_TOL)
    np.testing.assert_allclose(r["touts"].t.numpy(), np.asarray(r["jouts"].t), atol=CHUNK_POSE_TOL)
    assert (r["touts"].n_inliers.numpy() >= 20).all()
    assert np.linalg.norm(r["touts"].t.numpy() - r["t_gt"], axis=-1).max() < 0.05
    d, ur = r["tdepths"].numpy(), r["turs"].numpy()
    assert (d[ur >= 0] > 0).all() and (d <= 6.0).all()
    assert (d == -1.0).any() and (d > 0).mean() > 0.3


# ---- the slice as a whole: SlamSystem(sensor=RGBD).make_chunked_frontend


FPS = 20.0


@pytest.fixture(scope="module")
def rgbd_system_run():
    """tests/test_e2e_cli.py::test_rgbd_chunked's scene in memory, its first
    third: the first 32 of the 96 frames of write_euroc_sequence's orbit
    (radius 3 m, 60 deg over the 96, 20 frames/s) at 512x384, the depth
    quantized to millimetres as its uint16 PNGs hold it, 512 features over
    4 levels, bf = 0.11 * fx, chunk 8, the mapper in the tracker's thread
    (its --sync-mapping), loop closing off."""
    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.features.extractor import ExtractorConfig
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3
    from orb_slam3_modified_tpu_torch.system.slam_system import RGBD, SlamSystem, SystemConfig
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import (
        make_texture, orbit_state, render_rgbd_sequence,
    )

    n, n_scene = 32, 96
    cam = Camera.pinhole(330.0, 330.0, 256.0, 192.0, width=512, height=384, device="cpu")
    Rs, ts = [], []
    for i in range(n):
        R_cw, p, _, _ = orbit_state(i / FPS, n_scene / FPS, 3.0, np.pi / 3)
        Rs.append(R_cw)
        ts.append(-R_cw @ p)
    T_all = SE3(torch.from_numpy(np.stack(Rs).astype(np.float32)),
                torch.from_numpy(np.stack(ts).astype(np.float32)))
    frames, depth = render_rgbd_sequence(cam, T_all, make_texture(0, 96, 1024))
    depth = np.clip(depth * 1000.0, 0, 65535).astype(np.uint16).astype(np.float32) / 1000.0
    slam = SlamSystem(SystemConfig(cam=cam, sensor=RGBD, feat_cap=512, bf=0.11 * 330.0,
                                   use_loop_closing=False, device="cpu",
                                   extractor=ExtractorConfig(n_features=512, n_levels=4)))
    fe = slam.make_chunked_frontend(chunk=8, lag=1, async_mapping=False, rgbd=True)
    retired = []
    for i in range(n):
        retired += fe.track_image(frames[i], i / FPS, depth_img=depth[i])
    retired += fe.flush()
    slam.shutdown()
    return slam, retired, T_all, n


def test_rgbd_system_meets_the_reference_gates(rgbd_system_run):
    """test_rgbd_chunked's gates: 60 of its 96 frames tracked (here 20 of
    32), scale-aligned ATE < 0.08 m, |s - 1| < 0.15 (metric from depth);
    every frame retired in order; a map of keyframes and points."""
    from orb_slam3_modified_tpu_torch.eval.ate import ate_rmse

    slam, retired, T_all, n = rgbd_system_run
    assert [r[0] for r in retired] == list(range(n))
    traj = slam.tracker.absolute_trajectory()
    assert len(traj) >= n * 60 // 96
    R, t = T_all.R.numpy(), T_all.t.numpy()
    est = np.array([np.linalg.inv(T)[:3, 3] for _, _, T in traj])
    gt = np.array([-R[f].T @ t[f] for _, f, _ in traj])
    rmse, s = ate_rmse(est, gt)
    assert rmse < 0.08, f"chunked rgbd ATE {rmse:.3f} m"
    assert abs(s - 1.0) < 0.15, f"chunked rgbd scale off: {s:.3f}"
    assert slam.map.n_keyframes() >= 2 and slam.map.n_points() > 100


def test_track_rgbd_entry_point_is_metric():
    """SlamSystem.track_rgbd, frame by frame, on every 6th frame of the
    headline orbit (10 frames, 0.9 m of it) at 320x240 with their metric
    depth maps (bf = 0.11 * fx): the map starts at the first frame (pose I),
    every frame is tracked, and the camera centres relative to frame 0 are
    metric: scale-aligned ATE < 0.03 m with |s - 1| < 0.1."""
    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.eval.ate import ate_rmse
    from orb_slam3_modified_tpu_torch.features.extractor import ExtractorConfig
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3
    from orb_slam3_modified_tpu_torch.system.slam_system import RGBD, SlamSystem, SystemConfig
    from orb_slam3_modified_tpu_torch.utils.synthetic import orbit_trajectory
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import (
        make_texture, render_rgbd_sequence,
    )

    n, k = 10, W / 752
    cam = Camera.pinhole(458.654 * k, 457.296 * k, 367.215 * k, 248.375 * k, width=W, height=H,
                         device="cpu")
    T_all = orbit_trajectory(400, radius=4.0, sweep=np.pi / 2)
    T_seq = SE3(T_all.R[::6][:n], T_all.t[::6][:n])
    frames, depth = render_rgbd_sequence(cam, T_seq, make_texture(0, 96, 1024))
    slam = SlamSystem(SystemConfig(cam=cam, sensor=RGBD, feat_cap=256, bf=0.11 * 458.654 * k,
                                   use_loop_closing=False, device="cpu",
                                   extractor=ExtractorConfig(n_features=256, n_levels=4)))
    Ts = [slam.track_rgbd(frames[i], depth[i], i / 20.0) for i in range(n)]
    assert all(T is not None for T in Ts)
    np.testing.assert_allclose(Ts[0], np.eye(4), atol=1e-6)
    assert slam.map.n_points() > 100 and slam.map.kf_ur[0].max() > 0
    T_gt = np.tile(np.eye(4), (n, 1, 1))
    T_gt[:, :3, :3], T_gt[:, :3, 3] = T_seq.R.numpy(), T_seq.t.numpy()
    est = np.array([np.linalg.inv(T)[:3, 3] for T in Ts])
    gt = np.array([np.linalg.inv(Tg @ np.linalg.inv(T_gt[0]))[:3, 3] for Tg in T_gt])
    rmse, s = ate_rmse(est, gt)
    assert rmse < 0.03 and abs(s - 1.0) < 0.1, (rmse, s)
