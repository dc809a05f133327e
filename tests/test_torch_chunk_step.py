"""Port parity for the slice as a whole: the fused track step and the
monocular chunk step, JAX vs torch.

1. make_step_body fed the same features (the recovery scene of
   tests/test_fused.py and a healthy frame): n_inliers and obs_cache_idx
   equal, pose within 1e-5 (float32 sums in the pose solve, as in
   test_torch_pose_opt.py).
2. make_chunk_step on the same rendered uint8 chunk (320x240, 4 levels, 256
   features, a 1024-point cache seeded from ground truth, K=4): per-frame
   rotation and translation within CHUNK_POSE_TOL, ok equal, inlier counts
   within CHUNK_INLIER_MARGIN. These are looser than the step's gates because
   each package extracts its own features: levels >= 1 come from a float32
   pyramid that rounds differently (test_torch_extractor.py), so a coarse
   keypoint or a near-tie descriptor bit can differ, and with it a match.
"""
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.cameras import Camera as JCamera
from orb_slam3_modified_tpu.features.extractor import ExtractorConfig as JExtractorConfig
from orb_slam3_modified_tpu.lie import se3 as jse3
from orb_slam3_modified_tpu.lie.se3 import SE3 as JSE3
from orb_slam3_modified_tpu.tracking import fused as jfused
from orb_slam3_modified_tpu.tracking.chunked import make_chunk_step as j_make_chunk_step
from orb_slam3_modified_tpu.tracking.tracker import TrackerConfig
from orb_slam3_modified_tpu.utils.synthetic import orbit_trajectory as j_orbit_trajectory
from orb_slam3_modified_tpu.utils.synthetic_features import SyntheticFeatureWorld
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.cameras import Camera
from orb_slam3_modified_tpu_torch.features.extractor import ORBExtractor
from orb_slam3_modified_tpu_torch.lie.se3 import SE3
from orb_slam3_modified_tpu_torch.tracking import fused as tfused
from orb_slam3_modified_tpu_torch.tracking.chunked import make_chunk_step
from orb_slam3_modified_tpu_torch.tracking.fused import DeviceTrackState, make_step_body
from orb_slam3_modified_tpu_torch.tracking.tracker import inv_level_sigma2
from orb_slam3_modified_tpu_torch.utils.synthetic import orbit_trajectory
from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import (
    make_texture,
    render_sequence,
    seed_map_cache,
)

torch.set_num_threads(2)
STEP_POSE_TOL = 1e-5
CHUNK_POSE_TOL = 1e-3
CHUNK_INLIER_MARGIN = 0.03  # share of the reference's inliers; measured 0

JCAM = JCamera.pinhole(458.654, 457.296, 367.215, 248.375, width=752, height=480)


def _np_state(R, t, R_prev, t_prev):
    return [np.asarray(x, np.float32) for x in (R, t, R_prev, t_prev)] + [np.asarray(True)]


@pytest.fixture(scope="module")
def step_scenes():
    """The recovery scene of tests/test_fused.py (a bogus 40 deg / 1.5 m
    velocity) and the same frame with the true velocity."""
    world = SyntheticFeatureWorld(n_points=3000, spread=5.0, seed=4, feat_cap=768, noise_px=0.3)
    T_all = j_orbit_trajectory(8, radius=4.0, sweep=np.pi / 8)
    T_prev2 = JSE3(T_all.R[4], T_all.t[4])
    T_last = JSE3(T_all.R[5], T_all.t[5])
    T_cur = JSE3(T_all.R[6], T_all.t[6])
    T_bad_vel = jse3.exp(jnp.asarray(np.array([0.5, 0.3, -0.4, 0.7, 0.0, 0.2], np.float32)))
    T_bad_prev = T_bad_vel.inverse() @ T_last
    n = len(world.points)
    cap = jfused.CACHE_CAP
    cache = dict(pos=np.zeros((cap, 3), np.float32), desc=np.zeros((cap, 8), np.uint32),
                 valid=np.zeros(cap, bool), mp_id=np.full(cap, -1, np.int32))
    cache["pos"][:n] = world.points
    cache["desc"][:n] = world.desc
    cache["valid"][:n] = True
    cache["mp_id"][:n] = np.arange(n)
    feats, _ = world.observe(JCAM, T_cur, max_feats=600)
    return {
        "recovery": (_np_state(T_last.R, T_last.t, T_bad_prev.R, T_bad_prev.t), T_cur),
        "healthy": (_np_state(T_last.R, T_last.t, T_prev2.R, T_prev2.t), T_cur),
    }, cache, feats


@pytest.fixture(scope="module")
def step_results(step_scenes):
    scenes, cache, feats = step_scenes
    inv_s2 = TrackerConfig(cam=JCAM).inv_level_sigma2()
    jstep = jfused.make_track_step(JCAM, inv_s2, feats.capacity)
    cam = convert.camera(JCAM, device="cpu")
    step = make_step_body(cam, inv_s2, feats.capacity, device="cpu")
    jcache = jfused.MapCache(*(jnp.asarray(cache[k]) for k in ("pos", "desc", "valid", "mp_id")))
    tcache = convert.map_cache(jfused.MapCache(**cache), device="cpu")
    tf = convert.features(feats, device="cpu")
    out = {}
    for name, (state, T_cur) in scenes.items():
        jst, jout = jstep(jfused.DeviceTrackState(*(jnp.asarray(x) for x in state)), jcache,
                          feats.uv, feats.desc, feats.level, feats.valid)
        tstate = convert.track_state(jfused.DeviceTrackState(*state), device="cpu")
        # "sync": the step as it runs (host read of the recovery gate);
        # "select": the branch-free form it takes under CUDA graph capture
        touts = {"sync": step(tstate, tcache, tf.uv, tf.desc, tf.level, tf.valid)}
        with mock.patch.object(tfused, "_branch_free", lambda t: True):
            touts["select"] = step(tstate, tcache, tf.uv, tf.desc, tf.level, tf.valid)
        out[name] = (jst, jout, touts, T_cur)
    return out


@pytest.mark.parametrize("scene", ["recovery", "healthy"])
def test_step_parity_same_features(step_results, scene):
    jst, jout, touts, _ = step_results[scene]
    tst, tout = touts["sync"]
    assert int(tout.n_inliers) == int(jout.n_inliers)
    np.testing.assert_array_equal(tout.obs_cache_idx.numpy(), np.asarray(jout.obs_cache_idx))
    np.testing.assert_allclose(tout.R.numpy(), np.asarray(jout.R), atol=STEP_POSE_TOL)
    np.testing.assert_allclose(tout.t.numpy(), np.asarray(jout.t), atol=STEP_POSE_TOL)
    np.testing.assert_allclose(tst.R_prev.numpy(), np.asarray(jst.R_prev), atol=STEP_POSE_TOL)
    assert bool(tst.ok) == bool(jst.ok)


@pytest.mark.parametrize("scene", ["recovery", "healthy"])
def test_step_recovery_forms_agree(step_results, scene):
    """The host-read recovery gate gives the branch-free form's result."""
    _, _, touts, _ = step_results[scene]
    (s_sel, o_sel), (s_sync, o_sync) = touts["select"], touts["sync"]
    for a, b in zip(o_sel + s_sel, o_sync + s_sync):
        assert torch.equal(a, b)


def test_step_recovers_from_broken_motion_model(step_results):
    """tests/test_fused.py's gate, on the port."""
    _, _, touts, T_cur = step_results["recovery"]
    st, out = touts["sync"]
    assert int(out.n_inliers) >= 50
    assert np.linalg.norm(out.t.numpy() - np.asarray(T_cur.t)) < 0.05
    np.testing.assert_allclose(st.R_prev.numpy(), st.R.numpy(), atol=1e-6)


W, H, K = 320, 240, 4


@pytest.fixture(scope="module")
def chunk_results():
    k = W / 752
    jcam = JCamera.pinhole(458.654 * k, 457.296 * k, 367.215 * k, 248.375 * k, width=W, height=H)
    cam = convert.camera(jcam, device="cpu")
    jcfg = JExtractorConfig(n_features=256, n_levels=4)
    cfg = convert.extractor_config(jcfg)
    T_all = orbit_trajectory(400, radius=4.0, sweep=np.pi / 2)
    T_seq = SE3(T_all.R[:30], T_all.t[:30])
    frames = render_sequence(cam, T_seq, make_texture(0, 96, 1024), plane_z=2.0, plane_half=10.0)
    kf = [0, 8, 16, 24]
    kf_feats = ORBExtractor(cfg, H, W, device="cpu")(torch.from_numpy(frames[kf]))
    cache = seed_map_cache(cam, kf_feats, SE3(T_seq.R[kf], T_seq.t[kf]), 2.0, 1024)
    s0 = 2
    state = DeviceTrackState(R=T_seq.R[s0 - 1], t=T_seq.t[s0 - 1], R_prev=T_seq.R[s0 - 2],
                             t_prev=T_seq.t[s0 - 2], ok=torch.tensor(True))
    imgs = frames[s0 : s0 + K]
    inv_s2 = inv_level_sigma2(jcfg.n_levels, jcfg.scale)
    _, touts, tfeats = make_chunk_step(cam, inv_s2, cfg, device="cpu")(
        state, cache, torch.from_numpy(imgs))
    jcache = jfused.MapCache(jnp.asarray(cache.pos.numpy()),
                             jnp.asarray(convert.desc_to_uint32(cache.desc)),
                             jnp.asarray(cache.valid.numpy()), jnp.asarray(cache.mp_id.numpy()))
    jstate = jfused.DeviceTrackState(*(jnp.asarray(x.numpy()) for x in state))
    _, jouts, jfeats = j_make_chunk_step(jcam, inv_s2, jcfg)(jstate, jcache, jnp.asarray(imgs))
    return touts, jouts, tfeats, jfeats, T_seq.t[s0 : s0 + K].numpy()


def test_chunk_poses_match_reference(chunk_results):
    touts, jouts, _, _, _ = chunk_results
    np.testing.assert_allclose(touts.R.numpy(), np.asarray(jouts.R), atol=CHUNK_POSE_TOL)
    np.testing.assert_allclose(touts.t.numpy(), np.asarray(jouts.t), atol=CHUNK_POSE_TOL)


def test_chunk_ok_and_inliers_match_reference(chunk_results):
    touts, jouts, _, _, _ = chunk_results
    t_n, j_n = touts.n_inliers.numpy(), np.asarray(jouts.n_inliers)
    np.testing.assert_array_equal(t_n >= 20, j_n >= 20)
    assert (t_n >= 20).all()
    assert (np.abs(t_n - j_n) <= CHUNK_INLIER_MARGIN * j_n).all(), (t_n, j_n)


def test_chunk_tracks_ground_truth(chunk_results):
    touts, _, tfeats, _, t_gt = chunk_results
    assert np.linalg.norm(touts.t.numpy() - t_gt, axis=-1).max() < 0.05
    assert tfeats.uv.shape == (K, 256, 2) and tfeats.desc.dtype == torch.int32


def test_chunk_level0_features_match_reference(chunk_results):
    _, _, tfeats, jfeats, _ = chunk_results
    lvl0 = np.asarray(jfeats.level) == 0
    np.testing.assert_array_equal(tfeats.uv.numpy()[lvl0], np.asarray(jfeats.uv)[lvl0])


def test_entry_points_default_to_cuda():
    """Without device=, entry points build on CUDA, and raise where there is
    none: nothing moves to the CPU quietly."""
    cfg = convert.extractor_config(JExtractorConfig(n_features=64, n_levels=2))
    cam_cpu = convert.camera(JCAM, device="cpu")
    builders = [
        lambda: Camera.pinhole(1.0, 1.0, 0.0, 0.0, 64, 64),
        lambda: convert.camera(JCAM),
        lambda: ORBExtractor(cfg, 96, 128),
        lambda: make_step_body(cam_cpu, inv_level_sigma2(), 64),
        lambda: make_chunk_step(cam_cpu, inv_level_sigma2(), cfg),
    ]
    for build in builders:
        if torch.cuda.is_available():
            build()
        else:
            with pytest.raises(RuntimeError, match="cuda"):
                build()
