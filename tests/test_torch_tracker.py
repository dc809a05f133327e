"""Port parity: the feature-level Tracker + LocalMapper, JAX vs torch.

The scene of tests/test_e2e_mono.py: 40 frames of the reference's
SyntheticFeatureWorld (an ideal extractor over 4000 points, 0.4 px noise) on
a 60 deg orbit. The reference's features are drawn once and fed to both
packages as the same numpy arrays. The port meets the reference's own
gates (>= 37 tracked frames, OK at the end, scale-aligned ATE < 0.02 m,
>= 3 keyframes, > 300 points, no observation of a dead point). Against the
JAX run: the same initialization frame pair, keyframe counts within
KF_MARGIN, and the first 10 tracked camera centres within POSE_TOL after
one similarity alignment. Both initializers draw their minimal sets from
different generators (jax.random vs torch.Generator), so the two-view
solutions differ by their noise, and the mono scale by the median depth.
"""
import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.cameras import Camera as JCamera
from orb_slam3_modified_tpu.eval.ate import align_horn
from orb_slam3_modified_tpu.lie.se3 import SE3 as JSE3
from orb_slam3_modified_tpu.mapping.local_mapper import LocalMapper as JLocalMapper
from orb_slam3_modified_tpu.mapping.local_mapper import LocalMapperConfig as JLocalMapperConfig
from orb_slam3_modified_tpu.slam_map.map_state import MapState as JMapState
from orb_slam3_modified_tpu.tracking.tracker import Tracker as JTracker
from orb_slam3_modified_tpu.tracking.tracker import TrackerConfig as JTrackerConfig
from orb_slam3_modified_tpu.utils.synthetic import orbit_trajectory
from orb_slam3_modified_tpu.utils.synthetic_features import SyntheticFeatureWorld
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.eval.ate import ate_rmse
from orb_slam3_modified_tpu_torch.features.extractor import Features
from orb_slam3_modified_tpu_torch.mapping.local_mapper import LocalMapper, LocalMapperConfig
from orb_slam3_modified_tpu_torch.slam_map.map_state import NO_POINT, MapState
from orb_slam3_modified_tpu_torch.tracking.tracker import OK, Tracker, TrackerConfig

torch.set_num_threads(2)
JCAM = JCamera.pinhole(458.654, 457.296, 367.215, 248.375, width=752, height=480)
N_FRAMES = 40
POSE_TOL = 0.01  # m, first 10 tracked camera centres after one similarity alignment
KF_MARGIN = 2


def _run(tracker, mapper, feats_all):
    """Tracked (frame, T_cw) pairs and the frame ids of the keyframes in
    the order they were created."""
    kf_frames = []

    def on_keyframe(k):
        kf_frames.append(int(tracker.map.kf_frame_id[k]))
        mapper.on_keyframe(k)

    tracker.on_keyframe = on_keyframe
    out = []
    for i, f in enumerate(feats_all):
        T = tracker.track(f, ts=i * 0.05)
        if T is not None:
            out.append((i, np.asarray(T)))
    return out, kf_frames


@pytest.fixture(scope="module")
def runs():
    world = SyntheticFeatureWorld(n_points=4000, spread=5.0, seed=0, feat_cap=768, noise_px=0.4)
    T_all = orbit_trajectory(N_FRAMES, radius=4.0, sweep=np.pi / 3)
    feats_all, gt = [], []
    for i in range(N_FRAMES):
        f, _ = world.observe(JCAM, JSE3(T_all.R[i], T_all.t[i]), max_feats=600)
        feats_all.append(Features(*(np.array(x) for x in f)))
        gt.append(np.asarray(JSE3(T_all.R[i], T_all.t[i]).inverse().t))
    # reference
    jmap = JMapState.create(max_kf=128, max_mp=16384, feat_cap=768)
    jcfg = JTrackerConfig(cam=JCAM)
    jt = JTracker(jcfg, jmap)
    jest, jkf = _run(jt, JLocalMapper(JLocalMapperConfig(), jcfg, jmap), feats_all)
    # port
    tmap = MapState.create(max_kf=128, max_mp=16384, feat_cap=768)
    tcfg = TrackerConfig(cam=convert.camera(JCAM, device="cpu"))
    tt = Tracker(tcfg, tmap, device="cpu")
    test, tkf = _run(tt, LocalMapper(LocalMapperConfig(), tcfg, tmap, device="cpu"), feats_all)
    return dict(jt=jt, jmap=jmap, jest=jest, jkf=jkf, tt=tt, tmap=tmap, test=test, tkf=tkf,
                gt=np.array(gt))


def test_port_meets_the_reference_gates_and_agrees_with_its_run(runs):
    """One test for the whole run: a module fixture runs once per worker
    that draws one of its tests."""
    tt, tmap, est, gt = runs["tt"], runs["tmap"], runs["test"], runs["gt"]
    assert len(est) >= 37, f"tracked only {len(est)} frames"
    assert tt.state == OK
    pos = np.array([np.linalg.inv(T)[:3, 3] for _, T in est])
    rmse, _ = ate_rmse(pos, gt[[i for i, _ in est]])
    assert rmse < 0.02, f"ATE {rmse:.4f} m"
    assert tmap.n_keyframes() >= 3 and tmap.n_points() > 300
    for k in tmap.keyframe_indices():
        obs = tmap.kf_obs[k]
        assert tmap.mp_valid[obs[obs != NO_POINT]].all(), "observation of a dead point"
    jest, test, jmap = runs["jest"], est, runs["jmap"]
    # the same initialization pair (the first two keyframes) and tracked frames
    assert runs["tkf"][:2] == runs["jkf"][:2]
    assert [i for i, _ in test] == [i for i, _ in jest]
    assert abs(len(runs["tkf"]) - len(runs["jkf"])) <= KF_MARGIN  # keyframes created
    assert abs(tmap.n_keyframes() - jmap.n_keyframes()) <= KF_MARGIN  # and alive
    c_t = np.array([np.linalg.inv(T)[:3, 3] for _, T in test[:10]])
    c_j = np.array([np.linalg.inv(T)[:3, 3] for _, T in jest[:10]])
    _, _, _, err = align_horn(c_t.T, c_j.T)
    assert err.max() < POSE_TOL, err


def test_port_tracks_the_kb8_fisheye_course():
    """tests/test_e2e_fisheye.py's course on the port's Tracker + LocalMapper
    (a Kannala-Brandt-8 camera, 30 frames of a 45 deg orbit, the reference's
    ideal features), with its gates: >= 25 frames tracked, OK at the end,
    scale-aligned ATE < 0.03 m."""
    kb8 = JCamera.kb8(190.978, 190.973, 254.932, 256.897, 0.00348238, 0.000715034, -0.00205323,
                      0.000202936, width=512, height=512)
    world = SyntheticFeatureWorld(n_points=6000, spread=5.0, seed=2, feat_cap=768, noise_px=0.4)
    T_all = orbit_trajectory(30, radius=4.0, sweep=np.pi / 4)
    m = MapState.create(max_kf=128, max_mp=16384, feat_cap=768)
    tcfg = TrackerConfig(cam=convert.camera(kb8, device="cpu"))
    tracker = Tracker(tcfg, m, device="cpu")
    tracker.on_keyframe = LocalMapper(LocalMapperConfig(), tcfg, m, device="cpu").on_keyframe
    gt_of = {}
    for i in range(30):
        T_cw = JSE3(T_all.R[i], T_all.t[i])
        f, _ = world.observe(kb8, T_cw, max_feats=600)
        tracker.track(Features(*(np.array(x) for x in f)), ts=i * 0.05)
        gt_of[i] = np.asarray(T_cw.inverse().t)
    traj = tracker.absolute_trajectory()
    assert len(traj) >= 25, f"tracked {len(traj)}"
    assert tracker.state == OK
    est = np.array([np.linalg.inv(T)[:3, 3] for _, _, T in traj])
    rmse, _ = ate_rmse(est, np.array([gt_of[fid] for _, fid, _ in traj]))
    assert rmse < 0.03, f"fisheye ATE {rmse}"
