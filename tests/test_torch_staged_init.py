"""Port parity: the staged IMU init (tracking/imu_frontend.py) and the loop
closer's inertial global BA, JAX vs torch, in lockstep.

Every case builds the reference's state with tests/test_staged_init.py's
_frontend_with_chain (a circle-trajectory keyframe chain whose positions
are stored mis-scaled while the preintegrations are metric) and copies it
into the port with convert.map_state and convert.imu_frontend; both
packages then run the same event. The port meets the reference's own gates
(tests/test_staged_init.py, all of it but the SaveDebugData dump, which
comes with the IO slice) and lands within the stated tolerances of the
reference's applied scale and map.
"""
import threading

import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.cameras import Camera
from orb_slam3_modified_tpu_torch.lie.se3 import SE3np
from orb_slam3_modified_tpu_torch.tracking.tracker import FrameRecord, TrackerConfig

from test_staged_init import _DummyTracker as _JDummyTracker
from test_staged_init import _frontend_with_chain

torch.set_num_threads(2)
SCALE_TOL = 1e-4  # relative, the applied refinement scale against the reference's


class _DummyTracker:
    """The port's counterpart of test_staged_init._DummyTracker."""

    def __init__(self):
        self.cfg = TrackerConfig(cam=Camera.pinhole(300.0, 300.0, 160.0, 120.0, width=320,
                                                    height=240, device="cpu"))
        self.cam = self.cfg.cam
        self.last = FrameRecord(features=None, T_cw=SE3np.identity(),
                                obs_mp=np.zeros(0, np.int32), ts=0.0, frame_id=999)
        self.velocity = None
        self.ref_kf = -1


def _both(**kw):
    jimu, jm = _frontend_with_chain(**kw)
    pm = convert.map_state(jm)
    pimu = convert.imu_frontend(jimu, device="cpu")
    return jimu, jm, pimu, pm


def test_refinement_corrects_residual_scale():
    """A stage-3 map 6% off metric is pulled back by the 25 s refinement."""
    mis = 1.06
    jimu, jm, imu, m = _both(mis_scale=mis)
    t_before = m.kf_t[imu.kf_chain[-1][0]].copy()
    assert jimu.maybe_initialize(jm, _JDummyTracker())
    ok = imu.maybe_initialize(m, _DummyTracker())
    assert ok, "refinement event did not fire / apply"
    assert imu.stage == 3 and imu.refine_idx == 1 and len(imu.align_log) == 1
    _, s = imu.align_log[0]
    assert abs(s - mis) / mis < 0.03
    ratio = np.linalg.norm(m.kf_t[imu.kf_chain[-1][0]]) / max(np.linalg.norm(t_before), 1e-9)
    assert abs(ratio - mis) / mis < 0.03
    assert imu.init_log[-1]["kind"] == "refine" and imu.init_log[-1]["applied"]
    # lockstep against the reference
    (A_j, s_j), (A_p, s_p) = jimu.align_log[0], imu.align_log[0]
    assert abs(s_p - s_j) < SCALE_TOL * s_j
    np.testing.assert_allclose(A_p, A_j, atol=1e-5)
    kfs = jm.keyframe_indices()
    np.testing.assert_allclose(m.kf_t[kfs], jm.kf_t[kfs], atol=1e-4 * np.abs(jm.kf_t[kfs]).max())
    np.testing.assert_allclose(m.kf_R[kfs], jm.kf_R[kfs], atol=1e-5)
    np.testing.assert_allclose(imu.v_w, jimu.v_w, atol=1e-4)


def test_refinement_noop_when_metric():
    jimu, jm, imu, m = _both(mis_scale=1.0)
    t_before = m.kf_t[imu.kf_chain[-1][0]].copy()
    assert not jimu.maybe_initialize(jm, _JDummyTracker())
    assert not imu.maybe_initialize(m, _DummyTracker()), "a metric map must not be realigned"
    assert imu.refine_idx == 1 and len(imu.align_log) == 0
    np.testing.assert_allclose(m.kf_t[imu.kf_chain[-1][0]], t_before)
    assert imu.init_log[-1]["applied"] is False
    assert abs(imu.init_log[-1]["scale"] - jimu.init_log[-1]["scale"]) < SCALE_TOL


def test_schedule_exhausts_and_not_for_stereo():
    """Exactly len(refine_schedule) events run, then the frontend goes
    quiet; a metric (stereo / RGB-D) map is never scheduled. The map is
    metric, so every event solves the same chain: the first solve is
    reused for the other five."""
    _, _, imu, m = _both(mis_scale=1.0, elapsed=100.0)
    solve, solved = imu._solve_inertial, []
    imu._solve_inertial = lambda snap, kind: solved[0] if solved else (
        solved.append(solve(snap, kind)) or solved[0])
    tr = _DummyTracker()
    for i in range(len(imu.refine_schedule)):
        imu.maybe_initialize(m, tr)
        assert imu.refine_idx == i + 1
    assert imu._init_due(m) is None
    _, _, imu2, m2 = _both(mis_scale=1.0, elapsed=100.0)
    imu2.cfg.mono = False
    assert imu2._init_due(m2) is None


def test_staged_init_matches_reference():
    """The init event itself (stage 0: scale, gravity and velocities solved)
    followed by the full VI BA over the chain, in lockstep: the applied
    scale within 1e-3 relative, the keyframe centres within 5e-3 m + 1e-3
    relative and the velocities within 5e-3 m/s of the reference's, the
    stage and flags the same. (The later stages, scale fixed, run in the
    course of test_torch_inertial_system.py, which reaches VIBA1.)"""
    stage = 0
    jimu, jm = _frontend_with_chain(mis_scale=2.0, stage=stage, elapsed=2.5)
    m = convert.map_state(jm)
    imu = convert.imu_frontend(jimu, device="cpu")
    jtr, tr = _JDummyTracker(), _DummyTracker()
    assert jimu.maybe_initialize(jm, jtr)
    assert imu.maybe_initialize(m, tr)
    assert (imu.stage, imu.initialized, m.imu_initialized, m.n_inertial_ba) == (
        jimu.stage, jimu.initialized, jm.imu_initialized, jm.n_inertial_ba)
    (_, s_j), (_, s_p) = jimu.align_log[-1], imu.align_log[-1]
    assert abs(s_p - s_j) < 1e-3 * s_j
    assert abs(s_p - 2.0) / 2.0 < 0.03  # the chain's true mis-scale
    kfs = jm.keyframe_indices()
    c = lambda mm: -np.einsum("kji,kj->ki", mm.kf_R[kfs], mm.kf_t[kfs])  # noqa: E731
    np.testing.assert_allclose(c(m), c(jm), atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(m.kf_vel[kfs], jm.kf_vel[kfs], atol=5e-3)
    np.testing.assert_allclose(imu.v_w, jimu.v_w, atol=5e-3)
    assert tr.velocity is None and jtr.velocity is None


def test_async_refine_commits_under_lock():
    mis = 1.05
    jimu, jm, imu, m = _both(mis_scale=mis)
    imu.async_init = True
    imu.map_lock = threading.RLock()
    tr = _DummyTracker()
    tr.velocity = SE3np.identity()
    assert not imu.maybe_initialize(m, tr)  # tracker-side: a no-op in async mode
    assert imu.refine_idx == 0 and not imu.align_log
    assert imu.run_pending_init(m, tr)
    assert imu.refine_idx == 1 and len(imu.align_log) == 1
    _, s = imu.align_log[0]
    assert abs(s - mis) / mis < 0.03
    assert tr.velocity is None  # the tracker's pose followed the transform


def test_stale_epoch_aborts_commit():
    """A reset or loss between snapshot and commit discards the solve."""
    _, _, imu, m = _both(mis_scale=1.05)
    imu.async_init = True
    imu.map_lock = threading.RLock()
    orig = imu._solve_inertial

    def solve_and_reset(snap, kind):
        res = orig(snap, kind)
        imu._epoch += 1  # the loss lands mid-solve
        return res

    imu._solve_inertial = solve_and_reset
    t_before = m.kf_t.copy()
    assert not imu.run_pending_init(m, _DummyTracker())
    assert len(imu.align_log) == 0 and imu.refine_idx == 0
    np.testing.assert_array_equal(m.kf_t, t_before)


def test_closer_inertial_global_ba_matches_reference():
    """The loop closer's VI global BA (FullInertialBA over the chain, two
    rounds of 4 iterations, the oldest keyframe fixed) on the same
    IMU-initialized chain map in both packages: centres within 5e-3 m +
    1e-3 relative, velocities within 5e-3 m/s; one run each. The tests' JAX
    sees 8 virtual CPU devices, which would send the reference down its
    multi-chip branch (ROADMAP item 12): it is shown one."""
    from unittest import mock

    import jax
    from orb_slam3_modified_tpu.bow.vocabulary import build_vocabulary
    from orb_slam3_modified_tpu.loop.loop_closer import LoopCloser as JLoopCloser
    from orb_slam3_modified_tpu.loop.loop_closer import LoopCloserConfig as JLCC
    from orb_slam3_modified_tpu.tracking.imu_frontend import ImuConfig as JImuConfig
    from orb_slam3_modified_tpu.tracking.imu_frontend import ImuFrontend as JImuFrontend
    from orb_slam3_modified_tpu.tracking.tracker import TrackerConfig as JTC
    from orb_slam3_modified_tpu_torch.bow.vocabulary import build_vocabulary as tbuild
    from orb_slam3_modified_tpu_torch.loop.loop_closer import LoopCloser, LoopCloserConfig

    from test_torch_vi_opt import BA_CAM, _chain_map

    jm, kfs, pres = _chain_map(True)
    jimu = JImuFrontend(JImuConfig())
    jimu.kf_chain = [(k, int(jm.kf_frame_id[k]), p) for k, p in zip(kfs, [pres[0]] + pres)]
    jimu.initialized, jimu.stage = True, 3
    jm.imu_initialized, jm.n_inertial_ba = True, 3
    m = convert.map_state(jm)
    imu = convert.imu_frontend(jimu, device="cpu")
    train = np.random.default_rng(0).integers(0, 2**32, (256, 8), dtype=np.uint32)
    jcl = JLoopCloser(JLCC(fix_scale=True), JTC(cam=BA_CAM), build_vocabulary(train, k=4, depth=2),
                      jm)
    jcl.imu = jimu
    cl = LoopCloser(LoopCloserConfig(fix_scale=True),
                    TrackerConfig(cam=convert.camera(BA_CAM, "cpu")),
                    tbuild(train, k=4, depth=2), m, device="cpu")
    cl.imu = imu
    one = jax.devices()[:1]
    with mock.patch.object(jax, "devices", lambda *a, **k: one):
        assert jcl._global_ba() is True
    assert cl._global_ba() is True
    assert cl.n_gba_runs == jcl.n_gba_runs == 1
    c = lambda mm: -np.einsum("kji,kj->ki", mm.kf_R[kfs], mm.kf_t[kfs])  # noqa: E731
    np.testing.assert_allclose(c(m), c(jm), atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(m.kf_vel[kfs], jm.kf_vel[kfs], atol=5e-3)
    np.testing.assert_allclose(imu.v_w, jimu.v_w, atol=5e-3)
