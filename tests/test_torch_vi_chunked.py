"""Port parity for the chunked visual-inertial frontend's device half:
tracking/vi_fused.py and the VI chunk steps, JAX vs torch.

1. The batched preintegration and the host merges (the reference's
   test_vi_chunked.py::test_chunked_merge_matches_full_integration): three
   padded frame batches integrated in one batched loop and merged on the
   host reproduce the one full integration, within the port and against
   the reference's full integration, at the reference test's tolerance.
2. The VI step body against make_vi_step_body on test_vi_chunked.py's
   SyntheticFeatureWorld geometry (a camera under a ceiling of 3000 points
   moving +x at 1 m/s, the ideal IMU), both fed the same features, cache,
   state and samples, in four cases: an accepted frame; a state 0.4 m off
   (the windowed passes fail, the recovery is taken); a cache of 15 points
   (the solve is rejected and the frame dead-reckons); a stereo frame with
   f_ur. R within 1e-5, t 1e-4, v 1e-3 (test_torch_vi_opt.py's
   marginal-solve tolerances), but v within V_TOL_RECOVERY where the
   recovery is taken: its weak prior frees the velocity (information 1
   against ~1e7 on the pose), its 12 damped iterations stop short of
   convergence there in both packages (v 0.974 -> 0.996 from 12 to 40
   iterations), and their float32 (reference) and float64 (port) normal
   equations take different paths: 3.9e-3 m/s apart at 12 iterations,
   1.1e-3 at convergence, while each package moves by < 1e-5 under a
   1e-6 m change of the state. n_inliers, ok and obs_cache_idx equal. The
   carried H_prior within 1e-4 of its largest entry, outside the gyro-bias
   rows and columns and with each package's matrix divided by its trace
   there: both packages take the Schur complement in float32, where the
   gyro bias's information is the difference of two ~5e10 random-walk
   terms and comes out a multiple of their ulp (4096; measured 8192 in the
   reference, 20480 in the port, on the accepted frame), and that block
   enters the trace cap's factor (2.6e-4 apart). The branch-free recovery
   form gives the host-read gate's result.
3. Each VI chunk step (mono, stereo, RGB-D) on one 4-frame chunk of
   bench.py's VI scene (512x384, the quarter orbit, its IMU stream, 512
   features over 4 levels, a cache seeded from ground truth, the state at
   the true pose and velocity): fed the reference's features (and, stereo,
   both its images' features), the port's stereo match or depth lookup
   equals the reference's and its rotations agree within STEP_POSE_TOL,
   its translations within the VI solve's own 1e-4; run end to end on the
   images, within CHUNK_POSE_TOL and 1 cm of the truth. Both only up to
   the reference's first frame whose carried prior is not positive
   definite (the fourth, monocular): from there the reference's solve
   returns its seed (a NaN Cholesky factor), where the port re-anchors the
   prior near-fixed and solves (tracking/vi_fused.py).
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.cameras import Camera as JCamera
from orb_slam3_modified_tpu.features.extractor import ExtractorConfig as JExtractorConfig
from orb_slam3_modified_tpu.features.extractor import extract_batch as j_extract_batch
from orb_slam3_modified_tpu.imu.preintegration import ImuBias as JImuBias
from orb_slam3_modified_tpu.imu.preintegration import integrate as j_integrate
from orb_slam3_modified_tpu.lie.se3 import SE3 as JSE3
from orb_slam3_modified_tpu.tracking import fused as jfused
from orb_slam3_modified_tpu.tracking import vi_fused as jvi
from orb_slam3_modified_tpu.tracking.imu_frontend import ImuConfig as JImuConfig
from orb_slam3_modified_tpu.utils.synthetic_features import SyntheticFeatureWorld
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.features.extractor import Features
from orb_slam3_modified_tpu_torch.imu.preintegration import ImuBias, integrate
from orb_slam3_modified_tpu_torch.lie.se3 import SE3
from orb_slam3_modified_tpu_torch.tracking import chunked as tchunked
from orb_slam3_modified_tpu_torch.tracking import vi_fused as tvi
from orb_slam3_modified_tpu_torch.tracking.tracker import inv_level_sigma2
from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import (
    imu_between, imu_stream, make_texture, orbit_poses, orbit_state, render_rgbd_sequence,
    render_stereo_sequence, seed_map_cache,
)

torch.set_num_threads(2)
R_TOL, T_TOL, V_TOL, H_REL_TOL = 1e-5, 1e-4, 1e-3, 1e-4  # test_torch_vi_opt.py's marginal solve
V_TOL_RECOVERY = 1e-2  # the weak-prior recovery solve's velocity (see the module docstring)
STEP_POSE_TOL = 1e-5  # tests/test_torch_chunk_step.py
CHUNK_POSE_TOL = 1e-3  # tests/test_torch_chunk_step.py, features extracted by each package
NOISE = (1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)


# ------------------------------------------------- 1. batched integration

@pytest.mark.parametrize("against", ["port", "reference"])
def test_chunked_merge_matches_full_integration(against):
    """The (3, 16) batch integrated in one batched loop (the reference's
    integrate_chunk) + merge_np over the frames reproduce the single
    full-batch integration: within the port, and against the reference's
    integrate."""
    rng = np.random.default_rng(0)
    N = 30
    acc = (rng.normal(0, 2, (N, 3)) + [0, 0, 9.81]).astype(np.float32)
    gyr = rng.normal(0, 0.5, (N, 3)).astype(np.float32)
    dts = np.full(N, 0.005, np.float32)
    bg = np.array([0.01, -0.02, 0.005], np.float32)
    ba = np.array([0.05, 0.0, -0.03], np.float32)
    if against == "port":
        full = integrate(torch.from_numpy(acc), torch.from_numpy(gyr), torch.from_numpy(dts),
                         torch.ones(N, dtype=torch.bool),
                         ImuBias(torch.from_numpy(bg), torch.from_numpy(ba)), *NOISE)
    else:
        full = j_integrate(jnp.asarray(acc), jnp.asarray(gyr), jnp.asarray(dts),
                           jnp.ones(N, bool), JImuBias(jnp.asarray(bg), jnp.asarray(ba)), *NOISE)
    S = 16
    a3 = np.zeros((3, S, 3), np.float32)
    g3 = np.zeros((3, S, 3), np.float32)
    d3 = np.zeros((3, S), np.float32)
    v3 = np.zeros((3, S), bool)
    for f in range(3):
        a3[f, :10] = acc[f * 10:(f + 1) * 10]
        g3[f, :10] = gyr[f * 10:(f + 1) * 10]
        d3[f, :10] = dts[f * 10:(f + 1) * 10]
        v3[f, :10] = True
    pres = integrate(*(torch.from_numpy(x) for x in (a3, g3, d3, v3)),
                     ImuBias(torch.from_numpy(bg), torch.from_numpy(ba)), *NOISE)
    pres = tchunked._tree_map(lambda x: x.numpy(), pres)
    accum = None
    for f in range(3):
        p = tvi.pre_slice_np(pres, f)
        accum = p if accum is None else tvi.merge_np(accum, p)
    for name in ("dT", "dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa"):
        a = np.asarray(getattr(full, name))
        b = np.asarray(getattr(accum, name))
        np.testing.assert_allclose(b, a, atol=5e-4 * max(1.0, float(np.abs(a).max())),
                                   err_msg=f"{name} diverges between chunked and full integration")


def test_merge_np_matches_reference():
    """The port's host merge and the reference's on the same two intervals."""
    rng = np.random.default_rng(1)
    acc = (rng.normal(0, 2, (2, 10, 3)) + [0, 0, 9.81]).astype(np.float32)
    gyr = rng.normal(0, 0.5, (2, 10, 3)).astype(np.float32)
    dts = np.full((2, 10), 0.005, np.float32)
    bias = JImuBias(jnp.asarray([0.01, -0.02, 0.005]), jnp.asarray([0.05, 0.0, -0.03]))
    pres = jvi.integrate_chunk(jnp.asarray(acc), jnp.asarray(gyr), jnp.asarray(dts),
                               jnp.ones((2, 10), bool), bias, *NOISE)
    pres = jax.tree_util.tree_map(np.asarray, pres)
    p0, p1 = jvi.pre_slice_np(pres, 0), jvi.pre_slice_np(pres, 1)
    jm = jvi.merge_np(p0, p1)
    tm = tvi.merge_np(tvi.pre_slice_np(pres, 0), tvi.pre_slice_np(pres, 1))
    for name in jm._fields:
        a, b = getattr(jm, name), getattr(tm, name)
        for x, y in (zip(a, b) if name == "bias" else [(a, b)]):
            np.testing.assert_allclose(np.asarray(y), np.asarray(x), rtol=1e-6, atol=1e-7,
                                       err_msg=name)


# ------------------------------------------------- 2. the VI step body

CAM_ARGS = (330.0, 330.0, 256.0, 192.0)
BF = 330.0 * 0.11


@pytest.fixture(scope="module")
def step_world():
    """test_vi_chunked.py:60's geometry: (cam, world features at T1, their
    true depths, the ground-truth cache, T1's camera centre, the observed
    points' ids)."""
    jcam = JCamera.pinhole(*CAM_ARGS, width=512, height=384)
    world = SyntheticFeatureWorld(n_points=3000, feat_cap=512, noise_px=0.3, seed=3)
    rng = np.random.default_rng(3)
    pts = rng.uniform(-4, 4, (3000, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(2.0, 6.0, 3000)
    world.points = pts
    p1 = np.array([0.05, 0.0, 0.0], np.float32)
    feats, ids = world.observe(jcam, JSE3(jnp.eye(3), jnp.asarray(-p1)), max_feats=400)
    depth = np.full(feats.capacity, -1.0, np.float32)
    depth[:len(ids)] = pts[ids, 2]
    cap = jfused.CACHE_CAP
    cache = dict(pos=np.zeros((cap, 3), np.float32), desc=np.zeros((cap, 8), np.uint32),
                 valid=np.zeros(cap, bool), mp_id=np.full(cap, -1, np.int32))
    cache["pos"][:3000] = pts
    cache["desc"][:3000] = world.desc
    cache["valid"][:3000] = True
    cache["mp_id"][:3000] = np.arange(3000)
    return jcam, feats, depth, cache, p1, ids


STEP_CASES = ["accepted", "recovery", "dead_reckon", "stereo"]


@pytest.fixture(scope="module")
def step_inputs(step_world):
    """What every case shares, and the reference's jitted bodies (one
    compile per signature)."""
    jcam, feats, depth, cache, p1, ids = step_world
    dt, n_s = 0.05, 10
    imu = (np.tile([0.0, 0.0, 9.81], (16, 1)).astype(np.float32), np.zeros((16, 3), np.float32),
           np.full(16, dt / n_s, np.float32), np.arange(16) < n_s)
    ur = np.where(depth > 0, np.asarray(feats.uv)[:, 0] - BF / np.maximum(depth, 1e-6), -1.0)
    return dict(inv_s2=(1.0 / 1.2 ** (2 * np.arange(8))).astype(np.float32), imu=imu,
                cam=convert.camera(jcam, device="cpu"), tf=convert.features(feats, device="cpu"),
                ur=ur.astype(np.float32), bodies={})


@pytest.fixture(scope="module", params=STEP_CASES)
def step_result(request, step_world, step_inputs):
    """One case: (case, the reference's (state, out), the port's outputs of
    the host-read ("sync") and branch-free ("select") forms, whether the
    port's recovery pass ran)."""
    case = request.param
    jcam, feats, depth, cache, p1, ids = step_world
    inv_s2, imu, ur = step_inputs["inv_s2"], step_inputs["imu"], step_inputs["ur"]
    c = dict(cache)
    if case == "dead_reckon":  # 15 observed points left: too few inliers to accept
        c["valid"] = np.isin(np.arange(len(cache["valid"])), ids[:15])
    p0 = np.array([0.4, 0.0, 0.0], np.float32) if case == "recovery" else np.zeros(3, np.float32)
    jstate = jvi.VITrackState(
        R=jnp.eye(3), t=jnp.asarray(-p0), v_w=jnp.asarray([1.0, 0.0, 0.0]), bg=jnp.zeros(3),
        ba=jnp.zeros(3), H_prior=jnp.asarray(jvi._FIXED_INFO), ok=jnp.asarray(True))
    bf = BF if case == "stereo" else 0.0
    bodies = step_inputs["bodies"]
    if bf not in bodies:
        bodies[bf] = jax.jit(jvi.make_vi_step_body(jcam, inv_s2, feats.capacity, JImuConfig(),
                                                   bf=bf))
    args = (jfused.MapCache(*(jnp.asarray(c[k]) for k in ("pos", "desc", "valid", "mp_id"))),
            feats.uv, feats.desc, feats.level, feats.valid, *(jnp.asarray(x) for x in imu))
    jres = bodies[bf](jstate, *args, *((jnp.asarray(ur),) if case == "stereo" else ()))
    step = tvi.make_vi_step_body(step_inputs["cam"], inv_s2, feats.capacity,
                                 convert.imu_config(JImuConfig()), bf=bf, device="cpu")
    tstate = convert.vi_track_state(jstate, device="cpu")
    pre = integrate(*(torch.from_numpy(x) for x in imu), ImuBias(tstate.bg, tstate.ba), *NOISE)
    tf = step_inputs["tf"]
    targs = (convert.map_cache(jfused.MapCache(**c), device="cpu"), tf.uv, tf.desc, tf.level,
             tf.valid, pre, torch.from_numpy(ur) if case == "stereo" else None)
    brute = []
    match = tvi.mutual_best_match
    with mock.patch.object(tvi, "mutual_best_match",
                           lambda *a, **kw: brute.append(1) or match(*a, **kw)):
        tres = {"sync": step(tstate, *targs)}
    with mock.patch.object(tvi, "_branch_free", lambda t: True):
        tres["select"] = step(tstate, *targs)
    return case, jres, tres, bool(brute)


def test_vi_step_body_matches_reference(step_result):
    case, (jst, jout), tres, _ = step_result
    tst, tout = tres["sync"]
    assert int(tout.n_inliers) == int(jout.n_inliers)
    assert bool(tst.ok) == bool(jst.ok)
    np.testing.assert_array_equal(tout.obs_cache_idx.numpy(), np.asarray(jout.obs_cache_idx))
    np.testing.assert_allclose(tout.R.numpy(), np.asarray(jout.R), atol=R_TOL)
    np.testing.assert_allclose(tout.t.numpy(), np.asarray(jout.t), atol=T_TOL)
    v_tol = V_TOL_RECOVERY if case == "recovery" else V_TOL
    np.testing.assert_allclose(tout.v_w.numpy(), np.asarray(jout.v_w), atol=v_tol)
    np.testing.assert_allclose(tst.v_w.numpy(), np.asarray(jst.v_w), atol=v_tol)
    H_ref, H_port = np.asarray(jst.H_prior), tst.H_prior.numpy()
    keep = np.r_[0:9, 12:15]
    A_ref, A_port = (H[np.ix_(keep, keep)] for H in (H_ref, H_port))
    A_ref, A_port = A_ref / np.trace(A_ref), A_port / np.trace(A_port)
    np.testing.assert_allclose(A_port, A_ref, atol=H_REL_TOL * np.abs(A_ref).max())
    assert np.isfinite(H_port).all() and np.trace(H_port) <= 1e7 * (1 + 1e-6)
    np.testing.assert_allclose(tout.pre.dT.numpy(), np.asarray(jout.pre.dT), atol=1e-7)


def test_vi_step_body_case_is_what_it_names(step_result, step_world):
    """Each case exercises its branch: accepted frames carry a Schur
    marginal (not the near-fixed seed) and track truth, the recovery pass
    ran (the brute match) and was taken, the rejected frame dead-reckons
    the IMU prediction with the near-fixed prior; the stereo frame tracks."""
    case, (jst, jout), tres, brute = step_result
    tst, tout = tres["sync"]
    p1 = step_world[4]
    n = int(tout.n_inliers)
    if case == "dead_reckon":
        assert n < 0 and not bool(tst.ok) and brute
        np.testing.assert_allclose(tst.H_prior.numpy(), tvi._FIXED_INFO)
        np.testing.assert_allclose(tout.t.numpy(), -p1, atol=1e-4)  # the exact IMU prediction
        return
    assert n >= 50 and bool(tst.ok)
    np.testing.assert_allclose(tout.t.numpy(), -p1, atol=0.02)
    H = tst.H_prior.numpy()
    assert np.abs(H - np.diag(np.diag(H))).max() > 0, "prior not carried"
    assert brute == (case == "recovery")


def test_vi_step_recovery_forms_agree(step_result):
    """The host-read recovery gate gives the branch-free form's result."""
    _, _, tres, _ = step_result
    (s_sel, o_sel), (s_sync, o_sync) = tres["select"], tres["sync"]
    for a, b in zip(tuple(o_sel[:7]) + tuple(s_sel), tuple(o_sync[:7]) + tuple(s_sync)):
        assert torch.equal(a, b)


# ------------------------------------------------- 3. the VI chunk steps

VW, VH, K, S0 = 512, 384, 4, 24
CHUNK_SENSORS = ["mono", "stereo", "rgbd"]


@pytest.fixture(scope="module")
def vi_chunk_scene():
    """bench.py's VI scene: frames S0-1 .. S0+K-1 of the quarter orbit, the
    right images and depth maps, the IMU samples of the chunk's frames, a
    ground-truth cache from four keyframes and the state at frame S0 - 1."""
    jcam = JCamera.pinhole(*CAM_ARGS, width=VW, height=VH)
    cam = convert.camera(jcam, device="cpu")
    jcfg = JExtractorConfig(n_features=512, n_levels=4)
    orbit = dict(fps=20.0, radius=4.0, sweep=np.pi / 2)
    T_all = orbit_poses(400, **orbit)
    sel = list(range(S0 - 8, S0 + K))
    T_seq = SE3(T_all.R[sel], T_all.t[sel])
    tex = make_texture(0, 96, 1024)
    with np.errstate(invalid="ignore"):
        left, right = render_stereo_sequence(cam, T_seq, tex, 0.11)
        _, dmaps = render_rgbd_sequence(cam, T_seq, tex)
    kf = [0, 3, 6, 9]
    kf_feats = tchunked.ORBExtractor(convert.extractor_config(jcfg), VH, VW, device="cpu")(
        torch.from_numpy(left[kf]))
    cache = seed_map_cache(cam, kf_feats, SE3(T_seq.R[kf], T_seq.t[kf]), 2.0, 4096)
    its, igyro, iacc = imu_stream(400, **orbit)
    pads = [tchunked._pad_imu(imu_between(its, igyro, iacc, (f - 1) / 20.0, f / 20.0))
            for f in range(S0, S0 + K)]
    imu = tuple(np.stack([p[j] for p in pads]) for j in range(4))
    _, _, v_w, _ = orbit_state((S0 - 1) / 20.0, 400 / 20.0, 4.0, np.pi / 2)
    i0 = 7  # frame S0 - 1
    state = tvi.VITrackState(R=T_seq.R[i0], t=T_seq.t[i0], v_w=torch.tensor(v_w, dtype=torch.float32),
                             bg=torch.zeros(3), ba=torch.zeros(3),
                             H_prior=torch.from_numpy(tvi._FIXED_INFO), ok=torch.tensor(True))
    frames = slice(8, 8 + K)
    return (jcam, cam, jcfg, left[frames], right[frames], dmaps[frames], cache, imu, state,
            T_seq.t[frames].numpy())


@pytest.fixture(scope="module", params=CHUNK_SENSORS)
def vi_chunk_result(request, vi_chunk_scene):
    """One sensor's chunk: (the reference's outputs, the port's on the
    reference's features, the port's on the images, the reference's (ur,
    depth), the port's on the reference's features, the true t)."""
    sensor = request.param
    jcam, cam, jcfg, left, right, dmaps, cache, imu, state, t_gt = vi_chunk_scene
    inv_s2 = inv_level_sigma2(jcfg.n_levels, jcfg.scale)
    icfg = JImuConfig()
    jcache = jfused.MapCache(jnp.asarray(cache.pos.numpy()),
                             jnp.asarray(convert.desc_to_uint32(cache.desc)),
                             jnp.asarray(cache.valid.numpy()), jnp.asarray(cache.mp_id.numpy()))
    jstate = jvi.VITrackState(*(jnp.asarray(x.numpy()) for x in state))
    jimu = tuple(jnp.asarray(x) for x in imu)
    timu = tuple(torch.from_numpy(x) for x in imu)
    tcfg = convert.extractor_config(jcfg)
    ticfg = convert.imu_config(icfg)
    if sensor == "mono":
        _, jouts, jfeats = jvi.make_vi_chunk_step(jcam, inv_s2, jcfg, icfg)(
            jstate, jcache, jnp.asarray(left), *jimu)
        step = tchunked.make_vi_chunk_step(cam, inv_s2, tcfg, ticfg, device="cpu")
        images = (torch.from_numpy(left),)
        jdepth = None
    elif sensor == "stereo":
        _, jouts, jfeats, jurs, jdepth = jvi.make_vi_chunk_step_stereo(
            jcam, inv_s2, jcfg, icfg, BF, 0.3)(
            jstate, jcache, jnp.asarray(left), jnp.asarray(right), *jimu)
        step = tchunked.make_vi_chunk_step_stereo(cam, inv_s2, tcfg, ticfg, BF, 0.3,
                                                  device="cpu")
        images = (torch.from_numpy(left), torch.from_numpy(right))
    else:
        _, jouts, jfeats, jurs, jdepth = jvi.make_vi_chunk_step_rgbd(
            jcam, inv_s2, jcfg, icfg, BF)(jstate, jcache, jnp.asarray(left),
                                         jnp.asarray(dmaps), *jimu)
        step = tchunked.make_vi_chunk_step_rgbd(cam, inv_s2, tcfg, ticfg, BF, device="cpu")
        images = (torch.from_numpy(left), torch.from_numpy(dmaps))
    tfeats = convert.features(jfeats, device="cpu")
    urs = depths = None
    if sensor == "stereo":  # the port's match on the reference's left and right features
        both = j_extract_batch(jnp.concatenate([jnp.asarray(left), jnp.asarray(right)])
                               .astype(jnp.float32), jcfg)
        tright = convert.features(Features(*(np.asarray(f)[K:] for f in both)), device="cpu")
        urs, depths = step.match(tfeats, tright)
    elif sensor == "rgbd":
        urs, depths = step.lookup(tfeats, torch.from_numpy(dmaps))
    _, touts = step.track(state, cache, tfeats, timu, urs)
    _, touts_img, _, *_ = step(state, cache, *images, *timu)
    return (jouts, touts, touts_img, None if jdepth is None else (jurs, jdepth),
            None if depths is None else (urs, depths), t_gt)


def _reference_solved(jouts, state):
    """Per frame: did the reference's VI solve run? Where its carried prior
    is not positive definite its factor turns NaN and the solve returns its
    seed, the bias exactly unchanged."""
    bg = np.concatenate([state.bg.numpy()[None], np.asarray(jouts.bg)])
    ba = np.concatenate([state.ba.numpy()[None], np.asarray(jouts.ba)])
    return ~((bg[1:] == bg[:-1]).all(1) & (ba[1:] == ba[:-1]).all(1))


def test_vi_chunk_step_matches_reference(vi_chunk_result, vi_chunk_scene):
    """The same features: the stereo match / depth lookup equal; up to the
    reference's first unsolved frame, n_inliers and obs_cache_idx equal, R
    within STEP_POSE_TOL and t within T_TOL (one VI solve's own parity,
    test_torch_vi_opt.py: the chunk's t agree to 1.6e-5 m)."""
    jouts, touts, _, jdepth, tdepth, _ = vi_chunk_result
    if jdepth is not None:
        for j, t in zip(jdepth, tdepth):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    solved = _reference_solved(jouts, vi_chunk_scene[8])
    m = int(np.argmin(solved)) if not solved.all() else K
    assert m >= 2, solved
    np.testing.assert_array_equal(touts.n_inliers.numpy()[:m], np.asarray(jouts.n_inliers)[:m])
    np.testing.assert_array_equal(touts.obs_cache_idx.numpy()[:m],
                                  np.asarray(jouts.obs_cache_idx)[:m])
    np.testing.assert_allclose(touts.R.numpy()[:m], np.asarray(jouts.R)[:m], atol=STEP_POSE_TOL)
    np.testing.assert_allclose(touts.t.numpy()[:m], np.asarray(jouts.t)[:m], atol=T_TOL)


def test_vi_chunk_step_on_images_tracks(vi_chunk_result, vi_chunk_scene):
    """End to end on the images (each package extracting its own
    features): every frame accepted in both packages and within 1 cm of
    the truth, the port's within CHUNK_POSE_TOL of the reference's up to
    the reference's first unsolved frame; from there on the port's solve
    runs (its bias moves) where the reference's returned its seed."""
    jouts, _, touts, _, _, t_gt = vi_chunk_result
    t_n, j_n = touts.n_inliers.numpy(), np.asarray(jouts.n_inliers)
    assert (t_n >= 20).all() and (j_n >= 20).all(), (t_n, j_n)
    for t in (touts.t.numpy(), np.asarray(jouts.t)):
        assert np.linalg.norm(t - t_gt, axis=-1).max() < 0.01
    state = vi_chunk_scene[8]
    solved = _reference_solved(jouts, state)
    m = int(np.argmin(solved)) if not solved.all() else K
    np.testing.assert_allclose(touts.R.numpy()[:m], np.asarray(jouts.R)[:m], atol=CHUNK_POSE_TOL)
    np.testing.assert_allclose(touts.t.numpy()[:m], np.asarray(jouts.t)[:m], atol=CHUNK_POSE_TOL)
    assert _reference_solved(touts, state).all()
