"""Port parity: the visual-inertial frame solves and the VI bundle
adjustment, JAX vs torch.

The cases of tests/test_vi_pose_opt.py and tests/test_vi_ba.py go through
orb_slam3_modified_tpu and its port (orb_slam3_modified_tpu_torch, CPU).
The port's jacobians are float64 central differences where the reference
takes jax.jacfwd (optim/jacobian.py), so results agree to float32 rounding
amplified by each problem's conditioning; tolerances are stated per test.
The VI BA's mixed (pose, velocity, bias) system spans four orders of
magnitude, and MKL rounds the port's CPU sums with buffer alignment: its
tolerances are absolute and relative. The reference's own gates are
asserted on the port as well.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.lie import se3 as jse3
from orb_slam3_modified_tpu.optim import vi_ba as JB
from orb_slam3_modified_tpu.optim import vi_pose_opt as JV
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.lie.se3 import SE3, SE3np
from orb_slam3_modified_tpu_torch.optim import vi_ba as PB
from orb_slam3_modified_tpu_torch.optim import vi_pose_opt as PV
from orb_slam3_modified_tpu_torch.optim.inertial import InertialChain

from test_vi_ba import CAM as BA_CAM
from test_vi_ba import _make_problem
from test_vi_pose_opt import CAM, make_vi_case

torch.set_num_threads(2)
STRONG = np.diag(np.concatenate([np.full(6, 1e6), np.full(9, 1e4)])).astype(np.float32)
WEAK = (np.eye(15) * 1e-4).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _case(seed=0, few=None, noise_px=0.5):
    T_gt, R0, p0, v0, v_end, pre, pts_w, uv = make_vi_case(noise_px=noise_px, seed=seed)
    if few is not None:
        pts_w, uv = pts_w[:few], uv[:few]
    n = pts_w.shape[0]
    T0 = jse3.exp(jnp.asarray([0.02, -0.01, 0.015, 0.01, -0.008, 0.012])) @ T_gt
    jargs = (T0, CAM, pts_w, uv, jnp.ones(n), jnp.ones(n, bool), jnp.asarray(R0, jnp.float32),
             jnp.asarray(p0, jnp.float32), jnp.asarray(v0, jnp.float32))
    pargs = (SE3(_t(T0.R), _t(T0.t)), convert.camera(CAM, "cpu"), _t(pts_w), _t(uv), torch.ones(n),
             torch.ones(n, dtype=torch.bool), _t(np.float32(R0)), _t(np.float32(p0)),
             _t(np.float32(v0)))
    jpre = (pre.dT, pre.dR, pre.dV, pre.dP, pre.JRg, pre.JVg, pre.JVa, pre.JPg, pre.JPa)
    return T_gt, v_end, pre, jargs, pargs, jpre, tuple(_t(x) for x in jpre)


def _rot_deg(R, R_gt):
    dR = np.asarray(R) @ np.asarray(R_gt).T
    return np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))


@pytest.mark.parametrize("few", [None, 12])
def test_vi_pose_optimization_matches_reference(few):
    """The 15-D solve against a fixed previous state: pose within 1e-5
    (rotation) / 1e-4 m, velocity within 1e-3 m/s of the reference."""
    T_gt, v_end, pre, jargs, pargs, jpre, ppre = _case(few=few, noise_px=2.0 if few else 0.5)
    want = JV.vi_pose_optimization(*jargs, *jpre)
    got = PV.vi_pose_optimization(*pargs, *ppre)
    np.testing.assert_allclose(got.T_cw.R.numpy(), np.asarray(want.T_cw.R), atol=1e-5)
    np.testing.assert_allclose(got.T_cw.t.numpy(), np.asarray(want.T_cw.t), atol=1e-4)
    np.testing.assert_allclose(got.v_w.numpy(), np.asarray(want.v_w), atol=1e-3)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    if few is None:  # the reference's gates
        assert _rot_deg(got.T_cw.R, T_gt.R) < 0.3
        assert np.linalg.norm(got.T_cw.t.numpy() - np.asarray(T_gt.t)) < 0.05
        assert np.linalg.norm(got.v_w.numpy() - v_end) < 0.1


@pytest.mark.parametrize("prior,few,seed", [("strong", None, 0), ("weak", None, 0),
                                            ("strong", 4, 3)])
def test_vi_pose_optimization_marg_matches_reference(prior, few, seed):
    """The per-frame 30-D solve and its Schur marginal: pose within 1e-5
    (rotation) / 1e-4 m, velocity within 1e-3 m/s, H_marg within 1e-4 of its
    largest entry (~8e7), the same inliers."""
    H = STRONG if prior == "strong" else WEAK
    T_gt, v_end, pre, jargs, pargs, jpre, ppre = _case(seed=seed, few=few)
    want = JV.vi_pose_optimization_marg(*jargs, jnp.asarray(H), *jpre, C=pre.C)
    got = PV.vi_pose_optimization_marg(*pargs, _t(H), *ppre, C=_t(pre.C))
    np.testing.assert_allclose(got.T_cw.R.numpy(), np.asarray(want.T_cw.R), atol=1e-5)
    np.testing.assert_allclose(got.T_cw.t.numpy(), np.asarray(want.T_cw.t), atol=1e-4)
    np.testing.assert_allclose(got.v_w.numpy(), np.asarray(want.v_w), atol=1e-3)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    Hw = np.asarray(want.H_marg)
    np.testing.assert_allclose(got.H_marg.numpy(), Hw, atol=1e-4 * np.abs(Hw).max())
    for f in ("R_wb", "p_wb", "dbg", "dba"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   atol=1e-4, err_msg=f)
    if prior == "strong" and few is None:  # the reference's gates
        assert _rot_deg(got.T_cw.R, T_gt.R) < 0.3
        assert np.linalg.norm(got.T_cw.t.numpy() - np.asarray(T_gt.t)) < 0.05
        Hm = got.H_marg.numpy()
        ev = np.linalg.eigvalsh(0.5 * (Hm + Hm.T))
        assert ev.min() > -1e-2 * max(ev.max(), 1.0) and np.trace(Hm[:6, :6]) > 1e3


def test_vi_pose_optimization_marg_stereo_rows_match_reference():
    """The (u, v, uR) rows of the stereo-inertial frame solve (EdgeStereoOnlyPose)."""
    T_gt, v_end, pre, jargs, pargs, jpre, ppre = _case(seed=1)
    pts_w = np.asarray(jargs[2])
    pc = pts_w @ np.asarray(T_gt.R).T + np.asarray(T_gt.t)
    bf = 0.11 * 458.654
    ur = np.asarray(jargs[3])[:, 0] - bf / pc[:, 2]
    ur[::3] = -1.0  # a third of the rows stay monocular
    ur = ur.astype(np.float32)
    want = JV.vi_pose_optimization_marg(*jargs, jnp.asarray(STRONG), *jpre, C=pre.C,
                                        ur_obs=jnp.asarray(ur), bf=jnp.asarray(bf, jnp.float32))
    got = PV.vi_pose_optimization_marg(*pargs, _t(STRONG), *ppre, C=_t(pre.C), ur_obs=_t(ur),
                                       bf=torch.tensor(bf, dtype=torch.float32))
    np.testing.assert_allclose(got.T_cw.R.numpy(), np.asarray(want.T_cw.R), atol=1e-5)
    np.testing.assert_allclose(got.T_cw.t.numpy(), np.asarray(want.T_cw.t), atol=1e-4)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))


def _port_problem(prob):
    d = {}
    for f in prob._fields:
        v = getattr(prob, f)
        if f == "T_cw":
            d[f] = SE3np(np.asarray(v.R), np.asarray(v.t))
        elif f == "chain":
            d[f] = InertialChain(*(np.asarray(x) for x in v))
        else:
            d[f] = None if v is None else np.asarray(v)
    return PB.to_device(PB.VIBAProblem(**d), "cpu")


@pytest.mark.parametrize("seed,schedule,window", [(0, (2, 10), False), (2, (1, 5), True)])
def test_vi_bundle_adjust_matches_reference(seed, schedule, window):
    """FullInertialBA (state free everywhere) and the window form (the
    anchor's whole state pinned): camera centres within 5e-3 m + 1e-3
    relative, rotations within 1e-4, velocities within 5e-3 m/s, biases
    within 2e-3 (half the reference's own bias gate: these problems observe
    the bias weakly, and its value moves most with the rounding), points
    within 1e-2 m of the reference's, the same inlier set, and the
    reference's gates."""
    prob, R_gt, t_gt, v_gt, pts_gt = _make_problem(seed=seed)
    if window:
        prob = prob._replace(state_fixed=prob.cam_fixed)
    want = JB.vi_bundle_adjust(prob, BA_CAM, *schedule)
    got = PB.vi_bundle_adjust(_port_problem(prob), convert.camera(BA_CAM, "cpu"), *schedule)
    Rw, tw = np.asarray(want.T_cw.R), np.asarray(want.T_cw.t)
    Rg, tg = got.T_cw.R.numpy(), got.T_cw.t.numpy()
    c_w = _centres(Rw, tw)
    c_g = _centres(Rg, tg)
    # a BA that left its start in place would miss the limits below
    assert np.abs(c_w - _centres(prob.T_cw.R, prob.T_cw.t)).max() > 10 * 5e-3
    assert np.abs(np.asarray(want.points) - np.asarray(prob.points)).max() > 5 * 1e-2
    assert np.abs(np.asarray(want.v_w) - np.asarray(prob.v_w)).max() > 10 * 5e-3
    np.testing.assert_allclose(c_g, c_w, atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(Rg, Rw, atol=1e-4)
    np.testing.assert_allclose(got.v_w.numpy(), np.asarray(want.v_w), atol=5e-3)
    np.testing.assert_allclose(got.bg.numpy(), np.asarray(want.bg), atol=2e-3)
    np.testing.assert_allclose(got.ba.numpy(), np.asarray(want.ba), atol=2e-3)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), atol=1e-2, rtol=1e-3)
    np.testing.assert_array_equal(got.obs_inlier.numpy(), np.asarray(want.obs_inlier))
    if window:
        np.testing.assert_allclose(Rg[0], np.asarray(prob.T_cw.R)[0], atol=1e-6)
        np.testing.assert_allclose(got.v_w.numpy()[0], np.asarray(prob.v_w)[0], atol=1e-6)
    else:
        c_gt = -np.einsum("kji,kj->ki", R_gt, t_gt)
        assert np.abs(c_g - c_gt).max() < 2e-2
        rot = [np.linalg.norm(Rg[k] @ R_gt[k].T - np.eye(3)) for k in range(len(Rg))]
        assert max(rot) < 5e-3
        assert float(got.cost_inertial) < 10.0


def _centres(R, t):
    return -np.einsum("kji,kj->ki", np.asarray(R), np.asarray(t))


def _f64(x):
    """A problem field (array, tuple of arrays or None) in float64."""
    if x is None:
        return None
    if isinstance(x, tuple):
        return type(x)(*(_f64(y) for y in x))
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    a = np.asarray(x)
    return jnp.asarray(a.astype(np.float64) if a.dtype == np.float32 else a)


@pytest.mark.parametrize("seed,schedule,window", [(0, (2, 10), False), (2, (1, 5), True)])
def test_vi_bundle_adjust_matches_reference_in_float64(seed, schedule, window):
    """The cases above with both packages in float64 (the reference under
    jax.enable_x64), where rounding no longer hides a difference of
    method: centres within 1e-6 m, rotations within 5e-8, points within
    3e-6 m, velocities within 2e-6 m/s, gyro biases within 6e-8 and
    accelerometer biases within 8e-6 of the reference's (~10x the gaps
    measured on these problems, which are the central difference's
    truncation against jax.jacfwd), the same inliers. Each limit is at
    least 30x below the reference's own move from its start, so a no-op
    or a wrong inertial block fails it."""
    prob, _, _, _, _ = _make_problem(seed=seed)
    if window:
        prob = prob._replace(state_fixed=prob.cam_fixed)
    with jax.enable_x64(True):
        jprob = type(prob)(*(_f64(x) for x in prob))
        want = JB.vi_bundle_adjust(jprob, BA_CAM, *schedule)
        assert want.points.dtype == jnp.float64
        want = type(want)(*(np.asarray(x) if not isinstance(x, tuple) else
                            type(x)(*(np.asarray(y) for y in x)) for x in want))
    pprob = _port_problem(prob)
    got = PB.vi_bundle_adjust(type(pprob)(*(_f64(x) for x in pprob)),
                              convert.camera(BA_CAM, "cpu"), *schedule)
    assert got.points.dtype == torch.float64
    limits = {"centres": 1e-6, "R": 5e-8, "points": 3e-6, "v_w": 2e-6, "bg": 6e-8, "ba": 8e-6}
    start = {"centres": _centres(prob.T_cw.R, prob.T_cw.t), "R": np.asarray(prob.T_cw.R),
             "points": np.asarray(prob.points), "v_w": np.asarray(prob.v_w),
             "bg": np.asarray(prob.bg), "ba": np.asarray(prob.ba)}
    w = {"centres": _centres(want.T_cw.R, want.T_cw.t), "R": want.T_cw.R, "points": want.points,
         "v_w": want.v_w, "bg": want.bg, "ba": want.ba}
    g = {"centres": _centres(got.T_cw.R.numpy(), got.T_cw.t.numpy()), "R": got.T_cw.R.numpy(),
         "points": got.points.numpy(), "v_w": got.v_w.numpy(), "bg": got.bg.numpy(),
         "ba": got.ba.numpy()}
    for f, lim in limits.items():
        np.testing.assert_allclose(g[f], w[f], rtol=0, atol=lim, err_msg=f)
        assert np.abs(w[f] - start[f]).max() > 30 * lim, f
    np.testing.assert_array_equal(got.obs_inlier.numpy(), want.obs_inlier)


@pytest.mark.parametrize("seed", [0, 2])
def test_vi_bundle_adjust_stereo_rows_are_the_visual_bas(seed):
    """On a stereo or RGB-D map the port's VI BA carries the (u, v, uR) rows
    of optim/ba.py, which the reference's VI BA leaves out (ROADMAP Queue
    3). Held against the port's stereo visual BA (itself held against the
    reference's stereo BA by tests/test_torch_stereo.py) on the same
    observations, half of them with a right-image u (0.3 px noise): with no
    inertial edge the VI BA must land where bundle_adjust lands, centres
    within 2e-4 m, rotations within 2e-5, points within 1e-3 m, the same
    inliers; velocities and biases untouched. Without the uR rows it lands
    elsewhere (points >= 1e-2 m away), so the rows are what the limits see."""
    from orb_slam3_modified_tpu_torch.optim import ba as PBA

    prob, R_gt, t_gt, _, pts_gt = _make_problem(seed=seed)
    pp = _port_problem(prob)
    oc, op = pp.obs_cam.numpy(), pp.obs_pt.numpy()
    z_true = (np.einsum("oij,oj->oi", R_gt[oc], pts_gt[op]) + t_gt[oc])[:, 2]
    bf = np.float32(0.110074137800478 * 458.654)  # configs/euroc_stereo.yaml
    rng = np.random.default_rng(100 + seed)
    ur = pp.obs_uv.numpy()[:, 0] - bf / z_true + rng.normal(0, 0.3, len(oc))
    ur[::2] = -1.0  # every other observation monocular
    ur, bf = torch.from_numpy(ur.astype(np.float32)), torch.tensor(bf)
    cam = convert.camera(BA_CAM, "cpu")

    def no_edges(a):
        return a[:0]

    mono = pp._replace(chain=InertialChain(*(no_edges(x) for x in pp.chain)),
                       **{f: no_edges(getattr(pp, f)) for f in (
                           "edge_i", "edge_j", "bg_lin", "ba_lin", "rw_info_g", "rw_info_a")})
    got = PB.vi_bundle_adjust(mono._replace(obs_ur=ur, bf=bf), cam, 2, 8)
    want = PBA.bundle_adjust(PBA.BAProblem(pp.T_cw, pp.cam_fixed, pp.points, pp.pt_valid,
                                           pp.obs_cam, pp.obs_pt, pp.obs_uv, pp.obs_inv_s2,
                                           pp.obs_valid, ur, bf), cam, 2, 8)
    c_w = _centres(want.T_cw.R.numpy(), want.T_cw.t.numpy())
    np.testing.assert_allclose(_centres(got.T_cw.R.numpy(), got.T_cw.t.numpy()), c_w, atol=2e-4)
    np.testing.assert_allclose(got.T_cw.R.numpy(), want.T_cw.R.numpy(), atol=2e-5)
    np.testing.assert_allclose(got.points.numpy(), want.points.numpy(), atol=1e-3)
    np.testing.assert_array_equal(got.obs_inlier.numpy(), want.obs_inlier.numpy())
    assert torch.equal(got.v_w, mono.v_w) and not got.bg.any() and not got.ba.any()
    without = PB.vi_bundle_adjust(mono, cam, 2, 8)
    assert (without.points - want.points).abs().max() > 1e-2


def _chain_map(jax_pkg, n_kf=8, seed=0):
    """A map of n_kf keyframes on circle_sim's trajectory looking up at a
    point cloud, every point observed where it projects (level 0), slot
    order by point; the package's own MapState."""
    from test_inertial import circle_sim

    if jax_pkg:
        from orb_slam3_modified_tpu.slam_map.map_state import MapState
    else:
        from orb_slam3_modified_tpu_torch.slam_map.map_state import MapState
    from orb_slam3_modified_tpu.cameras import project_np

    rng = np.random.default_rng(seed)
    kf_states, pres = circle_sim(n_kf=n_kf)
    P = 200
    pts = rng.normal(0, 1.5, (P, 3)).astype(np.float32)
    pts[:, 2] = 5.0 + rng.normal(0, 1.0, P)
    m = MapState.create(32, 1024, 256)
    mp = m.alloc_points(P)
    m.mp_pos[mp] = pts + rng.normal(0, 0.01, pts.shape).astype(np.float32)
    kfs = []
    for i, (R_wb, p_wb, v, _) in enumerate(kf_states):
        k = m.alloc_keyframe()
        R_cw = R_wb.T.astype(np.float32)
        t_cw = (-R_wb.T @ p_wb).astype(np.float32)
        m.kf_R[k] = R_cw
        m.kf_t[k] = t_cw + rng.normal(0, 0.01, 3).astype(np.float32) * (i > 0)
        m.kf_ts[k] = 0.5 * i
        m.kf_frame_id[k] = 10 * i
        m.kf_vel[k] = v.astype(np.float32)
        pc = pts @ R_cw.T + t_cw
        uv = project_np(BA_CAM, pc)
        ok = np.flatnonzero((pc[:, 2] > 0.3) & (uv[:, 0] > 5) & (uv[:, 0] < 747)
                            & (uv[:, 1] > 5) & (uv[:, 1] < 475))[:256]
        m.kf_uv[k, :len(ok)] = uv[ok] + rng.normal(0, 0.3, (len(ok), 2))
        m.kf_level[k] = 0
        m.kf_feat_valid[k, :len(ok)] = True
        m.kf_obs[k, :len(ok)] = mp[ok]
        kfs.append(k)
    m.mp_first_kf[mp] = kfs[0]
    return m, kfs, pres


def test_build_solve_write_back_matches_reference():
    """build_vi_problem + vi_bundle_adjust + write_back_vi on the same map in
    both packages (VIBA1's priors, the newest keyframe fixed): the same
    problem to the bit, the written map within the BA tolerances above."""
    from orb_slam3_modified_tpu.tracking.imu_frontend import ImuConfig as JImuConfig
    from orb_slam3_modified_tpu.tracking.tracker import TrackerConfig as JTC
    from orb_slam3_modified_tpu_torch.tracking.tracker import TrackerConfig as PTC

    jm, kfs, pres = _chain_map(True)
    pm, _, _ = _chain_map(False)
    jcfg = JImuConfig()
    jcfg.R_bc, jcfg.t_bc = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    fixed = np.zeros(len(kfs), bool)
    fixed[-1] = True
    jp, jk, jsel = JB.build_vi_problem(jm, JTC(cam=BA_CAM), kfs, pres[:len(kfs) - 1], fixed, 1.0,
                                       1e5, jcfg, state_fixed=np.zeros(len(kfs), bool))
    pp, pk, psel = PB.build_vi_problem(pm, PTC(cam=convert.camera(BA_CAM, "cpu")), kfs,
                                       [convert.preintegrated(p, "cpu") for p in pres], fixed, 1.0,
                                       1e5, convert.imu_config(jcfg),
                                       state_fixed=np.zeros(len(kfs), bool))
    np.testing.assert_array_equal(psel, jsel)
    for f in ("cam_fixed", "points", "obs_cam", "obs_pt", "obs_uv", "obs_inv_s2", "obs_valid",
              "v_w", "bg", "ba", "edge_i", "edge_j", "rw_info_g", "rw_info_a", "state_fixed"):
        np.testing.assert_array_equal(np.asarray(getattr(pp, f)), np.asarray(getattr(jp, f)), f)
    for f in InertialChain._fields:
        np.testing.assert_array_equal(np.asarray(getattr(pp.chain, f)),
                                      np.asarray(getattr(jp.chain, f)), f)
    JB.write_back_vi(jm, JB.vi_bundle_adjust(jp, BA_CAM, 2, 10), jk, jsel)
    res = PB.vi_bundle_adjust(PB.to_device(pp, "cpu"), convert.camera(BA_CAM, "cpu"), 2, 10)
    PB.write_back_vi(pm, convert_result(res), pk, psel)
    c = lambda m: -np.einsum("kji,kj->ki", m.kf_R[kfs], m.kf_t[kfs])  # noqa: E731
    np.testing.assert_allclose(c(pm), c(jm), atol=5e-3, rtol=1e-3)
    np.testing.assert_allclose(pm.kf_vel[kfs], jm.kf_vel[kfs], atol=5e-3)
    np.testing.assert_allclose(pm.kf_bias[kfs], jm.kf_bias[kfs], atol=2e-3)
    np.testing.assert_allclose(pm.mp_pos[psel], jm.mp_pos[jsel], atol=1e-2, rtol=1e-3)


def convert_result(res):
    """A port VIBAResult of tensors -> host arrays (write_back_vi's input)."""
    from orb_slam3_modified_tpu_torch.utils.fetch import fetch

    return fetch(res)


def test_commit_propagates_like_the_reference():
    """slam_map/commit.py: a solve written back, a keyframe and a point
    created during it corrected through the parent chain, exactly as the
    reference's commit does (host float64 / float32 arithmetic in both)."""
    from orb_slam3_modified_tpu.slam_map.commit import commit_whole_map_solve as jcommit
    from orb_slam3_modified_tpu_torch.slam_map.commit import commit_whole_map_solve as pcommit

    out = []
    for jax_pkg, commit in ((True, jcommit), (False, pcommit)):
        m, kfs, _ = _chain_map(jax_pkg)
        kfs = np.asarray(kfs[:5])
        fid = m.kf_frame_id[kfs].copy()
        mps = np.flatnonzero(m.mp_valid)[:150]
        pre_R, pre_t = m.kf_R[kfs].copy(), m.kf_t[kfs].copy()
        rng = np.random.default_rng(1)
        R_opt = pre_R.copy()
        t_opt = pre_t + rng.normal(0, 0.05, pre_t.shape).astype(np.float32)
        pts_opt = m.mp_pos[mps] + 0.01
        m.kf_parent[kfs[1:]] = kfs[:-1]
        late = np.flatnonzero(m.kf_valid)[5]  # created "during the solve"
        m.kf_parent[late] = kfs[2]
        m.remove_keyframe(int(kfs[4]))  # culled during the solve
        late_pt = np.flatnonzero(m.mp_valid)[150]
        m.mp_first_kf[late_pt] = kfs[1]
        commit(m, kfs, fid, mps, R_opt, t_opt, pts_opt, pre_R, pre_t)
        out.append((m.kf_R.copy(), m.kf_t.copy(), m.mp_pos.copy()))
    for a, b in zip(*out):
        np.testing.assert_array_equal(b, a)
