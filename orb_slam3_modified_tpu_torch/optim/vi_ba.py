"""Joint visual-inertial bundle adjustment: poses, velocities, per-keyframe
biases and points.

Port of orb_slam3_modified_tpu/optim/vi_ba.py, the one solver behind
Optimizer::FullInertialBA (src/Optimizer.cc:392-560: the staged IMU init's
VIBA and the post-loop inertial global BA), LocalInertialBA (:2383, the
local mapper's temporal window) and MergeInertialBA (:3948, the weld).

- State x = [xi_pose (6K) | dv (3K) | dbg (3K) | dba (3K)]; the pose
  increments act on the left of the camera pose T_cw, the body states
  follow through the fixed extrinsics T_bc.
- Visual block: optim/ba.py's residuals and its dense Schur reduction of the
  point blocks (optim/ba.py::_schur_reduce), which touches the (6K, 6K)
  camera corner only. On a stereo or RGB-D map (tcfg.bf > 0) the
  observations carry their (u, v, uR) rows, as the port's visual BA and
  ORB-SLAM3's inertial BAs (EdgeStereo in LocalInertialBA / FullInertialBA)
  do; the reference package's VI BA keeps the (u, v) rows only, which
  leaves the metric scale of a stereo-inertial map to the IMU alone.
- Inertial block: a 15-D whitened residual per chain edge (9 preintegration
  + 6 bias random walk) as a function of the edge's 30 increments. The
  reference takes its (E, 15, 30) jacobian with vmap(jacfwd); here all
  edges and all 60 perturbations go through one batched float64 evaluation
  (optim/jacobian.py's central difference, over the edge axis too), and the
  (30, 30) blocks are summed into the (15K, 15K) system with
  index_put_(accumulate=True), which sorts its indices on the card, so a
  run repeats to the bit.
- LM with the reference's rounds, iterations, cost gate on the full
  objective (visual + inertial + bias priors) and visual outlier
  reclassification between rounds; accept / reject as torch.where, so a
  solve reads nothing back. The mixed system is Jacobi-preconditioned
  before its solve, as in the reference.

build_vi_problem pads the keyframes to a multiple of 8, the points and
observations to power-of-two buckets (host numpy), so the shapes on the
card stay few.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cameras import Camera
from ..imu.preintegration import gravity_vec
from ..lie import se3, so3
from ..lie.se3 import SE3, SE3np
from .ba import BAProblem, _obs_residuals, _schur_reduce
from .inertial import InertialChain
from .jacobian import FD_STEP
from .robust import CHI2_MONO, CHI2_STEREO, DELTA_MONO, DELTA_STEREO, huber_weight


class VIBAProblem(NamedTuple):
    # the visual part, laid out as optim.ba.BAProblem
    T_cw: SE3  # (K,)
    cam_fixed: torch.Tensor  # (K,) bool: pose pinned (gauge / frontier)
    points: torch.Tensor  # (P, 3)
    pt_valid: torch.Tensor  # (P,)
    obs_cam: torch.Tensor  # (O,)
    obs_pt: torch.Tensor  # (O,)
    obs_uv: torch.Tensor  # (O, 2)
    obs_inv_s2: torch.Tensor  # (O,)
    obs_valid: torch.Tensor  # (O,)
    # inertial states at linearization
    v_w: torch.Tensor  # (K, 3) body velocity in world
    bg: torch.Tensor  # (K, 3) gyro bias
    ba: torch.Tensor  # (K, 3) acc bias
    # preintegration edges along the chain
    chain: InertialChain
    edge_i: torch.Tensor  # (E,) source keyframe (window index)
    edge_j: torch.Tensor  # (E,) target keyframe
    bg_lin: torch.Tensor  # (E, 3) bias the deltas were integrated at
    ba_lin: torch.Tensor  # (E, 3)
    rw_info_g: torch.Tensor  # (E,) 1 / (walk_g^2 dt) random-walk information
    rw_info_a: torch.Tensor  # (E,)
    # bias priors on the FIRST keyframe (EdgePriorGyro / Acc)
    prior_g: torch.Tensor  # ()
    prior_a: torch.Tensor  # ()
    R_bc: torch.Tensor  # (3, 3) camera-to-body rotation
    t_bc: torch.Tensor  # (3,)
    # velocity + bias pinning, independent of the pose gauge: the window
    # solvers pin the frontier's whole state, the init's FullInertialBA
    # leaves velocities and biases free
    state_fixed: torch.Tensor = None  # (K,) bool
    # rectified-stereo / RGB-D observations: right-image u (< 0 monocular)
    # and baseline * fx, the (u, v, uR) rows of optim/ba.py
    obs_ur: torch.Tensor = None  # (O,)
    bf: torch.Tensor = None  # ()


class VIBAResult(NamedTuple):
    T_cw: SE3
    points: torch.Tensor
    v_w: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    obs_inlier: torch.Tensor
    chi2_vis: torch.Tensor  # (O,)
    cost_inertial: torch.Tensor  # ()


def to_device(prob: VIBAProblem, device) -> VIBAProblem:
    """Upload a numpy-built problem (one pinned non-blocking copy per field);
    indices become int64."""
    from ..utils.fetch import upload

    def up(a, dtype=np.float32):
        return upload(np.asarray(a).astype(dtype), device)

    ch = prob.chain
    chain = InertialChain(*(up(getattr(ch, f), bool if f == "valid" else np.float32)
                            for f in InertialChain._fields))
    return VIBAProblem(
        T_cw=SE3(up(prob.T_cw.R), up(prob.T_cw.t)), cam_fixed=up(prob.cam_fixed, bool),
        points=up(prob.points), pt_valid=up(prob.pt_valid, bool),
        obs_cam=up(prob.obs_cam, np.int64), obs_pt=up(prob.obs_pt, np.int64),
        obs_uv=up(prob.obs_uv), obs_inv_s2=up(prob.obs_inv_s2), obs_valid=up(prob.obs_valid, bool),
        v_w=up(prob.v_w), bg=up(prob.bg), ba=up(prob.ba), chain=chain,
        edge_i=up(prob.edge_i, np.int64), edge_j=up(prob.edge_j, np.int64),
        bg_lin=up(prob.bg_lin), ba_lin=up(prob.ba_lin), rw_info_g=up(prob.rw_info_g),
        rw_info_a=up(prob.rw_info_a), prior_g=up(prob.prior_g).reshape(()),
        prior_a=up(prob.prior_a).reshape(()), R_bc=up(prob.R_bc), t_bc=up(prob.t_bc),
        state_fixed=None if prob.state_fixed is None else up(prob.state_fixed, bool),
        obs_ur=None if prob.obs_ur is None else up(prob.obs_ur),
        bf=None if prob.bf is None else up(prob.bf).reshape(()),
    )


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _edge_consts(prob: VIBAProblem, dtype):
    """The per-edge constants of _edge_residual, cast to dtype, and the
    edge whitening L (E, 9, 9) with C_inv = L L^T."""
    ch = prob.chain
    L = torch.linalg.cholesky_ex(0.5 * (ch.C_inv + ch.C_inv.transpose(-1, -2)))[0]
    names = (ch.dT, ch.dR, ch.dV, ch.dP, ch.JRg, ch.JVg, ch.JVa, ch.JPg, ch.JPa, L, prob.bg_lin,
             prob.ba_lin, torch.sqrt(prob.rw_info_g), torch.sqrt(prob.rw_info_a), prob.R_bc,
             prob.t_bc)
    return tuple(a.to(dtype) for a in names)


def _edge_residual(prob: VIBAProblem, consts, z, Rk, tk, v, bg, ba):
    """(B, E, 15) whitened residuals of every edge at the increments z
    (B, E, 30) = [xi_i, xi_j, dv_i, dv_j, dbg_i, dba_i, dbg_j, dba_j]
    (EdgeInertial::computeError, src/G2oTypes.cc:600 region, then
    EdgeGyroRW / EdgeAccRW); invalid (padded) edges are zero."""
    dT, dR, dV, dP, JRg, JVg, JVa, JPg, JPa, L, bg_lin, ba_lin, sq_g, sq_a, R_bc, t_bc = consts
    dt_ = z.dtype
    i, j = prob.edge_i, prob.edge_j

    def body_state(kf, xi):
        T = se3.exp(xi) @ SE3(Rk[kf].to(dt_), tk[kf].to(dt_))  # camera pose, incremented
        R_bw = R_bc @ T.R
        t_bw = _mv(R_bc, T.t) + t_bc
        R_wb = R_bw.transpose(-1, -2)
        return R_wb, -_mv(R_wb, t_bw)

    R_i, p_i = body_state(i, z[..., 0:6])
    R_j, p_j = body_state(j, z[..., 6:12])
    v_i = v[i].to(dt_) + z[..., 12:15]
    v_j = v[j].to(dt_) + z[..., 15:18]
    bg_i = bg[i].to(dt_) + z[..., 18:21]
    ba_i = ba[i].to(dt_) + z[..., 21:24]
    bg_j = bg[j].to(dt_) + z[..., 24:27]
    ba_j = ba[j].to(dt_) + z[..., 27:30]
    db_g = bg_i - bg_lin
    db_a = ba_i - ba_lin
    g = gravity_vec(z)
    dt = dT[:, None]
    dR_c = dR @ so3.exp(_mv(JRg, db_g))
    dV_c = dV + _mv(JVg, db_g) + _mv(JVa, db_a)
    dP_c = dP + _mv(JPg, db_g) + _mv(JPa, db_a)
    RiT = R_i.transpose(-1, -2)
    r_R = so3.log(dR_c.transpose(-1, -2) @ RiT @ R_j)
    r_v = _mv(RiT, v_j - v_i - g * dt) - dV_c
    r_p = _mv(RiT, p_j - p_i - v_i * dt - 0.5 * g * dt * dt) - dP_c
    r9w = _mv(L.transpose(-1, -2), torch.cat([r_R, r_v, r_p], dim=-1))
    r = torch.cat([r9w, (bg_j - bg_i) * sq_g[:, None], (ba_j - ba_i) * sq_a[:, None]], dim=-1)
    return torch.where(prob.chain.valid[:, None], r, 0.0)


def _edge_cols(prob: VIBAProblem, K):
    """(E, 30) global column of each edge's 30 local increments."""
    i, j = prob.edge_i[:, None], prob.edge_j[:, None]
    a6 = torch.arange(6, device=i.device)
    a3 = torch.arange(3, device=i.device)
    return torch.cat([6 * i + a6, 6 * j + a6, 6 * K + 3 * i + a3, 6 * K + 3 * j + a3,
                      9 * K + 3 * i + a3, 12 * K + 3 * i + a3, 9 * K + 3 * j + a3,
                      12 * K + 3 * j + a3], dim=1)


def _edge_system(prob: VIBAProblem, c64, cols, Rk, tk, v, bg, ba, n_x):
    """The inertial contribution (H_in (n_x, n_x), b_in (n_x,), cost) of
    every edge: the residuals and their (E, 15, 30) jacobian by one batched
    float64 evaluation (the value and the central difference)."""
    E = prob.edge_i.shape[0]
    dt_, dev = tk.dtype, tk.device
    step = torch.eye(30, dtype=torch.float64, device=dev) * FD_STEP
    Z = torch.cat([torch.zeros_like(step[:1]), step, -step])[:, None, :].expand(61, E, 30)
    R = _edge_residual(prob, c64, Z, Rk, tk, v, bg, ba)  # (61, E, 15): the value, then +-h
    r = R[0].to(dt_)
    J = ((R[1:31] - R[31:]) / (2.0 * FD_STEP)).permute(1, 2, 0).to(dt_)  # (E, 15, 30)
    H = torch.zeros((n_x, n_x), dtype=dt_, device=dev)
    H.index_put_((cols[:, :, None].expand(E, 30, 30), cols[:, None, :].expand(E, 30, 30)),
                 J.transpose(1, 2) @ J, accumulate=True)
    b = torch.zeros(n_x, dtype=dt_, device=dev)
    b.index_put_((cols,), _mv(J.transpose(1, 2), r), accumulate=True)
    return H, b, torch.sum(r * r)


def _inertial_cost(prob, c32, Rk, tk, v, bg, ba):
    E = prob.edge_i.shape[0]
    z0 = torch.zeros((1, E, 30), dtype=tk.dtype, device=tk.device)
    r = _edge_residual(prob, c32, z0, Rk, tk, v, bg, ba)
    return torch.sum(r * r)


def _jacobi_solve(H, b):
    """-H^-1 b with H scaled to a unit diagonal first (the whitened inertial
    blocks span ~4 orders of magnitude)."""
    d_inv = torch.rsqrt(torch.clamp(torch.diagonal(H), min=1e-12))
    return -torch.linalg.solve_ex(H * d_inv[:, None] * d_inv[None, :], b * d_inv)[0] * d_inv


def _reseed_velocities(prob, c64, cols, Rk, tk, v, bg, ba, n_x, K, fixed):
    """The exact minimizer over the velocities with everything else held
    (the preintegration residuals are linear in v): starting the joint LM
    there keeps it out of the monocular scale-warp valley (the reference
    seeds velocities from InertialOptimization, src/LocalMapping.cc:1272)."""
    H_in, b_in, _ = _edge_system(prob, c64, cols, Rk, tk, v, bg, ba, n_x)
    Hv = H_in[6 * K:9 * K, 6 * K:9 * K]
    bv = b_in[6 * K:9 * K]
    fixed_v = torch.repeat_interleave(fixed, 3)
    Hv = torch.where(fixed_v[:, None] | fixed_v[None, :], 0.0, Hv)
    Hv = Hv + torch.diag(torch.where(fixed_v, 1.0, 1e-6))
    bv = torch.where(fixed_v, 0.0, bv)
    return v + _jacobi_solve(Hv, bv).reshape(K, 3)


def vi_bundle_adjust(prob: VIBAProblem, cam: Camera, rounds: int = 2,
                     iters_per_round: int = 8) -> VIBAResult:
    """Joint VI BA on a problem whose fields are tensors on one device
    (to_device): `rounds` rounds of `iters_per_round` LM iterations, Huber
    on the visual rows in every round but the last, visual observations
    with chi2 > 5.991 dropped between rounds."""
    K = prob.T_cw.t.shape[0]
    P = prob.points.shape[0]
    n_x = 15 * K
    dt_, dev = prob.points.dtype, prob.points.device
    vis = BAProblem(prob.T_cw, prob.cam_fixed, prob.points, prob.pt_valid, prob.obs_cam,
                    prob.obs_pt, prob.obs_uv, prob.obs_inv_s2, prob.obs_valid, prob.obs_ur, prob.bf)
    if prob.obs_ur is None:
        rmask = torch.ones((prob.obs_cam.shape[0], 2), dtype=dt_, device=dev)
        chi2_thr, delta = CHI2_MONO, DELTA_MONO
    else:  # the uR row exists for the stereo observations only
        stereo = prob.obs_ur >= 0
        rmask = torch.stack([torch.ones_like(prob.obs_ur), torch.ones_like(prob.obs_ur),
                             stereo.to(dt_)], dim=-1)
        chi2_thr = torch.where(stereo, CHI2_STEREO, CHI2_MONO)
        delta = torch.where(stereo, DELTA_STEREO, DELTA_MONO)
    state_fixed = prob.state_fixed if prob.state_fixed is not None else prob.cam_fixed
    fixed15 = torch.cat([torch.repeat_interleave(prob.cam_fixed, 6)]
                        + [torch.repeat_interleave(state_fixed, 3)] * 3)
    c32 = _edge_consts(prob, dt_)
    c64 = tuple(a.to(torch.float64) for a in c32)
    cols = _edge_cols(prob, K)
    obs_w = prob.obs_valid.to(dt_) * prob.pt_valid[prob.obs_pt].to(dt_)
    eye3 = torch.eye(3, dtype=dt_, device=dev)
    ar3 = torch.arange(3, device=dev)

    def chi2_vis_of(Rk, tk, pts):
        r, _, _, pc = _obs_residuals(vis, cam, Rk, tk, pts)
        c = torch.sum(r * r * rmask, dim=-1) * prob.obs_inv_s2
        return torch.where(pc[..., 2] > 0, c, torch.inf)

    def prior_terms(bg, ba):
        # the bias prior sits on keyframe 0
        return prob.prior_g * torch.sum(bg[0] ** 2) + prob.prior_a * torch.sum(ba[0] ** 2)

    Rk, tk, pts = prob.T_cw.R, prob.T_cw.t, prob.points
    bg, ba = prob.bg, prob.ba
    v = _reseed_velocities(prob, c64, cols, Rk, tk, prob.v_w, bg, ba, n_x, K, state_fixed)
    inlier = prob.obs_valid
    for round_idx in range(rounds):
        use_huber = round_idx < rounds - 1
        lam = torch.full((), 1e-4, dtype=dt_, device=dev)
        for _ in range(iters_per_round):
            r, Jpose, Jpt, pc = _obs_residuals(vis, cam, Rk, tk, pts)
            chi2 = torch.sum(r * r * rmask, dim=-1) * prob.obs_inv_s2
            w = inlier.to(dt_) * obs_w
            if use_huber:
                w = w * huber_weight(chi2, delta)
            w = torch.where(pc[..., 2] > 0, w * prob.obs_inv_s2, 0.0)
            S_pose, b_pose, H_pp_inv, W, b_p = _schur_reduce(vis, K, P, w[:, None] * rmask, r,
                                                             Jpose, Jpt, lam)
            # the inertial + random-walk system over the whole 15K state
            H, b, c_inert = _edge_system(prob, c64, cols, Rk, tk, v, bg, ba, n_x)
            H[:6 * K, :6 * K] += S_pose
            b[:6 * K] += b_pose
            # bias priors on keyframe 0
            H[9 * K + ar3, 9 * K + ar3] += prob.prior_g
            H[12 * K + ar3, 12 * K + ar3] += prob.prior_a
            b[9 * K:9 * K + 3] += prob.prior_g * bg[0]
            b[12 * K:12 * K + 3] += prob.prior_a * ba[0]
            # damping, pinning, Jacobi-preconditioned solve
            H = H + torch.diag(lam * torch.diagonal(H) + 1e-8)
            H = torch.where(fixed15[:, None] | fixed15[None, :], 0.0, H)
            H = H + torch.diag(fixed15.to(dt_))
            b = torch.where(fixed15, 0.0, b)
            dx = _jacobi_solve(H, b)
            dx_pose = dx[:6 * K].reshape(K, 6)
            dx_pt = -(H_pp_inv @ (b_p + torch.einsum("pac,a->pc", W, dx[:6 * K]))[..., None])[
                ..., 0]
            T_new = se3.exp(dx_pose) @ SE3(Rk, tk)
            pts_new = pts + dx_pt
            v_new = v + dx[6 * K:9 * K].reshape(K, 3)
            bg_new = bg + dx[9 * K:12 * K].reshape(K, 3)
            ba_new = ba + dx[12 * K:].reshape(K, 3)
            # cost gate on the FULL objective
            c_old = (torch.sum(torch.where(torch.isfinite(chi2), w * chi2, 0.0))
                     + c_inert + prior_terms(bg, ba))
            r2, _, _, pc2 = _obs_residuals(vis, cam, T_new.R, T_new.t, pts_new)
            chi2n = torch.sum(r2 * r2 * rmask, dim=-1) * prob.obs_inv_s2
            c_new = (torch.sum(torch.where(pc2[..., 2] > 0, w * chi2n, w * chi2))
                     + _inertial_cost(prob, c32, T_new.R, T_new.t, v_new, bg_new, ba_new)
                     + prior_terms(bg_new, ba_new))
            good = c_new < c_old
            Rk = torch.where(good, T_new.R, Rk)
            tk = torch.where(good, T_new.t, tk)
            pts = torch.where(good, pts_new, pts)
            v = torch.where(good, v_new, v)
            bg = torch.where(good, bg_new, bg)
            ba = torch.where(good, ba_new, ba)
            lam = torch.where(good, lam * 0.5, lam * 5.0)
        inlier = prob.obs_valid & (chi2_vis_of(Rk, tk, pts) < chi2_thr)
    Rk = so3.normalize(Rk)
    return VIBAResult(SE3(Rk, tk), pts, v, bg, ba, inlier, chi2_vis_of(Rk, tk, pts),
                      _inertial_cost(prob, c32, Rk, tk, v, bg, ba))


def _next_bucket(n, base):
    b = base
    while b < n:
        b *= 2
    return b


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def build_vi_problem(m, tcfg, kfs, pres, fixed, prior_g: float, prior_a: float, imu_cfg,
                     kf_pad: int = 8, obs_bucket: int = 4096, pt_bucket: int = 2048,
                     state_fixed=None):
    """A padded VIBAProblem of numpy arrays from the map.

    kfs: the temporal list of keyframe slots (K0); pres: the Preintegrated
    between consecutive entries (K0 - 1, host or device tensors); fixed:
    (K0,) pose anchors. The keyframes pad to a multiple of kf_pad, the
    observations and points to power-of-two buckets. Returns (problem, kfs,
    mp_sel) for write_back_vi."""
    K0 = len(kfs)
    E0 = len(pres)
    assert E0 == K0 - 1
    K = int(np.ceil(K0 / kf_pad) * kf_pad)
    inv_s2_levels = tcfg.inv_level_sigma2()
    # the valid points the window sees
    obs = m.kf_obs[kfs]
    mp_sel = np.unique(obs[obs != -1])
    mp_sel = mp_sel[(mp_sel >= 0) & m.mp_valid[mp_sel]][:pt_bucket]
    P = _next_bucket(max(len(mp_sel), 1), 256)
    mp_pos_map = np.full(m.mp_valid.shape[0], -1, np.int64)
    mp_pos_map[mp_sel] = np.arange(len(mp_sel))
    pts = np.zeros((P, 3), np.float32)
    pts[:len(mp_sel)] = m.mp_pos[mp_sel]
    pt_valid = np.zeros(P, bool)
    pt_valid[:len(mp_sel)] = True
    stereo = tcfg.bf > 0
    obs_cam, obs_pt, obs_uv, obs_is2, obs_ur = [], [], [], [], []
    for i, k in enumerate(kfs):
        slots, mps = m.observations_of_kf(int(k))
        sel = mp_pos_map[mps] >= 0
        slots, mps = slots[sel], mps[sel]
        obs_cam.append(np.full(len(slots), i, np.int32))
        obs_pt.append(mp_pos_map[mps].astype(np.int32))
        obs_uv.append(m.kf_uv[int(k), slots])
        obs_is2.append(inv_s2_levels[m.kf_level[int(k), slots]])
        if stereo:
            obs_ur.append(m.kf_ur[int(k), slots])
    obs_cam = np.concatenate(obs_cam)
    O = _next_bucket(max(len(obs_cam), 1), obs_bucket)

    def pad(a, n, fill=0):
        out = np.full((n, *a.shape[1:]), fill, a.dtype)
        out[:len(a)] = a[:n]
        return out

    obs_valid = np.zeros(O, bool)
    obs_valid[:len(obs_cam)] = True
    # keyframe states (padded: identity pose, fixed)
    R = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t = np.zeros((K, 3), np.float32)
    vel = np.zeros((K, 3), np.float32)
    bias = np.zeros((K, 6), np.float32)
    fixed_k = np.ones(K, bool)
    R[:K0] = m.kf_R[kfs]
    t[:K0] = m.kf_t[kfs]
    vel[:K0] = m.kf_vel[kfs]
    bias[:K0] = m.kf_bias[kfs]
    fixed_k[:K0] = np.asarray(fixed, bool)
    # inertial edges (padded: invalid, a self-loop on keyframe 0)
    E = K - 1

    def stack_pre(f, shape):
        out = np.zeros((E, *shape), np.float32)
        for e, p in enumerate(pres):
            out[e] = _host(f(p))
        return out

    dT = stack_pre(lambda p: p.dT, ())
    dR = stack_pre(lambda p: p.dR, (3, 3))
    dR[E0:] = np.eye(3, dtype=np.float32)
    chain = InertialChain(
        dT=np.maximum(dT, 1e-6), dR=dR,
        dV=stack_pre(lambda p: p.dV, (3,)), dP=stack_pre(lambda p: p.dP, (3,)),
        JRg=stack_pre(lambda p: p.JRg, (3, 3)), JVg=stack_pre(lambda p: p.JVg, (3, 3)),
        JVa=stack_pre(lambda p: p.JVa, (3, 3)), JPg=stack_pre(lambda p: p.JPg, (3, 3)),
        JPa=stack_pre(lambda p: p.JPa, (3, 3)),
        C_inv=_chain_informations(pres, E), valid=np.arange(E) < E0,
    )
    edge_i = np.arange(E, dtype=np.int32)
    edge_j = np.arange(1, E + 1, dtype=np.int32)
    edge_i[E0:] = 0
    edge_j[E0:] = 0
    bg_lin = np.zeros((E, 3), np.float32)
    ba_lin = np.zeros((E, 3), np.float32)
    for e, p in enumerate(pres):
        bg_lin[e] = _host(p.bias.bg)
        ba_lin[e] = _host(p.bias.ba)
    dts = np.maximum(dT, 1e-3)
    rw_g = 1.0 / (imu_cfg.walk_gyro ** 2 * dts)
    rw_a = 1.0 / (imu_cfg.walk_acc ** 2 * dts)
    rw_g[E0:] = 0.0
    rw_a[E0:] = 0.0
    prob = VIBAProblem(
        T_cw=SE3np(R, t), cam_fixed=fixed_k, points=pts, pt_valid=pt_valid,
        obs_cam=pad(obs_cam, O), obs_pt=pad(np.concatenate(obs_pt), O),
        obs_uv=pad(np.concatenate(obs_uv).astype(np.float32), O),
        obs_inv_s2=pad(np.concatenate(obs_is2).astype(np.float32), O, 1.0), obs_valid=obs_valid,
        v_w=vel, bg=np.ascontiguousarray(bias[:, :3]), ba=np.ascontiguousarray(bias[:, 3:]),
        chain=chain, edge_i=edge_i, edge_j=edge_j, bg_lin=bg_lin, ba_lin=ba_lin,
        rw_info_g=rw_g.astype(np.float32), rw_info_a=rw_a.astype(np.float32),
        prior_g=np.float32(prior_g), prior_a=np.float32(prior_a),
        R_bc=np.asarray(imu_cfg.R_bc, np.float32), t_bc=np.asarray(imu_cfg.t_bc, np.float32),
        state_fixed=(fixed_k if state_fixed is None
                     else np.concatenate([np.asarray(state_fixed, bool), np.ones(K - K0, bool)])),
        obs_ur=pad(np.concatenate(obs_ur).astype(np.float32), O, -1.0) if stereo else None,
        bf=np.float32(tcfg.bf) if stereo else None,
    )
    return prob, np.asarray(kfs), mp_sel


def _chain_informations(pres, E):
    """(E, 9, 9) float32 information of the edges, with the gravity-tilt
    floor of optim/vi_pose_opt.py on the velocity / position rows (~0.57 deg
    1-sigma residual init tilt)."""
    C = np.tile(np.eye(9, dtype=np.float32), (E, 1, 1))
    sg = 9.81 * 0.01
    for e, p in enumerate(pres):
        C[e] = _host(p.C)[:9, :9]
        dt = float(_host(p.dT))
        C[e, 3:6, 3:6] += np.eye(3, dtype=np.float32) * (sg * dt) ** 2
        C[e, 6:9, 6:9] += np.eye(3, dtype=np.float32) * (0.5 * sg * dt * dt) ** 2
    C = C + np.eye(9, dtype=np.float32) * 1e-10
    return np.linalg.inv(C)


def write_back_vi(m, res: VIBAResult, kfs, mp_sel):
    """Fold a solved window (host arrays) back into the map."""
    K0 = len(kfs)
    m.kf_R[kfs] = np.asarray(res.T_cw.R)[:K0]
    m.kf_t[kfs] = np.asarray(res.T_cw.t)[:K0]
    m.kf_vel[kfs] = np.asarray(res.v_w)[:K0]
    m.kf_bias[kfs, :3] = np.asarray(res.bg)[:K0]
    m.kf_bias[kfs, 3:] = np.asarray(res.ba)[:K0]
    if len(mp_sel):
        m.mp_pos[mp_sel] = np.asarray(res.points)[:len(mp_sel)]
