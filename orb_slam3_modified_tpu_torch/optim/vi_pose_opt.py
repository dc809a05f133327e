"""Visual-inertial pose optimization of the tracker's frames.

Port of orb_slam3_modified_tpu/optim/vi_pose_opt.py
(Optimizer::PoseInertialOptimizationLastFrame / LastKeyFrame,
src/Optimizer.cc:4875 / :4491): the current frame's {pose, velocity, bias}
against Huber-weighted reprojection rows (map points fixed), the 9-D
preintegration residual to the previous state (EdgeInertial,
include/G2oTypes.h:495) and the bias random walk (EdgeGyroRW / EdgeAccRW).

vi_pose_optimization_marg is the per-frame solve once the IMU is
initialized: the {previous, current} 30-D state, the previous one held by a
15-D prior, and after the solve the Schur marginal H_marg that becomes the
next frame's prior (Marginalize, src/Optimizer.cc:2960). The reference
differentiates the whitened residuals with jax.jacfwd (the marginal
solve's visual block over its 6 live dimensions only); here the same
residual functions take a batch of increments and their jacobians are
float64 central differences (optim/jacobian.py), one batched evaluation
per block instead of functorch's per-op host cost. Both solves do so. The
damped Gauss-Newton loops have a fixed count and take every accept /
reject as torch.where, so a solve reads nothing back.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..cameras import Camera, project
from ..imu.preintegration import gravity_vec
from ..lie import se3, so3
from ..lie.se3 import SE3
from .jacobian import value_and_central_jacobian
from .robust import CHI2_MONO, CHI2_STEREO, DELTA_MONO, DELTA_STEREO, huber_weight


class VIPoseResult(NamedTuple):
    T_cw: SE3
    v_w: torch.Tensor  # (3,)
    dbg: torch.Tensor
    dba: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


class VIMargResult(NamedTuple):
    T_cw: SE3
    v_w: torch.Tensor  # (3,) current body velocity
    dbg: torch.Tensor  # (3,) bias delta from the linearization bias
    dba: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    # the current state's posterior information with the previous state
    # Schur'd out: the next frame's prior (EdgePriorPoseImu,
    # include/G2oTypes.h:732), anchored at (R_wb, p_wb, v_w, bias + delta)
    H_marg: torch.Tensor  # (15, 15)
    R_wb: torch.Tensor  # (3, 3) current body rotation (anchor)
    p_wb: torch.Tensor  # (3,) current body position (anchor)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _body_from_cam(R_cw, t_cw, R_bc, t_bc):
    """(R_wb, p_wb) of the body from the camera pose T_cw and the
    extrinsics x_b = R_bc x_c + t_bc (ImuCamPose, include/G2oTypes.h:60-128)."""
    R_bw = R_bc @ R_cw
    t_bw = _mv(R_bc, t_cw) + t_bc
    R_wb = R_bw.transpose(-1, -2)
    return R_wb, -_mv(R_wb, t_bw)


def _cam_from_body(R_wb, p_wb, R_bc, t_bc):
    """The inverse of _body_from_cam: (R_cw, t_cw) from the body state."""
    R_bw = R_wb.transpose(-1, -2)
    t_bw = -_mv(R_bw, p_wb)
    return R_bc.T @ R_bw, _mv(R_bc.T, t_bw - t_bc)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def vi_pose_optimization(T_cw0: SE3, cam: Camera, pts_w, uv_obs, inv_s2, valid, R_wb_prev,
                         p_wb_prev, v_prev, dT, dR, dV, dP, JRg, JVg, JVa, JPg, JPa,
                         iters: int = 6, use_huber: bool = True, v_init=None,
                         inertial_weight: float = 1.0, bias_prior: float = 1e4, R_bc=None,
                         t_bc=None) -> VIPoseResult:
    """The 15-D solve [xi_pose | dv | dbg | dba] against a FIXED previous
    body state (PoseInertialOptimizationLastKeyFrame's form); the pose
    stays the camera pose, the inertial residual sees the body state
    through T_bc (None: the identity rig)."""
    if v_init is None:
        v_init = v_prev
    dtype = pts_w.dtype
    R_bc = _eye(3, pts_w) if R_bc is None else R_bc
    t_bc = torch.zeros_like(pts_w[0]) if t_bc is None else t_bc
    sq_is2 = torch.sqrt(torch.clamp(inv_s2, min=1e-9))

    def residual_fns(dt):
        """(unpack, residuals) with the constants in dtype dt; both take a
        batch of increments (B, 15): float64 for the value and the
        central-difference jacobian, float32 for the result."""
        R0, t0, v0, vp, Rp, pp, R_bc_, t_bc_, pts, uvo, sq, dR_, dV_, dP_ = (
            a.to(dt) for a in (T_cw0.R, T_cw0.t, v_init, v_prev, R_wb_prev, p_wb_prev, R_bc,
                               t_bc, pts_w, uv_obs, sq_is2, dR, dV, dP))
        JRg_, JVg_, JVa_, JPg_, JPa_ = (a.to(dt) for a in (JRg, JVg, JVa, JPg, JPa))
        g = gravity_vec(pts)
        dT_ = torch.as_tensor(dT, dtype=dt, device=pts.device)

        def unpack(x):
            T = se3.exp(x[:, :6]) @ SE3(R0, t0)
            return T, v0 + x[:, 6:9], x[:, 9:12], x[:, 12:15]

        def residuals(x):
            T, v, dbg, dba = unpack(x)
            pc = pts @ T.R.transpose(-1, -2) + T.t[:, None]
            r = (project(cam, pc) - uvo) * sq[:, None]
            chi2 = torch.sum(r * r, dim=-1)
            w_rob = torch.sqrt(huber_weight(chi2, DELTA_MONO)) if use_huber else 1.0
            w = valid.to(dt) * (pc[..., 2] > 0.05)
            r_vis = (r * (w * w_rob)[..., None]).reshape(x.shape[0], -1)
            R_wb, p_wb = _body_from_cam(T.R, T.t, R_bc_, t_bc_)
            dR_c = dR_ @ so3.exp(dbg @ JRg_.T)
            dV_c = dV_ + dbg @ JVg_.T + dba @ JVa_.T
            dP_c = dP_ + dbg @ JPg_.T + dba @ JPa_.T
            RiT = Rp.T
            r_R = so3.log(dR_c.transpose(-1, -2) @ RiT @ R_wb)
            r_v = (v - vp - g * dT_) @ RiT.T - dV_c
            r_p = (p_wb - pp - vp * dT_ - 0.5 * g * dT_ * dT_) @ RiT.T - dP_c
            r_inert = torch.cat([r_R, r_v, r_p], dim=-1) * inertial_weight
            r_bias = torch.cat([dbg, dba], dim=-1) * (bias_prior ** 0.5) * dT_
            return torch.cat([r_vis, r_inert, r_bias], dim=-1)

        return unpack, residuals

    unpack = residual_fns(dtype)[0]
    residuals64 = residual_fns(torch.float64)[1]
    # each iteration evaluates the residuals and their jacobian once, at the
    # candidate: its cost decides the step, and an accepted candidate's
    # (r, J) linearizes the next iteration
    x = torch.zeros(15, dtype=dtype, device=pts_w.device)
    lam = torch.full((), 1e-3, dtype=dtype, device=pts_w.device)
    eye = _eye(15, pts_w)
    r, J = value_and_central_jacobian(residuals64, x)
    for _ in range(iters):
        H = J.T @ J
        Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye
        x_new = x - torch.linalg.solve_ex(Hd, J.T @ r)[0]
        r_new, J_new = value_and_central_jacobian(residuals64, x_new)
        good = torch.sum(r_new * r_new) < torch.sum(r * r)
        x = torch.where(good, x_new, x)
        r = torch.where(good, r_new, r)
        J = torch.where(good, J_new, J)
        lam = torch.where(good, lam * 0.5, lam * 4.0)
    T, v, dbg, dba = unpack(x[None])
    T, v, dbg, dba = SE3(T.R[0], T.t[0]), v[0], dbg[0], dba[0]
    pc = T.apply(pts_w)
    chi2 = torch.sum((project(cam, pc) - uv_obs) ** 2, dim=-1) * inv_s2
    inl = valid & (chi2 < CHI2_MONO) & (pc[..., 2] > 0)
    return VIPoseResult(SE3(so3.normalize(T.R), T.t), v, dbg, dba, inl,
                        torch.sum(inl, dtype=torch.int32))


# the 1-sigma residual gravity tilt after staged init (~0.57 deg): the
# preintegration covariance alone understates the residual against a world
# whose gravity is known only to init accuracy; an unmodeled tilt a biases
# r_v by ~g sin(a) dT and r_p by ~0.5 g sin(a) dT^2 (the reference package's
# floor, carried over as it is)
_TILT_SIG = 9.81 * 0.01


def vi_pose_optimization_marg(T_cw0: SE3, cam: Camera, pts_w, uv_obs, inv_s2, valid, R_prev,
                              p_prev, v_prev, H_prior, dT, dR, dV, dP, JRg, JVg, JVa, JPg, JPa,
                              C=None, iters: int = 8, R_bc=None, t_bc=None, ur_obs=None,
                              bf=None) -> VIMargResult:
    """Joint {previous, current} 30-D visual-inertial frame solve
    (PoseInertialOptimizationLastFrame, src/Optimizer.cc:4875): the
    previous frame is a vertex held by the 15-D prior H_prior
    ([phi, dp, dv, dbg, dba], anchored at R_prev / p_prev / v_prev, BODY
    state), the current one carries the visual rows, EdgeInertial and the
    bias random walk couple the two; then the previous state is
    Schur-marginalized out of the 30x30 Hessian. C: the preintegration
    covariance (15, 15) for the whitening; ur_obs (N,) with bf adds the
    rectified-stereo uR rows where ur_obs >= 0 (EdgeStereoOnlyPose).
    State x = [prev: phi, dp, dv, dbg, dba | cur: phi, dp, dv, dbg, dba],
    R = R0 exp(phi), p = p0 + dp, anchored at the previous solution and
    the camera-pose seed."""
    dtype, dev = pts_w.dtype, pts_w.device
    dT = torch.as_tensor(dT, dtype=dtype, device=dev)
    R_bc = _eye(3, pts_w) if R_bc is None else R_bc
    t_bc = torch.zeros(3, dtype=dtype, device=dev) if t_bc is None else t_bc
    g = gravity_vec(pts_w)
    R_cur0, p_cur0 = _body_from_cam(T_cw0.R, T_cw0.t, R_bc, t_bc)
    v_cur0 = v_prev + g * dT + R_prev @ dV
    # whitening, with the gravity-tilt floor on the velocity / position rows
    zero3 = torch.zeros(3, dtype=dtype, device=dev)
    g_v = (_TILT_SIG * dT) ** 2
    g_p = (0.5 * _TILT_SIG * dT * dT) ** 2
    C_floor = torch.diag(torch.cat([zero3, g_v.expand(3), g_p.expand(3)]))
    jitter9 = 1e-10 * _eye(9, pts_w)
    C9 = _eye(9, pts_w) * 1e-6 if C is None else 0.5 * (C[:9, :9] + C[:9, :9].T)
    C9 = C9 + C_floor
    L_inert = torch.linalg.cholesky_ex(torch.linalg.inv_ex(C9 + jitter9)[0] + jitter9)[0]
    # bias random walk over the gap (EdgeGyroRW / EdgeAccRW, the walk block
    # of the preintegration covariance)
    C_rw = _eye(6, pts_w) * 1e-8 if C is None else 0.5 * (C[9:15, 9:15] + C[9:15, 9:15].T)
    jitter6 = 1e-12 * _eye(6, pts_w)
    L_rw = torch.linalg.cholesky_ex(torch.linalg.inv_ex(C_rw + jitter6)[0] + jitter6)[0]
    L_prior = torch.linalg.cholesky_ex(0.5 * (H_prior + H_prior.T) + 1e-8 * _eye(15, pts_w))[0]
    sq_is2 = torch.sqrt(torch.clamp(inv_s2, min=1e-9))
    valid_f = valid.to(dtype)
    if ur_obs is not None:
        is_st = ur_obs >= 0
        delta = torch.where(is_st, DELTA_STEREO, DELTA_MONO)
    else:
        delta = DELTA_MONO

    def residual_fns(dt):
        """(unpack, visual_residuals, small_residuals) with the constants in
        dtype dt. Each takes a batch of increments (B, n): float64 for the
        value and the central-difference jacobian, one batch of 2n + 1 rows
        (optim/jacobian.py); unpack in float32 for the result."""
        R_p0, p_p0, v_p0, R_c0, p_c0, v_c0 = (a.to(dt) for a in (R_prev, p_prev, v_prev, R_cur0,
                                                                  p_cur0, v_cur0))
        dR_, JRg_, JVg_, JVa_, JPg_, JPa_ = (a.to(dt) for a in (dR, JRg, JVg, JVa, JPg, JPa))
        L_i, L_r, L_p, R_bc_, t_bc_, pts = (a.to(dt) for a in (L_inert, L_rw, L_prior, R_bc,
                                                                 t_bc, pts_w))

        def unpack(x):
            prev = (R_p0 @ so3.exp(x[:, 0:3]), p_p0 + x[:, 3:6], v_p0 + x[:, 6:9], x[:, 9:12],
                    x[:, 12:15])
            cur = (R_c0 @ so3.exp(x[:, 15:18]), p_c0 + x[:, 18:21], v_c0 + x[:, 21:24],
                   x[:, 24:27], x[:, 27:30])
            return prev, cur

        def visual_residuals(z6):
            """The visual rows (B, N * R) as a function of the current pose
            increment x[15:21] alone (6 columns of the jacobian)."""
            R_cw, t_cw = _cam_from_body(R_c0 @ so3.exp(z6[:, :3]), p_c0 + z6[:, 3:6], R_bc_,
                                        t_bc_)
            pcam = pts @ R_cw.transpose(-1, -2) + t_cw[:, None]
            uv = project(cam, pcam)
            r = (uv - uv_obs) * sq_is2[:, None]
            if ur_obs is not None:
                ur_pred = uv[..., 0] - bf / torch.clamp(pcam[..., 2], min=1e-6)
                r3 = torch.where(is_st, (ur_pred - ur_obs) * sq_is2, 0.0)
                r = torch.cat([r, r3[..., None]], dim=-1)
            chi2 = torch.sum(r * r, dim=-1)
            w = valid_f * (pcam[..., 2] > 0.05) * torch.sqrt(huber_weight(chi2, delta))
            return (r * w[..., None]).reshape(z6.shape[0], -1)

        def small_residuals(x):
            """The inertial, random-walk and prior rows (B, 30)."""
            (Rp, pp, vp, dbg_p, dba_p), (Rc, pc_b, vc, dbg_c, dba_c) = unpack(x)
            dR_c = dR_ @ so3.exp(dbg_p @ JRg_.T)
            dV_c = dV + dbg_p @ JVg_.T + dba_p @ JVa_.T
            dP_c = dP + dbg_p @ JPg_.T + dba_p @ JPa_.T
            RiT = Rp.transpose(-1, -2)
            r_R = so3.log(dR_c.transpose(-1, -2) @ RiT @ Rc)
            r_v = _mv(RiT, vc - vp - g * dT) - dV_c
            r_p = _mv(RiT, pc_b - pp - vp * dT - 0.5 * g * dT * dT) - dP_c
            r_inert = torch.cat([r_R, r_v, r_p], dim=-1) @ L_i
            r_rw = torch.cat([dbg_c - dbg_p, dba_c - dba_p], dim=-1) @ L_r
            return torch.cat([r_inert, r_rw, x[:, :15] @ L_p], dim=-1)

        return unpack, visual_residuals, small_residuals

    unpack = residual_fns(dtype)[0]
    _, visual64, small64 = residual_fns(torch.float64)

    def system_at(x):
        """(H, b, cost) of the whole residual at x; the visual jacobian over
        its 6 live columns, added into the 30x30."""
        rv, Jv = value_and_central_jacobian(visual64, x[15:21])  # (rows,), (rows, 6)
        rs, Js = value_and_central_jacobian(small64, x)  # (30,), (30, 30)
        H = Js.T @ Js
        H[15:21, 15:21] += Jv.T @ Jv
        b = Js.T @ rs
        b[15:21] += Jv.T @ rv
        return H, b, torch.sum(rv * rv) + torch.sum(rs * rs)

    # each iteration evaluates the system once, at the candidate: its cost
    # decides the step, and an accepted candidate's (H, b) linearizes the
    # next iteration (a rejected one keeps the current system, lambda grows)
    x = torch.zeros(30, dtype=dtype, device=dev)
    lam = torch.full((), 1e-3, dtype=dtype, device=dev)
    eye30 = _eye(30, pts_w)
    H, b, cost = system_at(x)
    for _ in range(iters):
        Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye30
        x_new = x - torch.linalg.solve_ex(Hd, b)[0]
        H_new, b_new, cost_new = system_at(x_new)
        good = cost_new < cost
        x = torch.where(good, x_new, x)
        H = torch.where(good, H_new, H)
        b = torch.where(good, b_new, b)
        cost = torch.where(good, cost_new, cost)
        lam = torch.where(good, lam * 0.5, lam * 4.0)
    x = x[None]
    _, (Rc, pc_b, vc, dbg_c, dba_c) = (tuple(a[0] for a in st) for st in unpack(x))
    x = x[0]
    Rc = so3.normalize(Rc)
    R_cw, t_cw = _cam_from_body(Rc, pc_b, R_bc, t_bc)
    pcam = pts_w @ R_cw.T + t_cw
    uv = project(cam, pcam)
    chi2 = torch.sum((uv - uv_obs) ** 2, dim=-1) * inv_s2
    if ur_obs is not None:
        r3 = torch.where(is_st, uv[..., 0] - bf / torch.clamp(pcam[..., 2], min=1e-6) - ur_obs,
                         0.0)
        chi2 = chi2 + r3 * r3 * inv_s2
        thr = torch.where(is_st, CHI2_STEREO, CHI2_MONO)
    else:
        thr = CHI2_MONO
    inl = valid & (chi2 < thr) & (pcam[..., 2] > 0)
    # marginalize the previous state out of the final Hessian
    H_pp = H[:15, :15] + 1e-6 * _eye(15, pts_w)
    H_cp = H[15:, :15]
    H_marg = H[15:, 15:] - H_cp @ torch.linalg.solve_ex(H_pp, H_cp.T)[0]
    H_marg = 0.5 * (H_marg + H_marg.T)
    return VIMargResult(SE3(R_cw, t_cw), vc, dbg_c, dba_c, inl,
                        torch.sum(inl, dtype=torch.int32), H_marg, Rc, pc_b)
