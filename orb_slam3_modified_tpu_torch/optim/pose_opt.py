"""Motion-only pose optimization (frame tracking solver).

Port of orb_slam3_modified_tpu/optim/pose_opt.py (ORB-SLAM3
Optimizer::PoseOptimization, src/Optimizer.cc:814): rounds x iterations of
Levenberg-Marquardt on the 6-DoF pose with map points fixed, a Huber kernel
in every round but the last, and chi2 re-classification of inliers between
rounds (mono 5.991, stereo 7.815).

Every decision (accept a step, inlier or not) is a torch.where on the
device, so a solve issues no host read. Pose convention: T_cw, updated
left-multiplicatively, T <- exp(xi) T with xi = (rho, phi).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..cameras import Camera, project, project_jac
from ..lie import se3, so3
from ..lie.se3 import SE3
from .robust import CHI2_MONO, CHI2_STEREO, DELTA_MONO, DELTA_STEREO, huber_weight


class PoseOptResult(NamedTuple):
    T_cw: SE3
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int32
    chi2: torch.Tensor  # (N,) final per-point chi2


def _residuals(T_cw: SE3, cam: Camera, pts_w, uv_obs, ur_obs=None, bf=None):
    """Mono rows (du, dv); with ur_obs also the stereo row dur, uR = u - bf/z.
    Returns (r (N, R), pc (N, 3))."""
    pc = T_cw.apply(pts_w)
    uv = project(cam, pc)
    if ur_obs is None:
        return uv - uv_obs, pc
    ur_pred = uv[..., 0] - bf / torch.clamp(pc[..., 2], min=1e-6)
    return torch.cat([uv - uv_obs, (ur_pred - ur_obs)[:, None]], dim=-1), pc


def _residuals_and_jac(T_cw: SE3, cam: Camera, pts_w, uv_obs, ur_obs=None, bf=None):
    """Residuals, their (N, R, 6) jacobian in the left tangent, and pc."""
    r, pc = _residuals(T_cw, cam, pts_w, uv_obs, ur_obs, bf)
    Jproj = project_jac(cam, pc)  # (N, 2, 3)
    if ur_obs is not None:
        z = torch.clamp(pc[..., 2], min=1e-6)
        e_z = torch.zeros_like(pc)
        e_z[:, 2] = bf / (z * z)
        Jproj = torch.cat([Jproj, (Jproj[:, 0, :] + e_z)[:, None, :]], dim=1)
    # d pc / d xi (left-mult on T_cw): [ I | -hat(pc) ]
    I3 = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    Jse3 = torch.cat([I3, -so3.hat(pc)], dim=-1)  # (N, 3, 6)
    return r, Jproj @ Jse3, pc


def pose_optimization(
    T_cw0: SE3, cam: Camera, pts_w, uv_obs, inv_sigma2, rounds: int = 4,
    iters: int = 10, valid=None, ur_obs=None, bf=None,
):
    """Optimize T_cw. pts_w (N, 3); uv_obs (N, 2); inv_sigma2 (N,) per-level
    information; valid (N,) bool. ur_obs (N,) right-image u (< 0 = mono
    row) with bf = baseline * fx adds the stereo (u, v, uR) rows."""
    n = pts_w.shape[0]
    dev, dt = pts_w.device, pts_w.dtype
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=dev)
    if ur_obs is not None:
        is_st = ur_obs >= 0
        ones = torch.ones(n, dtype=dt, device=dev)
        rmask = torch.stack([ones, ones, is_st.to(dt)], dim=-1)
        chi2_thr = torch.where(is_st, CHI2_STEREO, CHI2_MONO)
        delta = torch.where(is_st, DELTA_STEREO, DELTA_MONO)
    else:
        rmask = torch.ones((n, 2), dtype=dt, device=dev)
        chi2_thr = CHI2_MONO
        delta = DELTA_MONO
    eye6 = torch.eye(6, dtype=dt, device=dev)
    valid_f = valid.to(dt)
    inv_s2_safe = torch.clamp(inv_sigma2, min=1e-12)

    def chi2_of(r):
        return torch.sum(r * r * rmask, dim=-1) * inv_sigma2

    def chi2_gated(T):
        r, pc = _residuals(T, cam, pts_w, uv_obs, ur_obs, bf)
        return torch.where(pc[..., 2] <= 0.0, torch.inf, chi2_of(r))

    R, t, inl = T_cw0.R, T_cw0.t, valid
    for round_idx in range(rounds):
        use_huber = round_idx < rounds - 1  # last round: hard outlier cut
        lam = torch.full((), 1e-3, dtype=dt, device=dev)
        w_in = inl.to(dt) * valid_f
        for _ in range(iters):
            T = SE3(R, t)
            r, J, pc = _residuals_and_jac(T, cam, pts_w, uv_obs, ur_obs, bf)
            chi2 = chi2_of(r)
            w = w_in * huber_weight(chi2, delta) if use_huber else w_in
            w = torch.where(pc[..., 2] > 0, w * inv_sigma2, 0.0)
            wr = w[:, None] * rmask  # (N, R)
            Jw = J * wr[..., None]
            H = torch.einsum("nri,nrj->ij", Jw, J)
            b = torch.einsum("nri,nr->i", Jw, r)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
            dx = -torch.linalg.solve_ex(Hd, b)[0]
            T_new = se3.exp(dx) @ T
            # LM acceptance on the weighted cost
            c_old = torch.sum(w * chi2 / inv_s2_safe)
            r2, pc2 = _residuals(T_new, cam, pts_w, uv_obs, ur_obs, bf)
            c_new = torch.sum(w * torch.where(pc2[..., 2] > 0, chi2_of(r2), chi2) / inv_s2_safe)
            good = c_new < c_old
            R = torch.where(good, T_new.R, R)
            t = torch.where(good, T_new.t, t)
            lam = torch.where(good, lam * 0.5, lam * 4.0)
        inl = valid & (chi2_gated(SE3(R, t)) < chi2_thr)
    T = SE3(so3.normalize(R), t)
    chi2 = chi2_gated(T)
    return PoseOptResult(T, inl, torch.sum(inl, dtype=torch.int32), chi2)
