"""Batched bundle adjustment with a dense Schur complement.

Port of orb_slam3_modified_tpu/optim/ba.py (Optimizer::LocalBundleAdjustment
/ GlobalBundleAdjustemnt, src/Optimizer.cc:1116, :60, and g2o's block
Schur solver):
- K camera poses (SE3 SoA), P points, O observations as fixed-capacity COO
  arrays (obs_cam, obs_pt, obs_uv, obs_inv_s2, obs_valid);
- per-observation 2x6 / 2x3 jacobians in closed form for the whole batch;
  with obs_ur set, stereo observations (obs_ur >= 0) get a third row
  uR = u - bf/z (EdgeStereo, include/G2oTypes.h:414) and the 7.815 chi2
  gate, the others stay monocular (their third row is masked off);
- the reduced camera system as a dense (6K, 6K) matrix, batched 3x3 point
  block inverses, then one (6K, 6K) solve; fixed cameras pinned to the
  identity block (g2o setFixed);
- Huber IRLS, and chi2 reclassification of outliers after every round
  (LocalBA: optimize(5), drop chi2 > 5.991, optimize(10)).

The LM schedule is the reference's: lambda 1e-4 at every round, halved on
an accepted step and multiplied by 5 on a rejected one; every decision is a
torch.where on the device, so a solve issues no host read. Each
observation touches one camera, so the camera block of the normal equations
is block-diagonal and the cross terms W (P, 6K, 3) have one 6x3 block per
(point, camera) pair: both are accumulated per observation with index_put_
instead of through the reference's dense one-hot (O, R, 6K) jacobian, and
the point reduction W H_pp^-1 W^T is one (6K, 3P) x (3P, 6K) product, so no
(P, 6K, 6K) tensor is built. The 3x3 inverses and the (6K, 6K) solve are
torch.linalg calls (library work, as in the reference).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cameras import Camera, project, project_jac
from ..lie import se3, so3
from ..lie.se3 import SE3
from .robust import CHI2_MONO, CHI2_STEREO, DELTA_MONO, DELTA_STEREO, huber_weight


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem. K cameras, P points, O observations.
    Fields are numpy arrays while the host builds the problem, tensors on
    the device once `to_device` uploads it."""

    T_cw: SE3  # (K,) batched poses
    cam_fixed: torch.Tensor  # (K,) bool: gauge anchors / frontier
    points: torch.Tensor  # (P, 3)
    pt_valid: torch.Tensor  # (P,) bool
    obs_cam: torch.Tensor  # (O,) camera index
    obs_pt: torch.Tensor  # (O,) point index
    obs_uv: torch.Tensor  # (O, 2) pixel measurement
    obs_inv_s2: torch.Tensor  # (O,) information (1/sigma^2 of the octave)
    obs_valid: torch.Tensor  # (O,) bool
    obs_ur: torch.Tensor = None  # (O,) right-image u, < 0 = monocular; None: mono rows only
    bf: torch.Tensor = None  # () baseline * fx (the reference's mbf)


class BAResult(NamedTuple):
    T_cw: SE3
    points: torch.Tensor
    obs_inlier: torch.Tensor  # (O,) bool after the last reclassification
    chi2: torch.Tensor  # (O,) final per-observation chi2


def to_device(prob: BAProblem, device) -> BAProblem:
    """Upload a numpy-built problem: one pinned, non-blocking copy per field
    on the current stream; indices become int64."""
    from ..utils.fetch import upload

    def up(a, dtype=None):
        a = np.asarray(a)
        return upload(a if dtype is None else a.astype(dtype), device)

    return BAProblem(
        T_cw=SE3(up(prob.T_cw.R, np.float32), up(prob.T_cw.t, np.float32)),
        cam_fixed=up(prob.cam_fixed, bool), points=up(prob.points, np.float32),
        pt_valid=up(prob.pt_valid, bool), obs_cam=up(prob.obs_cam, np.int64),
        obs_pt=up(prob.obs_pt, np.int64), obs_uv=up(prob.obs_uv, np.float32),
        obs_inv_s2=up(prob.obs_inv_s2, np.float32), obs_valid=up(prob.obs_valid, bool),
        obs_ur=None if prob.obs_ur is None else up(prob.obs_ur, np.float32),
        bf=None if prob.bf is None else up(np.float32(prob.bf)).reshape(()),
    )


def _obs_residuals(prob: BAProblem, cam: Camera, Rk, tk, pts):
    """Residuals r (O, R), jacobians Jpose (O, R, 6) and Jpt (O, R, 3), and
    the camera-frame points pc (O, 3), for every observation; R = 2 rows,
    or 3 with obs_ur set (uR = u - bf/z, d uR / d pc = d u / d pc +
    (0, 0, bf/z^2))."""
    Rc = Rk[prob.obs_cam]  # (O, 3, 3)
    pc = (Rc @ pts[prob.obs_pt][..., None])[..., 0] + tk[prob.obs_cam]
    uv = project(cam, pc)
    Jproj = project_jac(cam, pc)  # (O, 2, 3)
    if prob.obs_ur is None:
        r = uv - prob.obs_uv
    else:
        z = torch.clamp(pc[..., 2], min=1e-6)
        r = torch.cat([uv - prob.obs_uv, (uv[..., 0] - prob.bf / z - prob.obs_ur)[:, None]], dim=-1)
        e_z = torch.zeros_like(pc)
        e_z[:, 2] = prob.bf / (z * z)
        Jproj = torch.cat([Jproj, (Jproj[:, 0, :] + e_z)[:, None, :]], dim=1)
    I3 = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[0], 3, 3)
    Jpose = Jproj @ torch.cat([I3, -so3.hat(pc)], dim=-1)
    Jpt = Jproj @ Rc
    return r, Jpose, Jpt, pc


def _sum_by_index(n, idx, vals):
    """(n, ...) sums of vals (O, ...) over idx (O,). index_put_ with
    accumulate sorts the indices on CUDA, so every run adds in one order;
    index_add_ adds with atomics in the order they land, and the run-to-run
    rounding differences grow through the map."""
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_put_((idx,), vals, accumulate=True)


def _schur_reduce(prob: BAProblem, K, P, wr, r, Jpose, Jpt, lam):
    """The point blocks (LM-damped) eliminated from the normal equations:
    (S (6K, 6K) the undamped reduced camera system, b_red (6K,), and for the
    back-substitution H_pp^-1 (P, 3, 3), W (P, 6K, 3), b_p (P, 3)).
    wr: (O, R) per-row weights."""
    dt, dev = r.dtype, r.device
    cam, pt = prob.obs_cam, prob.obs_pt
    wJpose = wr[..., None] * Jpose  # (O, R, 6)
    wJpt = wr[..., None] * Jpt  # (O, R, 3)
    # camera blocks (block-diagonal H_cc) and gradient
    H_blk = _sum_by_index(K, cam, wJpose.transpose(1, 2) @ Jpose)
    ar = torch.arange(K, device=dev)
    H_cc = torch.zeros((K, K, 6, 6), dtype=dt, device=dev)
    H_cc[ar, ar] = H_blk
    H_cc = H_cc.transpose(1, 2).reshape(6 * K, 6 * K)
    b_c = _sum_by_index(K, cam, (wJpose.transpose(1, 2) @ r[..., None])[..., 0]).reshape(6 * K)
    # point blocks
    H_pp = _sum_by_index(P, pt, wJpt.transpose(1, 2) @ Jpt)
    b_p = _sum_by_index(P, pt, (wJpt.transpose(1, 2) @ r[..., None])[..., 0])
    # cross terms: one 6x3 block per (point, camera) pair -> W (P, 6K, 3)
    W = torch.zeros((P, K, 6, 3), dtype=dt, device=dev)
    W.index_put_((pt, cam), wJpose.transpose(1, 2) @ Jpt, accumulate=True)
    W = W.reshape(P, 6 * K, 3)
    # damp + invert the point blocks (diagonal LM damping per block)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    H_pp_d = H_pp + eye3 * (lam * torch.diagonal(H_pp, dim1=-2, dim2=-1) + 1e-8)[..., :, None]
    active = prob.pt_valid[:, None, None]
    H_pp_inv = torch.linalg.inv_ex(torch.where(active, H_pp_d, eye3))[0]
    H_pp_inv = torch.where(active, H_pp_inv, 0.0)
    # Schur reduction, contracted through W H_pp^-1 first (no (P, 6K, 6K))
    WH = W @ H_pp_inv  # (P, 6K, 3)
    S = H_cc - WH.transpose(0, 1).reshape(6 * K, 3 * P) @ W.transpose(0, 1).reshape(6 * K, 3 * P).T
    b_red = b_c - torch.einsum("pac,pc->a", WH, b_p)
    return S, b_red, H_pp_inv, W, b_p


def _schur_solve(prob: BAProblem, K, P, wr, r, Jpose, Jpt, lam):
    """One damped Gauss-Newton step via the dense Schur complement.
    wr: (O, R) per-row weights. Returns (dx_cam (K, 6), dx_pt (P, 3))."""
    dt = r.dtype
    S, b_red, H_pp_inv, W, b_p = _schur_reduce(prob, K, P, wr, r, Jpose, Jpt, lam)
    # damp cameras + pin fixed cameras
    S = S + torch.diag(lam * torch.diagonal(S) + 1e-8)
    fixed6 = torch.repeat_interleave(prob.cam_fixed, 6)
    S = torch.where(fixed6[:, None] | fixed6[None, :], 0.0, S)
    S = S + torch.diag(fixed6.to(dt))
    b_red = torch.where(fixed6, 0.0, b_red)
    dx_cam = -torch.linalg.solve_ex(S, b_red)[0]  # (6K,)
    # back-substitute the points: dx_p = -Hpp^-1 (b_p + W^T dx_cam)
    dx_pt = -(H_pp_inv @ (b_p + torch.einsum("pac,a->pc", W, dx_cam))[..., None])[..., 0]
    return dx_cam.reshape(K, 6), dx_pt


def bundle_adjust(prob: BAProblem, cam: Camera, rounds: int = 2, iters_per_round: int = 5,
                  huber=None) -> BAResult:
    """Robust BA on a problem whose fields are tensors on one device (see
    to_device). Each round runs `iters_per_round` LM iterations, then marks
    observations with chi2 > 5.991 (7.815 for a stereo row; or negative
    depth) as outliers for the next round. huber: None = Huber on all but
    the last round (the reference schedule); True / False force it for
    every round."""
    K = prob.T_cw.t.shape[0]
    P = prob.points.shape[0]
    dt, dev = prob.points.dtype, prob.points.device
    obs_w = (prob.obs_valid.to(dt) * prob.pt_valid[prob.obs_pt].to(dt)) * prob.obs_inv_s2
    if prob.obs_ur is None:
        rmask = torch.ones((prob.obs_cam.shape[0], 2), dtype=dt, device=dev)
        chi2_thr, delta = CHI2_MONO, DELTA_MONO
    else:
        # the uR row exists for stereo observations only
        stereo = prob.obs_ur >= 0
        rmask = torch.stack([torch.ones_like(prob.obs_ur), torch.ones_like(prob.obs_ur),
                             stereo.to(dt)], dim=-1)
        chi2_thr = torch.where(stereo, CHI2_STEREO, CHI2_MONO)
        delta = torch.where(stereo, DELTA_STEREO, DELTA_MONO)

    def chi2_of(Rk, tk, pts):
        r, _, _, pc = _obs_residuals(prob, cam, Rk, tk, pts)
        c = torch.sum(r * r * rmask, dim=-1) * prob.obs_inv_s2
        return torch.where(pc[..., 2] > 0, c, torch.inf)

    Rk, tk, pts, inlier = prob.T_cw.R, prob.T_cw.t, prob.points, prob.obs_valid
    for round_idx in range(rounds):
        use_huber = (round_idx < rounds - 1) if huber is None else huber
        lam = torch.full((), 1e-4, dtype=dt, device=dev)
        for _ in range(iters_per_round):
            r, Jpose, Jpt, pc = _obs_residuals(prob, cam, Rk, tk, pts)
            chi2 = torch.sum(r * r * rmask, dim=-1) * prob.obs_inv_s2
            w = inlier.to(dt) * obs_w
            if use_huber:
                w = w * huber_weight(chi2, delta)
            w = torch.where(pc[..., 2] > 0, w, 0.0)
            dx_cam, dx_pt = _schur_solve(prob, K, P, w[:, None] * rmask, r, Jpose, Jpt, lam)
            T_new = se3.exp(dx_cam) @ SE3(Rk, tk)
            pts_new = pts + dx_pt
            c_old = torch.sum(torch.where(torch.isfinite(chi2), w * chi2, 0.0))
            r2, _, _, pc2 = _obs_residuals(prob, cam, T_new.R, T_new.t, pts_new)
            chi2n = torch.sum(r2 * r2 * rmask, dim=-1) * prob.obs_inv_s2
            c_new = torch.sum(torch.where(pc2[..., 2] > 0, w * chi2n, w * chi2))
            good = c_new < c_old
            Rk = torch.where(good, T_new.R, Rk)
            tk = torch.where(good, T_new.t, tk)
            pts = torch.where(good, pts_new, pts)
            lam = torch.where(good, lam * 0.5, lam * 5.0)
        inlier = prob.obs_valid & (chi2_of(Rk, tk, pts) < chi2_thr)
    Rk = so3.normalize(Rk)
    return BAResult(SE3(Rk, tk), pts, inlier, chi2_of(Rk, tk, pts))
