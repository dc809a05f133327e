"""Batched Horn Sim3 RANSAC between two keyframes' matched points, and the
bidirectional reprojection refinement of its result.

Port of orb_slam3_modified_tpu/loop/sim3_solver.py (Sim3Solver,
src/Sim3Solver.cc: Horn 1987 from 3 point pairs inside RANSAC;
Optimizer::OptimizeSim3, src/Optimizer.cc:2115). All N_HYP hypotheses are
solved and scored as one batch on the inputs' device: (H, 3, 3) triples ->
(H,) Horn solutions -> (H, N) gates -> argmax.

Random minimal sets: the reference draws them with jax.random.categorical
from PRNGKey(keyframe id); torch cannot reproduce those draws, so the port
draws them in `_sample_minimal_sets` from a CPU torch.Generator seeded with
the same integer and uploads the (N_HYP, 3) indices. A CPU generator gives
the same sets whichever device solves, and a parity test can replace the one
function with the reference's draws. The SVD's factor signs differ between
libraries; the rotation U diag(1, 1, det(U V^T)) V^T does not depend on
them when the singular values are distinct.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..cameras import project
from ..lie import so3
from ..lie.sim3 import Sim3
from ..optim.robust import huber_weight

N_HYP = 128  # reference default: up to 300 iterations, 0.99 confidence


class Sim3Result(NamedTuple):
    success: torch.Tensor  # () bool
    S_12: Sim3  # maps points in frame-2 coordinates to frame-1 coordinates
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int


def _sample_minimal_sets(key: int, valid, n_sets: int, set_size: int):
    """(n_sets, set_size) int64 CPU indices drawn uniformly, with
    replacement, from the valid entries, from a CPU generator seeded with
    key (every index may come when none is valid)."""
    w = valid.detach().cpu().to(torch.float32)
    w = w + float(not bool(w.any()))
    gen = torch.Generator().manual_seed(int(key))
    return torch.multinomial(w, n_sets * set_size, replacement=True,
                             generator=gen).view(n_sets, set_size)


def _rotation_from_cov(M):
    """Proper rotation closest to the cross covariance M (..., 3, 3)."""
    U, _, Vt = torch.linalg.svd(M)
    d = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1)
    return U @ (D[..., :, None] * Vt)


def horn_sim3(p1, p2, fix_scale=False):
    """Closed-form similarity aligning p2 -> p1; p1, p2 (..., N, 3). Batched
    over the leading axes (rotation from the centred cross covariance's
    SVD, the symmetric scale)."""
    c1 = p1.mean(dim=-2, keepdim=True)
    c2 = p2.mean(dim=-2, keepdim=True)
    q1 = p1 - c1
    q2 = p2 - c2
    R = _rotation_from_cov(torch.einsum("...ni,...nj->...ij", q1, q2))
    if fix_scale:
        s = torch.ones(R.shape[:-2], dtype=R.dtype, device=R.device)
    else:
        num = torch.sum(q1 * torch.einsum("...ij,...nj->...ni", R, q2), dim=(-2, -1))
        den = torch.sum(q2 * q2, dim=(-2, -1))
        s = num / torch.clamp(den, min=1e-12)
    t = c1[..., 0, :] - s[..., None] * torch.einsum("...ij,...j->...i", R, c2[..., 0, :])
    return Sim3(s, R, t)


def solve_sim3_ransac(p1, p2, valid, key: int, fix_scale: bool = False,
                      err_thresh: float = 0.05, min_inliers: int = 20) -> Sim3Result:
    """RANSAC Horn alignment of p2 (N, 3) onto p1 (N, 3), valid (N,) bool;
    key seeds the minimal sets. err_thresh: the 3D error gate relative to
    the point's norm (the reference gates on reprojection chi2 9.210; the
    caller re-verifies against both frames' pixels with optimize_sim3)."""
    dev = p1.device
    idx = _sample_minimal_sets(key, valid, N_HYP, 3).to(dev)
    S = horn_sim3(p1[idx], p2[idx], fix_scale)  # (H,)
    p2to1 = S.s[:, None, None] * torch.einsum("hij,nj->hni", S.R, p2) + S.t[:, None]
    err = torch.linalg.norm(p2to1 - p1[None], dim=-1)
    scale_ref = torch.clamp(torch.linalg.norm(p1, dim=-1), min=1.0)
    inl = valid[None] & (err < err_thresh * scale_ref[None])
    n_inl = inl.sum(dim=-1)
    best = torch.argmax(n_inl)  # first maximum, as jnp.argmax
    inliers = inl[best]
    # refine on the inliers with one more Horn solve (mask as weights)
    w = inliers[:, None].to(p1.dtype)
    cnt = torch.clamp(inliers.sum(), min=3)
    c1 = torch.sum(p1 * w, dim=0) / cnt
    c2 = torch.sum(p2 * w, dim=0) / cnt
    q1 = (p1 - c1) * w
    q2 = (p2 - c2) * w
    R = _rotation_from_cov(q1.T @ q2)
    if fix_scale:
        s = torch.ones((), dtype=p1.dtype, device=dev)
    else:
        s = torch.sum(q1 * (q2 @ R.T)) / torch.clamp(torch.sum(q2 * q2), min=1e-12)
    t = c1 - s * (R @ c2)
    return Sim3Result(n_inl[best] >= min_inliers, Sim3(s, R, t), inliers, n_inl[best])


def optimize_sim3(S12: Sim3, cam1, cam2, p1_c1, p2_c2, uv1, uv2, inv_s2_1, inv_s2_2, valid,
                  fix_scale: bool = False, iters: int = 10, chi2_thresh: float = 9.210):
    """Joint bidirectional reprojection refinement of a Sim3 hypothesis
    (Optimizer::OptimizeSim3, src/Optimizer.cc:2115): over S12's 7 (6 with
    fix_scale) degrees of freedom, kf2's points projected into kf1 and kf1's
    into kf2 through S12^-1, Huber-robust, with the chi2 > 9.210 gate
    between two rounds; the points stay fixed.

    p1_c1, p2_c2 (N, 3) matched points in each keyframe's camera; uv1, uv2
    (N, 2) their pixels; inv_s2_* (N,) octave information; valid (N,).
    The jacobian is torch.func.jacfwd of the stacked residual, as the
    reference's jax.jacfwd. Returns (S12', inliers (N,), n_inliers)."""
    dev, dt = p1_c1.device, p1_c1.dtype
    delta = chi2_thresh ** 0.5
    sq1 = torch.sqrt(inv_s2_1)[:, None]
    sq2 = torch.sqrt(inv_s2_2)[:, None]

    # S12 as a batch of one: under jacfwd, arithmetic between a 0-d tensor
    # and a Python scalar promotes to float64
    S0 = Sim3(S12.s.reshape(1), S12.R.reshape(1, 3, 3), S12.t.reshape(1, 3))

    def apply_state(x):
        # right perturbation on S12: x = (phi (3), dt (3), dlog_s (1))
        R = S0.R @ so3.exp(x[None, :3])
        t = S0.t + x[None, 3:6]
        s = S0.s if fix_scale else S0.s * torch.exp(x[6:7])
        return Sim3(s, R, t)

    def residuals(x):
        S = apply_state(x)
        q1 = S.apply(p2_c2)  # kf2's points in kf1's camera
        q2 = S.inverse().apply(p1_c1)
        r1 = (project(cam1, q1) - uv1) * sq1
        r2 = (project(cam2, q2) - uv2) * sq2
        return r1, r2, valid & (q1[..., 2] > 0.05), valid & (q2[..., 2] > 0.05)

    def chi2_of(x):
        r1, r2, w1, w2 = residuals(x)
        c1 = torch.where(w1, torch.sum(r1 * r1, dim=-1), torch.inf)
        c2 = torch.where(w2, torch.sum(r2 * r2, dim=-1), torch.inf)
        return c1, c2

    def flat_res(x, inl):
        r1, r2, w1, w2 = residuals(x)
        h1 = torch.sqrt(huber_weight(torch.sum(r1 * r1, dim=-1), delta))
        h2 = torch.sqrt(huber_weight(torch.sum(r2 * r2, dim=-1), delta))
        m1 = (w1 & inl).to(dt) * h1
        m2 = (w2 & inl).to(dt) * h2
        return torch.cat([(r1 * m1[:, None]).reshape(-1), (r2 * m2[:, None]).reshape(-1)])

    eye7 = torch.eye(7, dtype=dt, device=dev)
    keep = torch.ones(7, dtype=dt, device=dev)
    if fix_scale:
        keep[6] = 0.0

    def lm(x, inl, n):
        lam = torch.full((), 1e-3, dtype=dt, device=dev)
        for _ in range(n):
            r = flat_res(x, inl)
            J = torch.func.jacfwd(flat_res)(x, inl)
            H = J.T @ J
            b = J.T @ r
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye7
            x_new = x - torch.linalg.solve_ex(Hd, b)[0] * keep
            good = torch.sum(flat_res(x_new, inl) ** 2) < torch.sum(r * r)
            x = torch.where(good, x_new, x)
            lam = torch.where(good, lam * 0.5, lam * 4.0)
        return x

    # round 1: optimize, drop chi2 > 9.210 in EITHER view, optimize again
    # (the reference's vbIsInKF2 erase loop and second optimize(nMoreIters))
    x = lm(torch.zeros(7, dtype=dt, device=dev), valid, iters // 2)
    c1, c2 = chi2_of(x)
    x = lm(x, valid & (c1 < chi2_thresh) & (c2 < chi2_thresh), iters - iters // 2)
    c1, c2 = chi2_of(x)
    inl = valid & (c1 < chi2_thresh) & (c2 < chi2_thresh)
    S = apply_state(x)
    return Sim3(S.s[0], S.R[0], S.t[0]), inl, inl.sum()
