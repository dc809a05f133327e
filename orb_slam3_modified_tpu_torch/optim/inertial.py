"""Inertial factors and the inertial-only optimizer of the staged IMU init.

Port of orb_slam3_modified_tpu/optim/inertial.py (EdgeInertial,
include/G2oTypes.h:495; VertexGDir :274, VertexScale :296;
Optimizer::InertialOptimization, src/Optimizer.cc:3042). Per keyframe the
state is R_wb (3, 3), p_w (3,), v_w (3,); during init one bias is shared.
Residuals (Forster's preintegration, EdgeInertial::computeError):
  r_R = Log( dR(bg)^T R_i^T R_j )
  r_v = R_i^T (v_j - v_i - g dt) - dV(b)
  r_p = R_i^T (p_j - p_i - v_i dt - 0.5 g dt^2) - dP(b)

The init solves {gravity direction (2 dof), log-scale, shared biases, all
velocities} with the poses fixed, by damped Gauss-Newton on a dense
parameter vector. The reference differentiates the whitened residual with
jax.jacfwd; here it takes a batch of parameter vectors and the jacobian is
its float64 central difference (optim/jacobian.py), one batched evaluation
per iteration. The loop keeps its fixed iteration count with accept /
reject as torch.where, so it reads nothing back. The closed-form seed is
the linear visual-inertial alignment.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..imu.preintegration import GRAVITY
from ..lie import so3
from .jacobian import central_jacobian


def bmv(M, v):
    """Batched matrix-vector product (..., n, m) x (..., m) -> (..., n)."""
    return (M @ v[..., None])[..., 0]


class InertialChain(NamedTuple):
    """Preintegrated constraints along the temporal keyframe chain: K
    keyframes, E = K - 1 constraints stacked over the first axis."""

    dT: torch.Tensor  # (E,)
    dR: torch.Tensor  # (E, 3, 3)
    dV: torch.Tensor  # (E, 3)
    dP: torch.Tensor  # (E, 3)
    JRg: torch.Tensor  # (E, 3, 3)
    JVg: torch.Tensor  # (E, 3, 3)
    JVa: torch.Tensor  # (E, 3, 3)
    JPg: torch.Tensor  # (E, 3, 3)
    JPa: torch.Tensor  # (E, 3, 3)
    C_inv: torch.Tensor  # (E, 9, 9) information of [r_R, r_v, r_p]
    valid: torch.Tensor  # (E,) bool

    @staticmethod
    def from_preintegrated(pres: list, device=None):
        """Stack host (numpy) or device Preintegrated intervals on `device`
        (default: the first interval's); the information is the float32
        inverse of C[:9, :9] + 1e-10 I, taken on the host as the reference
        does."""
        def host(x):
            return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

        if device is None:
            device = pres[0].dR.device if isinstance(pres[0].dR, torch.Tensor) else "cpu"

        def stack(f):
            return torch.from_numpy(np.stack([host(f(p)) for p in pres]).astype(np.float32)).to(
                device)

        C = np.stack([host(p.C)[:9, :9] for p in pres]).astype(np.float32)
        C = C + np.eye(9, dtype=np.float32) * 1e-10
        return InertialChain(
            dT=stack(lambda p: p.dT), dR=stack(lambda p: p.dR), dV=stack(lambda p: p.dV),
            dP=stack(lambda p: p.dP), JRg=stack(lambda p: p.JRg), JVg=stack(lambda p: p.JVg),
            JVa=stack(lambda p: p.JVa), JPg=stack(lambda p: p.JPg), JPa=stack(lambda p: p.JPa),
            C_inv=torch.from_numpy(np.linalg.inv(C)).to(device),
            valid=torch.ones(len(pres), dtype=torch.bool, device=device),
        )


def inertial_residuals(chain: InertialChain, R_wb, p_w, v_w, bg, ba, g_w, scale):
    """(E, 9) stacked [r_R, r_v, r_p] of the consecutive-keyframe factors;
    R_wb (K, 3, 3), p_w / v_w (K, 3), bg / ba / g_w (3,), scale () applied
    to the positions (monocular init)."""
    return inertial_residuals_batch(chain, R_wb, p_w, v_w[None], bg[None], ba[None], g_w[None],
                                    torch.as_tensor(scale, dtype=p_w.dtype,
                                                    device=p_w.device).reshape(1))[0]


def inertial_residuals_batch(chain: InertialChain, R_wb, p_w, v_w, bg, ba, g_w, scale):
    """inertial_residuals over a batch of B unknowns: v_w (B, K, 3), bg / ba
    / g_w (B, 3), scale (B,) -> (B, E, 9); the poses R_wb / p_w are fixed."""
    Ri, Rj = R_wb[:-1], R_wb[1:]
    sc = scale[:, None, None]
    pi, pj = p_w[:-1] * sc, p_w[1:] * sc
    vi, vj = v_w[:, :-1], v_w[:, 1:]
    dt = chain.dT[:, None]
    g = g_w[:, None]
    dR_corr = chain.dR @ so3.exp(bmv(chain.JRg, bg[:, None]))
    dV_corr = chain.dV + bmv(chain.JVg, bg[:, None]) + bmv(chain.JVa, ba[:, None])
    dP_corr = chain.dP + bmv(chain.JPg, bg[:, None]) + bmv(chain.JPa, ba[:, None])
    RiT = Ri.transpose(-1, -2)
    r_R = so3.log(dR_corr.transpose(-1, -2) @ RiT @ Rj)
    r_v = bmv(RiT, vj - vi - g * dt) - dV_corr
    r_p = bmv(RiT, pj - pi - vi * dt - 0.5 * g * dt * dt) - dP_corr
    return torch.cat([r_R, r_v, r_p], dim=-1)


class InertialInitResult(NamedTuple):
    R_wg: torch.Tensor  # (3, 3) gravity alignment (world' = R_wg^T world)
    scale: torch.Tensor  # ()
    bg: torch.Tensor  # (3,)
    ba: torch.Tensor  # (3,)
    v_w: torch.Tensor  # (K, 3)
    cost: torch.Tensor  # ()


def linear_inertial_init(chain: InertialChain, R_wb, p_w):
    """Closed-form seed: with rotations fixed and biases ~0, r_v = 0 and
    r_p = 0 are linear in x = [scale, g (3), v_1..v_K (3K)] (the Martinelli /
    VINS-Mono alignment). Returns (s, g, v (K, 3)).

    The reference solves with jnp.linalg.lstsq (SVD, the minimum-norm
    solution, cut-off eps * max(M, N)); torch.linalg.lstsq on the card has
    only the QR method ('gels'), which needs full rank, so this takes the SVD
    pseudo-inverse with the same cut-off on every device."""
    K = R_wb.shape[0]
    E = K - 1
    dev, dt_ = p_w.device, p_w.dtype
    RiT = R_wb[:-1].transpose(-1, -2)  # (E, 3, 3)
    dp = p_w[1:] - p_w[:-1]
    dt = chain.dT[:, None]
    n_x = 4 + 3 * K
    ar = torch.arange(E, device=dev)
    onehot_i = (ar[:, None] == torch.arange(K, device=dev)[None, :]).to(dt_)
    onehot_j = ((ar + 1)[:, None] == torch.arange(K, device=dev)[None, :]).to(dt_)
    # position rows: s R_i^T dp - R_i^T v_i dt - 0.5 R_i^T g dt^2 = dP
    A_p_v = torch.einsum("ek,eab->eakb", onehot_i, -RiT * dt[..., None]).reshape(E, 3, 3 * K)
    A_p = torch.cat([bmv(RiT, dp)[..., None], -0.5 * RiT * (dt ** 2)[..., None], A_p_v], dim=-1)
    # velocity rows: R_i^T (v_j - v_i) - R_i^T g dt = dV
    A_v_v = torch.einsum("ek,eab->eakb", onehot_j - onehot_i, RiT).reshape(E, 3, 3 * K)
    A_v = torch.cat([torch.zeros((E, 3, 1), dtype=dt_, device=dev), -RiT * dt[..., None], A_v_v],
                    dim=-1)
    A = torch.cat([A_p.reshape(-1, n_x), A_v.reshape(-1, n_x)], dim=0)
    b = torch.cat([chain.dP.reshape(-1), chain.dV.reshape(-1)])
    x = torch.linalg.pinv(A) @ b
    return x[0], x[1:4], x[4:].reshape(K, 3)


def inertial_only_optimization(chain: InertialChain, R_wb, p_w, v0, fix_scale: bool = False,
                               iters: int = 30, prior_gyro: float = 1e2,
                               prior_acc: float = 1e10) -> InertialInitResult:
    """Inertial-only MAP: gravity direction (2 dof), log-scale, shared
    biases and per-keyframe velocities, poses fixed
    (Optimizer::InertialOptimization, src/Optimizer.cc:3042, with the bias
    priors of LocalMapping::InitializeIMU). Gravity is Exp([a, b, 0])
    applied to [0, 0, -G] (VertexGDir's 2-dof update)."""
    K = R_wb.shape[0]
    dev, dt_ = p_w.device, p_w.dtype
    gI = torch.tensor([0.0, 0.0, -1.0], dtype=dt_, device=dev)
    # whitening r' = L^T r with C_inv = L L^T (constant in theta)
    L = torch.linalg.cholesky_ex(0.5 * (chain.C_inv + chain.C_inv.transpose(-1, -2)))[0]

    def whitened_fn(dt):
        """theta (B, n) -> whitened residuals (B, 9E + 6), constants in dt:
        float32 for the value, float64 for the central-difference jacobian
        (optim/jacobian.py)."""
        ch = InertialChain(*(a.to(dt) if a.is_floating_point() else a for a in chain))
        R, p, L_, g0 = R_wb.to(dt), p_w.to(dt), L.to(dt), gI.to(dt) * GRAVITY
        sq_pri = torch.tensor([prior_gyro ** 0.5] * 3 + [prior_acc ** 0.5] * 3, dtype=dt,
                              device=dev)

        def whitened(theta):
            B = theta.shape[0]
            g_w = bmv(so3.exp(torch.cat([theta[:, :2], torch.zeros_like(theta[:, :1])], dim=1)),
                      g0)
            s = torch.exp(theta[:, 2] * (0.0 if fix_scale else 1.0))
            bg, ba = theta[:, 3:6], theta[:, 6:9]
            v = theta[:, 9:].reshape(B, K, 3)
            r = inertial_residuals_batch(ch, R, p, v, bg, ba, g_w, s)  # (B, E, 9)
            rw = bmv(L_.transpose(-1, -2), r)
            rw = torch.where(ch.valid[:, None], rw, 0.0)
            return torch.cat([rw.reshape(B, -1), torch.cat([bg, ba], dim=1) * sq_pri], dim=1)

        return whitened

    w32, w64 = whitened_fn(dt_), whitened_fn(torch.float64)

    def whitened(theta):
        return w32(theta[None])[0]

    def unpack(theta):
        s = theta[2] * (0.0 if fix_scale else 1.0)
        g_w = so3.exp(torch.cat([theta[:2], torch.zeros_like(theta[:1])])[None])[0] @ (
            gI * GRAVITY)
        return g_w, torch.exp(s), theta[3:6], theta[6:9], theta[9:].reshape(K, 3)

    # seed from the linear alignment (the nonlinear problem has a
    # scale-collapse minimum for short chains that the linear solution avoids)
    s_lin, g_lin, v_lin = linear_inertial_init(chain, R_wb, p_w)
    g_norm = torch.linalg.norm(g_lin)
    g_ok = (g_norm > 0.5 * GRAVITY) & (g_norm < 2.0 * GRAVITY) & (s_lin > 1e-3)
    g_dir0 = torch.where(g_ok, g_lin / torch.clamp(g_norm, min=1e-9), gI)
    axis0 = torch.linalg.cross(gI, g_dir0)
    na = torch.linalg.norm(axis0)
    ang0 = torch.atan2(na, torch.clamp(torch.dot(gI, g_dir0), -1.0, 1.0))
    ab0 = torch.where(na < 1e-9, torch.zeros(3, dtype=dt_, device=dev),
                      axis0 / torch.clamp(na, min=1e-9) * ang0)[:2]
    log_s0 = torch.where(g_ok & (not fix_scale), torch.log(torch.clamp(s_lin, min=1e-3)), 0.0)
    v_seed = torch.where(g_ok, v_lin, v0)
    theta = torch.cat([torch.where(g_ok, ab0, 0.0), log_s0[None],
                       torch.zeros(6, dtype=dt_, device=dev), v_seed.reshape(-1).to(dt_)])
    lam = torch.full((), 1e-3, dtype=dt_, device=dev)
    eye = torch.eye(theta.shape[0], dtype=dt_, device=dev)
    for _ in range(iters):
        r = whitened(theta)
        J = central_jacobian(w64, theta)
        H = J.T @ J
        b = J.T @ r
        H = H + (lam * torch.diag(torch.diagonal(H)) + 1e-9 * eye)
        theta_new = theta - torch.linalg.solve_ex(H, b)[0]
        good = torch.sum(whitened(theta_new) ** 2) < torch.sum(r * r)
        theta = torch.where(good, theta_new, theta)
        lam = torch.where(good, lam * 0.5, lam * 4.0)
    g_w, s, bg, ba, v = unpack(theta)
    # R_wg aligns the estimated gravity to [0, 0, -G]
    g_dir = g_w / torch.linalg.norm(g_w)
    vaxis = torch.linalg.cross(gI, g_dir)
    norm_v = torch.linalg.norm(vaxis)
    ang = torch.atan2(norm_v, torch.clamp(torch.dot(gI, g_dir), -1.0, 1.0))
    R_wg = so3.exp(vaxis / torch.where(norm_v < 1e-9, 1.0, norm_v) * ang)
    return InertialInitResult(R_wg, s, bg, ba, v, torch.sum(whitened(theta) ** 2))
