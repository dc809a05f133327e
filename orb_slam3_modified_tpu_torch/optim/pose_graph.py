"""Essential-graph / pose-graph optimization over Sim3, and its 4-DoF form.

Port of orb_slam3_modified_tpu/optim/pose_graph.py
(Optimizer::OptimizeEssentialGraph, src/Optimizer.cc:1501; the 4-DoF
inertial variant :5292; g2o's sim3 types). Poses are a dense (K, 7) Sim3
tangent around the current values; each edge's residual is
log(S_ji_meas S_i S_j^-1), zero at the measured relative pose. The jacobian
is torch.func.jacfwd of the whole stacked residual, as the reference's
jax.jacfwd: the graph is small (K up to a few hundred), so one dense
(7K, 7K) solve per Gauss-Newton iteration replaces sparse bookkeeping.
Fixed vertices and masked degrees of freedom are pinned in the normal
equations. The loop runs on the inputs' device and reads nothing back.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..lie import sim3 as sim3m
from ..lie import so3
from ..lie.sim3 import Sim3


class PoseGraphProblem(NamedTuple):
    S: Sim3  # (K,) absolute poses (world -> keyframe, like Scw)
    fixed: torch.Tensor  # (K,) bool
    edge_i: torch.Tensor  # (E,) int64
    edge_j: torch.Tensor  # (E,) int64
    S_ji_meas: Sim3  # (E,) measured relative pose S_j S_i^-1
    edge_weight: torch.Tensor  # (E,)
    edge_valid: torch.Tensor  # (E,) bool


def _take(S: Sim3, idx) -> Sim3:
    return Sim3(S.s[idx], S.R[idx], S.t[idx])


def make_relative(S: Sim3, edge_i, edge_j) -> Sim3:
    """Measured relatives from the absolutes: S_ji = S_j S_i^-1."""
    return _take(S, edge_j) @ _take(S, edge_i).inverse()


def _apply_tangent(S: Sim3, xi) -> Sim3:
    """Left-multiplicative update S' = exp(xi) S, batched."""
    return sim3m.exp(xi) @ S


def _residuals(prob: PoseGraphProblem, xi_flat, dof_mask):
    K = prob.S.t.shape[0]
    xi = xi_flat.reshape(K, 7) * dof_mask[None, :]
    xi = torch.where(prob.fixed[:, None], 0.0, xi)
    S_new = _apply_tangent(prob.S, xi)
    err = (prob.S_ji_meas @ _take(S_new, prob.edge_i)) @ _take(S_new, prob.edge_j).inverse()
    r = sim3m.log(err)  # (E, 7)
    w = torch.sqrt(torch.clamp(prob.edge_weight, min=0.0)) * prob.edge_valid
    return (r * w[:, None]).reshape(-1)


def optimize_pose_graph(prob: PoseGraphProblem, four_dof: bool = False, iters: int = 20) -> Sim3:
    """Dense Gauss-Newton with LM damping; returns the optimized Sim3 (K,).
    four_dof restricts the update to translation and yaw
    (OptimizeEssentialGraph4DoF, for inertial maps)."""
    S = prob.S
    K = S.t.shape[0]
    dt, dev = S.t.dtype, S.t.device
    if four_dof:
        dof_mask = torch.tensor([1.0, 1.0, 1.0, 0.0, 0.0, 1.0, 0.0], dtype=dt, device=dev)
    else:
        dof_mask = torch.ones(7, dtype=dt, device=dev)
    free = ((~prob.fixed[:, None]) & (dof_mask[None, :] > 0)).reshape(-1)
    both_free = free[:, None] & free[None, :]
    xi0 = torch.zeros(K * 7, dtype=dt, device=dev)
    lam = torch.full((), 1e-4, dtype=dt, device=dev)
    for _ in range(iters):
        p = prob._replace(S=S)
        r = _residuals(p, xi0, dof_mask)
        J = torch.func.jacfwd(lambda x, p=p: _residuals(p, x, dof_mask))(xi0)
        H = J.T @ J
        b = J.T @ r
        # pin the fixed vertices and masked degrees of freedom
        H = torch.where(both_free, H, 0.0)
        H = H + torch.diag(torch.where(free, lam * torch.diagonal(H) + 1e-6, 1.0))
        b = torch.where(free, b, 0.0)
        dx = -torch.linalg.solve_ex(H, b)[0]
        xi = torch.where(prob.fixed[:, None], 0.0, dx.reshape(K, 7) * dof_mask[None, :])
        S_new = _apply_tangent(S, xi)
        r_new = _residuals(prob._replace(S=S_new), xi0, dof_mask)
        good = torch.sum(r_new * r_new) < torch.sum(r * r)
        S = Sim3(torch.where(good, S_new.s, S.s), torch.where(good, S_new.R, S.R),
                 torch.where(good, S_new.t, S.t))
        lam = torch.where(good, lam * 0.5, lam * 4.0)
    return Sim3(S.s, so3.normalize(S.R), S.t)
