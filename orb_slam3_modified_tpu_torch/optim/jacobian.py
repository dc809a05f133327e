"""Jacobians of small residual functions by float64 central differences.

The reference differentiates its inertial residuals with jax.jacfwd inside
one compiled program. torch.func.jacfwd runs eagerly and costs ~0.2-0.4 ms
of host time per op under its vmap (measured on the CPU build), which puts
~0.5 s on every per-frame visual-inertial solve. Here the residual function
takes a batch of parameter vectors, and the 2n evaluations at x +- h e_i run
as one batched call in float64: each op launches once for all columns, and
with h = 1e-6 the truncation (~h^2) and rounding (~1e-16 / h) errors sit far
below float32's resolution of the same jacobian. A kink inside +-h (the
Huber threshold, a depth gate) gives the mean of its two slopes, where
forward mode picks one side; the rows it touches carry measure zero.
"""
from __future__ import annotations

import torch

FD_STEP = 1e-6


def central_jacobian(fn, x, h: float = FD_STEP):
    """(m, n) jacobian, in x's dtype, of fn at x (n,): fn maps a float64
    batch (B, n) to (B, m)."""
    return value_and_central_jacobian(fn, x, h)[1]


def value_and_central_jacobian(fn, x, h: float = FD_STEP):
    """(fn(x) (m,), its (m, n) jacobian), both in x's dtype, from one
    batched float64 call of fn on [x, x + h e_i, x - h e_i]."""
    n = x.shape[0]
    E = torch.eye(n, dtype=torch.float64, device=x.device) * h
    x64 = x.to(torch.float64)[None]
    R = fn(torch.cat([x64, x64 + E, x64 - E]))
    return R[0].to(x.dtype), ((R[1:n + 1] - R[n + 1:]) / (2.0 * h)).T.to(x.dtype)
