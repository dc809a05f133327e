"""Sim(3) similarity transforms, batch-agnostic over leading axes.

Port of orb_slam3_modified_tpu/lie/sim3.py (Sophus::Sim3f / g2o::Sim3,
used by loop closing and the essential graph). A similarity is (s, R, t)
acting as p -> s R p + t; tangents are xi = (upsilon (3), omega (3),
sigma (1)) with s = e^sigma. The small-angle and small-sigma branches are
torch.where selections on sanitized arguments, as in the reference, so no
Python branch reads a tensor value and the functions compose with
torch.func.jacfwd.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import resolve_device
from . import so3
from .se3 import SE3, _mv

_EPS = 1e-6


class Sim3(NamedTuple):
    s: torch.Tensor  # (...,)
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)

    @staticmethod
    def identity(batch_shape=(), dtype=torch.float32, device="cuda"):
        """The identity on `device` (an entry point's default: the card)."""
        device = resolve_device(device)
        return Sim3(
            torch.ones(batch_shape, dtype=dtype, device=device),
            torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3),
            torch.zeros((*batch_shape, 3), dtype=dtype, device=device),
        )

    @staticmethod
    def from_se3(T: SE3, s=None):
        if s is None:
            s = torch.ones(T.t.shape[:-1], dtype=T.t.dtype, device=T.t.device)
        return Sim3(s, T.R, T.t)

    def to_se3(self) -> SE3:
        """Fold the scale into the translation: SE3(R, t / s), the loop
        correction's [R t/s] (src/LoopClosing.cc:1062 region)."""
        return SE3(self.R, self.t / self.s[..., None])

    def inverse(self):
        Rt = self.R.transpose(-1, -2)
        s_inv = 1.0 / self.s
        return Sim3(s_inv, Rt, -s_inv[..., None] * _mv(Rt, self.t))

    def __matmul__(self, other: "Sim3") -> "Sim3":
        return Sim3(self.s * other.s, self.R @ other.R,
                    self.s[..., None] * _mv(self.R, other.t) + self.t)

    def apply(self, p):
        return self.s[..., None] * _mv(self.R, p) + self.t


def exp(xi):
    """(..., 7) = (upsilon, omega, sigma) -> Sim3 (Strasdat's V matrix)."""
    u, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    s = torch.exp(sigma)
    R = so3.exp(w)
    W = so3.hat(w)
    W2 = W @ W
    theta_sq = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta_sq, min=1e-24))
    small_sigma = torch.abs(sigma) < _EPS
    small_theta = theta_sq < _EPS
    es = s
    sigma_safe = torch.where(small_sigma, 1.0, sigma)
    A_s = torch.where(small_sigma, 1.0 + sigma / 2.0, (es - 1.0) / sigma_safe)
    a = es * torch.sin(theta)
    b = es * torch.cos(theta)
    sig2th2 = sigma * sigma + theta_sq
    sig2th2_safe = torch.where(sig2th2 < 1e-20, 1.0, sig2th2)
    theta_safe = torch.where(small_theta, 1.0, theta)
    # coefficients of W and W^2 (Strasdat / Sophus)
    B_gen = (a * sigma + (1.0 - b) * theta) / (theta_safe * sig2th2_safe)
    C_gen = (A_s - ((b - 1.0) * sigma + a * theta) / sig2th2_safe) / torch.where(
        small_theta, 1.0, theta_sq)
    one_s = torch.where(small_sigma, 1.0, sigma_safe)
    B_small = torch.where(small_sigma, 0.5 + sigma / 3.0,
                          (sigma_safe * es - es + 1.0) / (one_s * one_s))
    C_small = torch.where(
        small_sigma, 1.0 / 6.0 + sigma / 8.0,
        (es * (0.5 * sigma_safe * sigma_safe - sigma_safe + 1.0) - 1.0) / one_s**3)
    B = torch.where(small_theta, B_small, B_gen)
    C = torch.where(small_theta, C_small, C_gen)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(W.shape)
    V = A_s[..., None, None] * eye + B[..., None, None] * W + C[..., None, None] * W2
    return Sim3(s, R, _mv(V, u))


def log(X: Sim3):
    """Sim3 -> (..., 7), solving V u = t with V rebuilt as in exp (its
    columns are exp of the unit translations)."""
    w = so3.log(X.R)
    sigma = torch.log(X.s)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(*w.shape[:-1], 3, 3)
    cols = [exp(torch.cat([eye[..., i], w, sigma[..., None]], dim=-1)).t for i in range(3)]
    V = torch.stack(cols, dim=-1)
    u = torch.linalg.solve(V, X.t[..., None])[..., 0]
    return torch.cat([u, w, sigma[..., None]], dim=-1)
