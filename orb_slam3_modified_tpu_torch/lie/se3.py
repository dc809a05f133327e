"""SE(3) rigid transforms, batch-agnostic over leading axes.

Port of orb_slam3_modified_tpu/lie/se3.py. A transform is the pair
(R (..., 3, 3), t (..., 3)); tangents are xi = (upsilon, omega).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import so3


def _mv(M, v):
    """Batched matrix-vector product, broadcasting leading axes."""
    return torch.matmul(M, v.unsqueeze(-1)).squeeze(-1)


class SE3(NamedTuple):
    """Batched rigid transform. R: (..., 3, 3), t: (..., 3)."""

    R: torch.Tensor
    t: torch.Tensor

    def inverse(self):
        Rt = self.R.transpose(-1, -2)
        return SE3(Rt, -_mv(Rt, self.t))

    def __matmul__(self, other: "SE3") -> "SE3":
        return SE3(self.R @ other.R, _mv(self.R, other.t) + self.t)

    def apply(self, p):
        """Transform points p (..., 3) (broadcasts over leading axes)."""
        return _mv(self.R, p) + self.t


def exp(xi):
    """(..., 6) tangent (upsilon translational, omega rotational) -> SE3."""
    u, w = xi[..., :3], xi[..., 3:]
    return SE3(so3.exp(w), _mv(so3.left_jacobian(w), u))


def log(T: SE3):
    """SE3 -> (..., 6)."""
    w = so3.log(T.R)
    u = _mv(so3.left_jacobian_inv(w), T.t)
    return torch.cat([u, w], dim=-1)
