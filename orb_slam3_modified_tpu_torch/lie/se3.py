"""SE(3) rigid transforms, batch-agnostic over leading axes.

Port of orb_slam3_modified_tpu/lie/se3.py. A transform is the pair
(R (..., 3, 3), t (..., 3)); tangents are xi = (upsilon, omega).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


class SE3np(NamedTuple):
    """SE3 on the host: the same (R, t) pair as numpy arrays.

    The host half (tracker, mapper, chunk driver) keeps frame and keyframe
    poses in numpy between device solves; the reference keeps them in its
    SE3 with numpy leaves."""

    R: np.ndarray
    t: np.ndarray

    @staticmethod
    def identity(dtype=np.float32):
        return SE3np(np.eye(3, dtype=dtype), np.zeros(3, dtype))

    def inverse(self):
        Rt = np.swapaxes(self.R, -1, -2)
        return SE3np(Rt, -np.einsum("...ij,...j->...i", Rt, self.t))

    def __matmul__(self, other: "SE3np") -> "SE3np":
        return SE3np(self.R @ other.R, np.einsum("...ij,...j->...i", self.R, other.t) + self.t)

    def apply(self, p):
        return np.einsum("...ij,...j->...i", self.R, p) + self.t


def exp(xi):
    """(..., 6) tangent (upsilon translational, omega rotational) -> SE3."""
    u, w = xi[..., :3], xi[..., 3:]
    return SE3(so3.exp(w), _mv(so3.left_jacobian(w), u))


def log(T: SE3):
    """SE3 -> (..., 6)."""
    w = so3.log(T.R)
    u = _mv(so3.left_jacobian_inv(w), T.t)
    return torch.cat([u, w], dim=-1)
