"""SO(3) operations, batch-agnostic over leading axes.

Port of orb_slam3_modified_tpu/lie/so3.py. Rotations are (..., 3, 3)
tensors, tangents (..., 3). The small-angle Taylor branches are selected with
torch.where on a sanitized argument, as in the reference, so no Python branch
reads a tensor value (no host sync on the card).
"""
from __future__ import annotations

import torch

_EPS = 1e-6


def hat(w):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def _theta_sq(w):
    return torch.sum(w * w, dim=-1)


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _sin_cos_coeffs(theta_sq):
    """(A, B, C) = (sin t / t, (1-cos t)/t^2, (t - sin t)/t^3), Taylor-guarded."""
    small = theta_sq < _EPS
    ts_safe = torch.where(small, 1.0, theta_sq)
    theta = torch.sqrt(ts_safe)
    st, ct = torch.sin(theta), torch.cos(theta)
    A = torch.where(small, 1.0 - theta_sq / 6.0, st / theta)
    B = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - ct) / ts_safe)
    C = torch.where(
        small, 1.0 / 6.0 - theta_sq / 120.0, (theta - st) / (ts_safe * theta)
    )
    return A, B, C


def exp(w):
    """Rodrigues: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    A, B, _ = _sin_cos_coeffs(_theta_sq(w))
    W = hat(w)
    return _eye_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def log(R):
    """(..., 3, 3) -> (..., 3) rotation vector, through the unit quaternion."""
    q = quat_from_mat(R)  # w >= 0 -> theta in [0, pi]
    qw = q[..., 0]
    v = q[..., 1:]
    nv = torch.linalg.norm(v, dim=-1)
    small = nv < 1e-6
    nv_safe = torch.where(small, 1.0, nv)
    scale = torch.where(
        small,
        2.0 / torch.clamp(qw, min=1e-12),
        2.0 * torch.atan2(nv, qw) / nv_safe,
    )
    return scale[..., None] * v


def left_jacobian(w):
    """J_l(w): exp((w+dw)^) ~= exp(J_l dw ^) exp(w^)."""
    _, B, C = _sin_cos_coeffs(_theta_sq(w))
    W = hat(w)
    return _eye_like(W) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def left_jacobian_inv(w):
    theta_sq = _theta_sq(w)
    small = theta_sq < _EPS
    ts_safe = torch.where(small, 1.0, theta_sq)
    theta = torch.sqrt(ts_safe)
    half = theta * 0.5
    sin_half = torch.sin(half)
    cos_half = torch.cos(half)
    sin_half_safe = torch.where(torch.abs(sin_half) < 1e-12, 1e-12, sin_half)
    cot_coeff = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half * cos_half / sin_half_safe) / ts_safe,
    )
    W = hat(w)
    return _eye_like(W) - 0.5 * W + cot_coeff[..., None, None] * (W @ W)


# ---- quaternion helpers (wxyz convention) ----

def quat_from_mat(R):
    """(..., 3, 3) -> (..., 4) unit quaternion, wxyz, w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw_0 = torch.sqrt(torch.clamp(1.0 + tr, min=1e-12)) * 0.5
    q0 = torch.stack(
        [qw_0, (m21 - m12) / (4 * qw_0), (m02 - m20) / (4 * qw_0), (m10 - m01) / (4 * qw_0)],
        dim=-1,
    )
    qx_1 = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=1e-12)) * 0.5
    q1 = torch.stack(
        [(m21 - m12) / (4 * qx_1), qx_1, (m01 + m10) / (4 * qx_1), (m02 + m20) / (4 * qx_1)],
        dim=-1,
    )
    qy_2 = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=1e-12)) * 0.5
    q2 = torch.stack(
        [(m02 - m20) / (4 * qy_2), (m01 + m10) / (4 * qy_2), qy_2, (m12 + m21) / (4 * qy_2)],
        dim=-1,
    )
    qz_3 = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=1e-12)) * 0.5
    q3 = torch.stack(
        [(m10 - m01) / (4 * qz_3), (m02 + m20) / (4 * qz_3), (m12 + m21) / (4 * qz_3), qz_3],
        dim=-1,
    )
    cand = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4cand, 4)
    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    best = torch.argmax(scores, dim=-1)  # first maximum, as jnp.argmax
    q = torch.take_along_dim(cand, best[..., None, None], dim=-2)[..., 0, :]
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def mat_from_quat(q):
    """(..., 4) wxyz -> (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def normalize(R):
    """Re-project a near-rotation onto SO(3) via the quaternion round-trip."""
    return mat_from_quat(quat_from_mat(R))
