"""Camera models: pinhole and Kannala-Brandt-8 fisheye.

Port of orb_slam3_modified_tpu/cameras/models.py. A camera is a static
`kind` plus a flat (8,) parameter tensor:
  pinhole: params = [fx, fy, cx, cy, 0...]      (kind = PINHOLE)
  kb8:     params = [fx, fy, cx, cy, k0..k3]    (kind = FISHEYE_KB8)
Point arrays are batch-agnostic over leading axes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device

PINHOLE = 0
FISHEYE_KB8 = 1

_Z_EPS = 1e-6


@dataclasses.dataclass(frozen=True)
class Camera:
    kind: int
    params: torch.Tensor  # (8,) float32; pinhole uses the first 4
    width: int = 0
    height: int = 0

    @staticmethod
    def pinhole(fx, fy, cx, cy, width=0, height=0, device="cuda"):
        p = torch.zeros(8, dtype=torch.float32)
        p[:4] = torch.tensor([fx, fy, cx, cy], dtype=torch.float32)
        return Camera(PINHOLE, p.to(resolve_device(device)), width, height)

    @staticmethod
    def kb8(fx, fy, cx, cy, k0, k1, k2, k3, width=0, height=0, device="cuda"):
        p = torch.tensor([fx, fy, cx, cy, k0, k1, k2, k3], dtype=torch.float32)
        return Camera(FISHEYE_KB8, p.to(resolve_device(device)), width, height)


# ---------- pinhole ----------

def _pinhole_project(params, pc):
    fx, fy, cx, cy = (params[..., i] for i in range(4))
    z = pc[..., 2]
    z_safe = torch.where(torch.abs(z) < _Z_EPS, _Z_EPS, z)
    u = fx * pc[..., 0] / z_safe + cx
    v = fy * pc[..., 1] / z_safe + cy
    return torch.stack([u, v], dim=-1)


def _pinhole_unproject(params, uv):
    fx, fy, cx, cy = (params[..., i] for i in range(4))
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def _pinhole_project_jac(params, pc):
    fx, fy = params[..., 0], params[..., 1]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    z_safe = torch.where(torch.abs(z) < _Z_EPS, _Z_EPS, z)
    inv_z = 1.0 / z_safe
    inv_z2 = inv_z * inv_z
    zero = torch.zeros_like(x)
    row0 = torch.stack([fx * inv_z, zero, -fx * x * inv_z2], dim=-1)
    row1 = torch.stack([zero, fy * inv_z, -fy * y * inv_z2], dim=-1)
    return torch.stack([row0, row1], dim=-2)


# ---------- Kannala-Brandt 8 (equidistant fisheye) ----------

def _kb8_project(params, pc):
    fx, fy, cx, cy = (params[..., i] for i in range(4))
    k0, k1, k2, k3 = (params[..., 4 + i] for i in range(4))
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    r2 = x * x + y * y
    r = torch.sqrt(torch.clamp(r2, min=1e-18))
    theta = torch.atan2(r, z)
    th2 = theta * theta
    r_theta = theta * (1 + th2 * (k0 + th2 * (k1 + th2 * (k2 + th2 * k3))))
    small_r = r2 < 1e-12
    r_safe = torch.where(small_r, 1.0, r)
    scale = torch.where(small_r, 0.0, r_theta / r_safe)
    return torch.stack([fx * scale * x + cx, fy * scale * y + cy], dim=-1)


def _kb8_unproject(params, uv, num_iters: int = 10):
    fx, fy, cx, cy = (params[..., i] for i in range(4))
    k0, k1, k2, k3 = (params[..., 4 + i] for i in range(4))
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    r_d = torch.sqrt(mx * mx + my * my)
    theta = r_d
    for _ in range(num_iters):
        th2 = theta * theta
        f = theta * (1 + th2 * (k0 + th2 * (k1 + th2 * (k2 + th2 * k3)))) - r_d
        fp = 1 + th2 * (3 * k0 + th2 * (5 * k1 + th2 * (7 * k2 + th2 * 9 * k3)))
        theta = theta - f / torch.where(torch.abs(fp) < 1e-6, 1e-6, fp)
    small = r_d < 1e-9
    r_safe = torch.where(small, 1.0, r_d)
    s = torch.where(small, 0.0, torch.tan(theta) / r_safe)
    x = torch.where(small, mx, mx * s)
    y = torch.where(small, my, my * s)
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def _kb8_project_jac(params, pc):
    fx, fy = params[..., 0], params[..., 1]
    k0, k1, k2, k3 = (params[..., 4 + i] for i in range(4))
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    r2 = torch.clamp(x * x + y * y, min=1e-18)
    r = torch.sqrt(r2)
    R2 = r2 + z * z
    theta = torch.atan2(r, z)
    th2 = theta * theta
    f = theta * (1 + th2 * (k0 + th2 * (k1 + th2 * (k2 + th2 * k3))))
    fp = 1 + th2 * (3 * k0 + th2 * (5 * k1 + th2 * (7 * k2 + th2 * 9 * k3)))
    dth_dx = x * z / (R2 * r)
    dth_dy = y * z / (R2 * r)
    dth_dz = -r / R2
    s = f / r
    ds_dx = (fp * dth_dx * r - f * (x / r)) / r2
    ds_dy = (fp * dth_dy * r - f * (y / r)) / r2
    ds_dz = fp * dth_dz / r
    du = torch.stack([fx * (ds_dx * x + s), fx * ds_dy * x, fx * ds_dz * x], dim=-1)
    dv = torch.stack([fy * ds_dx * y, fy * (ds_dy * y + s), fy * ds_dz * y], dim=-1)
    return torch.stack([du, dv], dim=-2)


# ---------- dispatch (static on Camera.kind) ----------

def project(cam: Camera, pc):
    if cam.kind == PINHOLE:
        return _pinhole_project(cam.params, pc)
    return _kb8_project(cam.params, pc)


def unproject(cam: Camera, uv):
    if cam.kind == PINHOLE:
        return _pinhole_unproject(cam.params, uv)
    return _kb8_unproject(cam.params, uv)


def project_jac(cam: Camera, pc):
    if cam.kind == PINHOLE:
        return _pinhole_project_jac(cam.params, pc)
    return _kb8_project_jac(cam.params, pc)


def _params_np(cam: Camera):
    return cam.params.detach().cpu().numpy()


def project_np(cam: Camera, pc):
    """Numpy projection for host-side math. pc: (N, 3) numpy."""
    p = _params_np(cam)
    if cam.kind == PINHOLE:
        z = pc[..., 2]
        zs = np.where(np.abs(z) < _Z_EPS, _Z_EPS, z)
        return np.stack(
            [p[0] * pc[..., 0] / zs + p[2], p[1] * pc[..., 1] / zs + p[3]], axis=-1
        )
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    r = np.sqrt(np.maximum(x * x + y * y, 1e-18))
    theta = np.arctan2(r, z)
    th2 = theta * theta
    r_theta = theta * (1 + th2 * (p[4] + th2 * (p[5] + th2 * (p[6] + th2 * p[7]))))
    scale = np.where(r < 1e-6, 0.0, r_theta / np.where(r < 1e-6, 1.0, r))
    return np.stack([p[0] * scale * x + p[2], p[1] * scale * y + p[3]], axis=-1)


def unproject_np(cam: Camera, uv):
    """Numpy unprojection (host-side). uv: (N, 2) numpy -> (N, 3) rays."""
    p = _params_np(cam)
    mx = (uv[..., 0] - p[2]) / p[0]
    my = (uv[..., 1] - p[3]) / p[1]
    if cam.kind == PINHOLE:
        return np.stack([mx, my, np.ones_like(mx)], axis=-1)
    r_d = np.sqrt(mx * mx + my * my)
    theta = r_d.copy()
    for _ in range(10):
        th2 = theta * theta
        f = theta * (1 + th2 * (p[4] + th2 * (p[5] + th2 * (p[6] + th2 * p[7])))) - r_d
        fp = 1 + th2 * (3 * p[4] + th2 * (5 * p[5] + th2 * (7 * p[6] + th2 * 9 * p[7])))
        theta = theta - f / np.where(np.abs(fp) < 1e-6, 1e-6, fp)
    small = r_d < 1e-9
    s = np.where(small, 0.0, np.tan(theta) / np.where(small, 1.0, r_d))
    x = np.where(small, mx, mx * s)
    y = np.where(small, my, my * s)
    return np.stack([x, y, np.ones_like(x)], axis=-1)
