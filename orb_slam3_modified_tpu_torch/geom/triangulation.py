"""Point triangulation.

Port of orb_slam3_modified_tpu/geom/triangulation.py (GeometricTools::
Triangulate, src/GeometricTools.cc): batched DLT, one 4x4 symmetric
eigensolve per correspondence. Leading axes batch; everything stays on the
inputs' device.
"""
from __future__ import annotations

import torch

from ..lie.se3 import SE3


def projection_matrix(T_cw: SE3):
    """(..., 3, 4) projection [R|t] in normalized (unit-plane) coordinates."""
    return torch.cat([T_cw.R, T_cw.t[..., None]], dim=-1)


def triangulate_dlt(P1, P2, x1, x2):
    """DLT triangulation in normalized camera coordinates.

    P1, P2: (..., 3, 4) world -> camera projections; x1, x2: (..., 2)
    unit-plane observations. Returns (..., 3) world points: the eigenvector
    of A^T A with the smallest eigenvalue (the smallest right singular vector
    of A, as the reference takes), dehomogenized."""
    rows = [
        x1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        x1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        x2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        x2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = torch.stack(rows, dim=-2)  # (..., 4, 4)
    AtA = A.transpose(-1, -2) @ A
    _, V = torch.linalg.eigh(AtA)  # ascending eigenvalues
    X = V[..., :, 0]
    w = X[..., 3]
    w_safe = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return X[..., :3] / w_safe[..., None]


def triangulate_rays(T_wc1: SE3, T_wc2: SE3, ray1, ray2):
    """Triangulate from two camera-to-world poses and camera-frame rays."""
    P1 = projection_matrix(T_wc1.inverse())
    P2 = projection_matrix(T_wc2.inverse())
    x1 = ray1[..., :2] / torch.where(torch.abs(ray1[..., 2:]) < 1e-9, 1e-9, ray1[..., 2:])
    x2 = ray2[..., :2] / torch.where(torch.abs(ray2[..., 2:]) < 1e-9, 1e-9, ray2[..., 2:])
    return triangulate_dlt(P1, P2, x1, x2)


def depth_and_reproj_checks(T_cw1: SE3, T_cw2: SE3, pw, x1, x2, reproj_thresh_sq: float,
                            min_parallax_cos: float = 0.9998):
    """Cheirality + parallax + reprojection gates used after triangulation
    (the acceptance logic of TwoViewReconstruction::CheckRT). Returns
    (valid_mask, parallax_cos, err1_sq, err2_sq)."""
    pc1 = T_cw1.apply(pw)
    pc2 = T_cw2.apply(pw)
    z1, z2 = pc1[..., 2], pc2[..., 2]
    r1 = pw - T_cw1.inverse().t
    r2 = pw - T_cw2.inverse().t
    cos_par = torch.sum(r1 * r2, dim=-1) / (
        torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1) + 1e-12
    )
    z1s = torch.where(torch.abs(z1) < 1e-9, 1e-9, z1)
    z2s = torch.where(torch.abs(z2) < 1e-9, 1e-9, z2)
    e1 = pc1[..., :2] / z1s[..., None] - x1
    e2 = pc2[..., :2] / z2s[..., None] - x2
    err1 = torch.sum(e1 * e1, dim=-1)
    err2 = torch.sum(e2 * e2, dim=-1)
    valid = (
        (z1 > 0) & (z2 > 0) & (cos_par < min_parallax_cos)
        & (err1 < reproj_thresh_sq) & (err2 < reproj_thresh_sq)
    )
    return valid, cos_par, err1, err2
