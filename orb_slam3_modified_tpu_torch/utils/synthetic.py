"""Synthetic trajectories for tests and the chip check.

Port of orbit_trajectory from orb_slam3_modified_tpu/utils/synthetic.py.
"""
from __future__ import annotations

import numpy as np
import torch

from ..lie.se3 import SE3


def orbit_trajectory(n_frames, radius=4.0, height=0.4, sweep=np.pi / 2):
    """Cameras on a circular arc looking at the origin: SE3 (F,) of float32
    CPU tensors (host-side ground truth)."""
    angles = np.linspace(0.0, sweep, n_frames)
    Rs, ts = [], []
    for a in angles:
        c = np.array([radius * np.sin(a), height * np.sin(3 * a), -radius * np.cos(a)])
        fwd = -c / np.linalg.norm(c)  # camera z-axis points from c to origin
        up = np.array([0.0, -1.0, 0.0])
        right = np.cross(up, fwd)
        right /= np.linalg.norm(right)
        up2 = np.cross(fwd, right)
        R_cw = np.stack([right, up2, fwd], axis=1).T
        Rs.append(R_cw)
        ts.append(-R_cw @ c)
    return SE3(
        torch.from_numpy(np.stack(Rs).astype(np.float32)),
        torch.from_numpy(np.stack(ts).astype(np.float32)),
    )
