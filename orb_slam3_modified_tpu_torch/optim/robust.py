"""Robust kernels as IRLS weights (port of orb_slam3_modified_tpu/optim/robust.py).

Chi-square thresholds follow ORB-SLAM3 (src/Optimizer.cc:880-885): mono
5.991 (2 dof), stereo 7.815 (3 dof).
"""
from __future__ import annotations

import torch

CHI2_MONO = 5.991
CHI2_STEREO = 7.815
DELTA_MONO = CHI2_MONO**0.5
DELTA_STEREO = CHI2_STEREO**0.5


def huber_weight(chi2, delta):
    """IRLS weight for the Huber kernel given squared error chi2:
    1 for |e| <= delta, delta/|e| beyond."""
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(e <= delta, 1.0, delta / e)
