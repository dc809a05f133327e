"""Tracker helpers (port of parts of orb_slam3_modified_tpu/tracking/tracker.py).

Only what the device path needs so far; the host-side Tracker comes with the
slice that ports the map and the slow path.
"""
from __future__ import annotations

import numpy as np


def inv_level_sigma2(n_levels: int = 8, scale: float = 1.2) -> np.ndarray:
    """(n_levels,) float32 information per octave, 1 / scale^(2 level)
    (ORB-SLAM3 mvInvLevelSigma2)."""
    return (1.0 / scale ** (2.0 * np.arange(n_levels))).astype(np.float32)
