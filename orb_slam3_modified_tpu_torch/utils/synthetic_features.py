"""Synthetic feature streams: an ideal ORB extractor over a known scene.

Port of orb_slam3_modified_tpu/utils/synthetic_features.py. World points
carry fixed random descriptors; each observation gets pixel noise and
descriptor bit flips, so tracking, mapping, loop closing and BA can be
tested against exact ground truth without images. Frames come out as host
Features (numpy, uint32 descriptors), the form the port's tracker takes.
The same seed gives the same world as the reference's class; the
projection runs in float32 here, as the reference's device projection.
"""
from __future__ import annotations

import numpy as np

from ..cameras import project_np
from ..features.extractor import Features


class SyntheticFeatureWorld:
    def __init__(self, n_points=3000, spread=6.0, seed=0, feat_cap=1024, noise_px=0.4,
                 desc_flips=4, n_levels=8, layout="box"):
        rng = np.random.default_rng(seed)
        self.rng = rng
        if layout == "ring":
            # an annulus wall: a revisit needs covisibility to decay around
            # the loop, so the centre stays empty
            ang = rng.uniform(0, 2 * np.pi, n_points)
            rad = rng.uniform(spread * 0.5, spread, n_points)
            z = rng.uniform(-spread * 0.4, spread * 0.4, n_points)
            self.points = np.stack([rad * np.cos(ang), z, rad * np.sin(ang)], axis=1).astype(
                np.float32)
        else:
            self.points = rng.uniform(-spread, spread, (n_points, 3)).astype(np.float32)
        self.desc = rng.integers(0, 2**32, (n_points, 8), dtype=np.uint32)
        self.feat_cap = feat_cap
        self.noise_px = noise_px
        self.desc_flips = desc_flips
        self.n_levels = n_levels
        self.max_depth = 50.0  # visibility range (m)

    def observe(self, cam, T_cw, max_feats=None):
        """Host Features of the camera at T_cw (SE3np, or SE3 of CPU
        tensors), and the world point id of each of the first n slots."""
        cap = self.feat_cap
        R, t = np.asarray(T_cw.R, np.float32), np.asarray(T_cw.t, np.float32)
        pc = (self.points @ R.T + t).astype(np.float32)
        uv = project_np(cam, pc).astype(np.float32)
        vis = ((pc[:, 2] > 0.3) & (pc[:, 2] < self.max_depth)
               & (uv[:, 0] >= 10) & (uv[:, 0] < cam.width - 10)
               & (uv[:, 1] >= 10) & (uv[:, 1] < cam.height - 10))
        idx = np.flatnonzero(vis)
        # a stable subsample: a real detector re-finds the same corners
        n = min(len(idx), max_feats or cap, cap)
        idx = idx[:n]
        uv_o = uv[idx] + self.rng.normal(0, self.noise_px, (n, 2))
        desc = self.desc[idx].copy()
        for _ in range(self.desc_flips):
            w = self.rng.integers(0, 8, n)
            b = self.rng.integers(0, 32, n)
            desc[np.arange(n), w] ^= np.uint32(1) << b.astype(np.uint32)
        feats = Features(
            uv=_pad(uv_o.astype(np.float32), cap), desc=_pad(desc, cap),
            angle=np.zeros(cap, np.float32), level=np.zeros(cap, np.int32),
            response=_pad(np.ones(n, np.float32), cap), valid=_pad(np.ones(n, bool), cap))
        return feats, idx


def _pad(a, n):
    if len(a) >= n:
        return a[:n]
    return np.concatenate([a, np.zeros((n - len(a), *a.shape[1:]), a.dtype)])
