"""ORB feature extraction pipeline.

Port of orb_slam3_modified_tpu/features/extractor.py: 8-level pyramid (scale
1.2), FAST at the 20 -> 7 threshold fallback per 35 px cell, per-cell then
global top-k, intensity-centroid orientation and steered BRIEF-256 on the
Gaussian-blurred level. Outputs are fixed-capacity tensors with a validity
mask.

ORBExtractor is an nn.Module that holds the constants as buffers (BRIEF
pattern, centroid weights, Gaussian taps, per-level resize weights) and runs
each pyramid level as one pass over the whole batch of frames.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import resolve_device
from ..ops.brief import GATHER_R, brief_from_patches, brief_pattern
from ..ops.fast import border_mask, fast_score_maps, nonmax_3x3
from ..ops.image import gauss_kernel1d, gaussian_blur, pyramid_shapes, resize, resize_weights
from ..ops.orientation import centroid_weights, ic_angles_from_patches, patches_from_padded
from ..ops.select import cell_topk, global_topk

EDGE = 19  # ORB-SLAM3 EDGE_THRESHOLD border margin


class ExtractorConfig(NamedTuple):
    n_features: int = 1000
    n_levels: int = 8
    scale: float = 1.2
    ini_th: float = 20.0
    min_th: float = 7.0
    cell: int = 35
    k_per_cell: int = 4


class Features(NamedTuple):
    """Fixed-capacity feature set; every field may carry leading batch axes."""

    uv: torch.Tensor  # (..., N, 2) float32, level-0 pixel coords
    desc: torch.Tensor  # (..., N, 8) int32 packed BRIEF-256
    angle: torch.Tensor  # (..., N) float32 radians
    level: torch.Tensor  # (..., N) int32 pyramid octave
    response: torch.Tensor  # (..., N) float32
    valid: torch.Tensor  # (..., N) bool

    @property
    def capacity(self):
        return self.uv.shape[-2]


def level_budgets(cfg: ExtractorConfig):
    """Per-level feature counts: geometric split by 1/scale per level, the
    remainder to the coarsest level."""
    inv = 1.0 / cfg.scale
    n_desired = cfg.n_features * (1 - inv) / (1 - inv**cfg.n_levels)
    budgets = []
    acc = 0
    for lvl in range(cfg.n_levels - 1):
        b = int(round(n_desired * inv**lvl))
        budgets.append(b)
        acc += b
    budgets.append(max(cfg.n_features - acc, 0))
    return budgets


class ORBExtractor(nn.Module):
    """(B, H, W) uint8 or float32 frames -> batched Features."""

    def __init__(self, cfg: ExtractorConfig, height: int, width: int, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.height, self.width = height, width
        budgets = level_budgets(cfg)
        shapes = pyramid_shapes(height, width, cfg.n_levels, cfg.scale)
        # levels the reference skips: empty budget or too small for the patch
        self.levels = [
            (lvl, budgets[lvl], shp)
            for lvl, shp in enumerate(shapes)
            if budgets[lvl] and min(shp) > 2 * EDGE + 7
        ]

        def buf(name, arr):
            self.register_buffer(name, torch.as_tensor(arr).to(dev), persistent=False)

        buf("pattern", brief_pattern())
        wx, wy = centroid_weights()
        buf("centroid_wx", wx)
        buf("centroid_wy", wy)
        buf("gauss_taps", gauss_kernel1d(7, 2.0))
        for lvl, _, (lh, lw) in self.levels:
            if lvl:
                buf(f"resize_wy{lvl}", resize_weights(height, lh))
                buf(f"resize_wx{lvl}", resize_weights(width, lw))

    def _level(self, im, lvl, budget):
        cfg = self.cfg
        b, h, w = im.shape
        r_hi, r_lo = fast_score_maps(im, cfg.ini_th, cfg.min_th)
        border_ok = border_mask(h, w, EDGE, im.device)
        r_hi = torch.where(border_ok, nonmax_3x3(r_hi), 0.0)
        r_lo = torch.where(border_ok, nonmax_3x3(r_lo), 0.0)
        ys, xs, sc = cell_topk(r_hi, r_lo, cfg.cell, cfg.k_per_cell)
        ys, xs, sc, ok = global_topk(ys, xs, sc, budget)
        # one patch gather feeds orientation and descriptor: blurred 39x39
        # windows (the reference's deviation: IC angle on the blurred patch)
        blurred = gaussian_blur(im, self.gauss_taps)
        padded = F.pad(blurred, (GATHER_R, GATHER_R, GATHER_R, GATHER_R))
        patches = patches_from_padded(padded, ys, xs, 2 * GATHER_R + 1)
        ang = ic_angles_from_patches(patches, self.centroid_wx, self.centroid_wy)
        desc = brief_from_patches(patches, ang, self.pattern)
        s = cfg.scale**lvl
        uv = torch.stack([xs.to(torch.float32) * s, ys.to(torch.float32) * s], -1)
        level = torch.full((b, budget), lvl, dtype=torch.int32, device=im.device)
        return uv, desc, ang, level, sc, ok

    def forward(self, imgs) -> Features:
        if tuple(imgs.shape[-2:]) != (self.height, self.width):
            raise ValueError(
                f"frames of {tuple(imgs.shape[-2:])}, extractor built for "
                f"{(self.height, self.width)}"
            )
        imgs = imgs.to(torch.float32)
        parts = []
        for lvl, budget, _ in self.levels:
            im = imgs
            if lvl:
                im = resize(imgs, getattr(self, f"resize_wy{lvl}"), getattr(self, f"resize_wx{lvl}"))
            parts.append(self._level(im, lvl, budget))
        return Features(*(torch.cat(field, dim=1) for field in zip(*parts)))


def extract_batch(imgs, cfg: ExtractorConfig = ExtractorConfig()):
    """imgs (B, H, W) -> Features with a leading batch axis, on imgs' device."""
    return ORBExtractor(cfg, imgs.shape[-2], imgs.shape[-1], device=imgs.device)(imgs)


def extract(img, cfg: ExtractorConfig = ExtractorConfig()):
    """img (H, W) -> Features of one frame, on img's device."""
    return Features(*(f[0] for f in extract_batch(img[None], cfg)))
