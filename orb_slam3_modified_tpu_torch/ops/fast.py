"""FAST-9/16 corner detection as dense maps.

Port of orb_slam3_modified_tpu/ops/fast.py: one dense pass computes a corner
response for every pixel from 16 shifted views of the image (torch.roll wraps
as jnp.roll does; the border mask hides the wrap), then a 3x3 non-maximum
suppression. Maps are (B, H, W) float32.

The contiguous-arc-of-9 test packs the 16 ring comparisons into one integer
per pixel and ANDs 9 shifted copies of the doubled mask. The reference packs
into uint32; torch's CPU build has no uint32 right shift, so the port packs
into int64, where the 32-bit doubled mask is non-negative and shifts are exact.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 (the standard FAST-16 ring, clockwise from top)
CIRCLE = (
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
ARC_LEN = 9  # FAST-9: at least 9 contiguous ring pixels all brighter/darker
BORDER = 3


def _ring_views(img):
    """(16, B, H, W): img shifted so ring pixel k aligns with its center."""
    return torch.stack(
        [torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1)) for dx, dy in CIRCLE]
    )


def _arc_ok(mask16):
    """mask16: (16, B, H, W) bool -> (B, H, W) bool: any 9 contiguous ring
    bits set (circular)."""
    bits = mask16[0].to(torch.int64)
    for k in range(1, 16):
        bits = bits | (mask16[k].to(torch.int64) << k)
    d = bits | (bits << 16)
    acc = d
    for k in range(1, ARC_LEN):
        acc = acc & (d >> k)
    return acc != 0


def border_mask(h, w, margin, device):
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)


def fast_score_maps(img, th_hi: float, th_lo: float):
    """Corner responses at both thresholds from one set of ring views.

    img: (B, H, W) float32. Returns (resp_hi, resp_lo), each (B, H, W)
    float32, 0 where not a corner; the score is the symmetric
    sum-of-exceedance of the reference."""
    diff = _ring_views(img) - img[None]
    border = border_mask(img.shape[-2], img.shape[-1], BORDER, img.device)

    def one(th):
        brighter = diff > th
        darker = diff < -th
        is_corner = _arc_ok(brighter) | _arc_ok(darker)
        sb = torch.sum(torch.where(brighter, diff - th, 0.0), dim=0)
        sd = torch.sum(torch.where(darker, -diff - th, 0.0), dim=0)
        score = torch.maximum(sb, sd)
        return torch.where(is_corner & border, score, 0.0)

    return one(th_hi), one(th_lo)


def fast_score_map(img, threshold: float):
    """Single-threshold corner response (see fast_score_maps)."""
    return fast_score_maps(img, threshold, threshold)[0]


def nonmax_3x3(resp):
    """3x3 non-maximum suppression on (B, H, W) maps; max_pool2d pads with
    -inf, as the reference's reduce_window does."""
    mx = F.max_pool2d(resp[:, None], kernel_size=3, stride=1, padding=1)[:, 0]
    return torch.where(resp >= mx, resp, 0.0)
