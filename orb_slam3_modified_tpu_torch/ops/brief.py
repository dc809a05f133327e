"""Rotated (steered) BRIEF-256 descriptors.

Port of orb_slam3_modified_tpu/ops/brief.py: 256 intensity comparisons on a
blurred patch, sampled bilinearly along the keypoint orientation. The pattern
is the reference's Gaussian BRIEF pairs (numpy, seed 0xB51EF), regenerated
bit for bit.

The reference samples with hat-weight matmuls (a TPU device); the port reads
the four neighbours by index. Each sample is still the sum of the same two
row terms and two column terms with the reference's hat weights, but the
summation may round differently (fused multiply-adds), so a comparison
v0 < v1 whose two sides differ by less than ~1e-3 grey levels can flip.

Descriptors are (..., 8) int32 holding the same 256 bits as the reference's
(..., 8) uint32 (torch's CPU build lacks uint32 shifts); bits are packed in
int64 and wrapped into int32.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .orientation import gather_patches

N_BITS = 256
N_WORDS = 8  # 32-bit words per descriptor
PATTERN_R = 13  # pattern coordinate range
GATHER_R = 19  # patch radius gathered (covers rotation of +-13 * sqrt2 = 18.4)
PATCH = 2 * GATHER_R + 1  # 39


@functools.lru_cache(maxsize=1)
def brief_pattern():
    """(256, 2 endpoints, xy) float32 numpy pattern."""
    rng = np.random.default_rng(0xB51EF)
    pts = rng.normal(0.0, PATTERN_R / 2.0, size=(N_BITS, 2, 2))
    pts = np.clip(pts, -PATTERN_R, PATTERN_R)
    return pts.astype(np.float32)


def _sample_bilinear(patches, sy, sx):
    """Bilinear-sample patches (..., S, S) at float coords (..., K) in patch
    units, clipped to the patch. Returns (..., K) float32."""
    s = patches.shape[-1]
    sy = torch.clamp(sy, 0.0, s - 1.0)
    sx = torch.clamp(sx, 0.0, s - 1.0)
    y0f = torch.floor(sy)
    x0f = torch.floor(sx)
    # hat weights exactly as the reference forms them: max(0, 1 - |s - r|)
    wy0 = torch.clamp(1.0 - torch.abs(sy - y0f), min=0.0)
    wy1 = torch.clamp(1.0 - torch.abs(sy - (y0f + 1.0)), min=0.0)
    wx0 = torch.clamp(1.0 - torch.abs(sx - x0f), min=0.0)
    wx1 = torch.clamp(1.0 - torch.abs(sx - (x0f + 1.0)), min=0.0)
    y0 = y0f.long()
    x0 = x0f.long()
    y1 = torch.clamp(y0 + 1, max=s - 1)
    x1 = torch.clamp(x0 + 1, max=s - 1)
    flat = patches.flatten(-2)

    def at(y, x):
        return flat.gather(-1, y * s + x)

    col0 = wy0 * at(y0, x0) + wy1 * at(y1, x0)
    col1 = wy0 * at(y0, x1) + wy1 * at(y1, x1)
    return col0 * wx0 + col1 * wx1


def brief_values(patches, angles, pattern):
    """Sampled intensities (..., 256, 2) of both pattern endpoints.

    patches: (..., PATCH, PATCH) blurred, keypoint at the exact center;
    angles: (...) radians; pattern: (256, 2, 2) tensor."""
    ca, sa = torch.cos(angles), torch.sin(angles)
    px = pattern[..., 0]
    py = pattern[..., 1]
    rx = ca[..., None, None] * px - sa[..., None, None] * py
    ry = sa[..., None, None] * px + ca[..., None, None] * py
    center = (patches.shape[-1] - 1) / 2.0
    lead = angles.shape
    sy = ry.reshape(*lead, -1) + center  # (..., 512)
    sx = rx.reshape(*lead, -1) + center
    return _sample_bilinear(patches, sy, sx).reshape(*lead, N_BITS, 2)


def pack_bits(bits):
    """(..., 256) bool -> (..., 8) int32, bit k of word w = bits[32 w + k]."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = torch.sum(
        bits.to(torch.int64).reshape(*bits.shape[:-1], N_WORDS, 32) << shifts, dim=-1
    )
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def brief_from_patches(patches, angles, pattern):
    """Packed descriptors (..., 8) int32 from blurred patches."""
    vals = brief_values(patches, angles, pattern)
    return pack_bits(vals[..., 0] < vals[..., 1])


def brief_descriptors(img_blurred, ys, xs, angles):
    """Descriptors (B, N, 8) int32; img_blurred (B, H, W), ys/xs/angles (B, N)."""
    pattern = torch.from_numpy(brief_pattern()).to(img_blurred.device)
    patches = gather_patches(img_blurred, ys, xs, GATHER_R)
    return brief_from_patches(patches, angles, pattern)
