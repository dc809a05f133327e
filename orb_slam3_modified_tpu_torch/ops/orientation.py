"""Keypoint patch gather + orientation by intensity centroid.

Port of orb_slam3_modified_tpu/ops/orientation.py: angle = atan2(m01, m10)
over a radius-15 circular patch (ORB-SLAM3 IC_Angle, src/ORBextractor.cc:76).
The reference gathers patch columns with a one-hot matmul, a TPU device; on
the card the port gathers by index arithmetic, which reads the same values.
Batched over a leading image axis: images (B, H, W), keypoints (B, N).
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

PATCH_R = 15
PATCH = 2 * PATCH_R + 1


@functools.lru_cache(maxsize=4)
def centroid_weights(patch_r: int = PATCH_R):
    """(wx, wy) numpy float32 moment weights over the circular patch."""
    ys, xs = np.mgrid[-patch_r : patch_r + 1, -patch_r : patch_r + 1]
    mask = (xs * xs + ys * ys) <= patch_r * patch_r
    return (xs * mask).astype(np.float32), (ys * mask).astype(np.float32)


def patches_from_padded(padded, y0, x0, size: int):
    """(B, N, size, size) windows of a pre-padded image (B, Hp, Wp); (y0, x0)
    (B, N) is the window origin in padded coords."""
    b, _, wp = padded.shape
    ar = torch.arange(size, device=padded.device)
    rows = (y0.long()[..., None] + ar)[..., :, None] * wp
    cols = (x0.long()[..., None] + ar)[..., None, :]
    flat = (rows + cols).reshape(b, -1)
    return padded.reshape(b, -1).gather(1, flat).reshape(*y0.shape, size, size)


def gather_patches(img, ys, xs, half: int):
    """(B, N, 2h+1, 2h+1) patches centered at integer coords; the image is
    zero-padded by `half`, so border pixels read 0."""
    padded = F.pad(img, (half, half, half, half))
    return patches_from_padded(padded, ys, xs, 2 * half + 1)


def ic_angles_from_patches(patches, wx, wy, patch_r: int = PATCH_R):
    """Orientation from square patches (..., S, S), S >= 2*patch_r+1; the
    moments run over the centered (2*patch_r+1)^2 sub-patch."""
    s = patches.shape[-1]
    off = (s - (2 * patch_r + 1)) // 2
    sub = patches[..., off : off + 2 * patch_r + 1, off : off + 2 * patch_r + 1]
    m10 = torch.sum(sub * wx, dim=(-2, -1))
    m01 = torch.sum(sub * wy, dim=(-2, -1))
    return torch.atan2(m01, m10)


def ic_angles(img, ys, xs):
    """Orientation (radians) for keypoints at integer coords; img (B, H, W)."""
    wx, wy = (torch.from_numpy(w).to(img.device) for w in centroid_weights())
    return ic_angles_from_patches(gather_patches(img, ys, xs, PATCH_R), wx, wy)
