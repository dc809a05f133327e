"""Image-level ops: pyramid weights and separable Gaussian blur.

Port of orb_slam3_modified_tpu/ops/image.py. Images are float32 (B, H, W)
in [0, 255].

The reference builds each pyramid level with jax.image.resize(...,
"bilinear"), which antialiases when it downsamples: its kernel is a triangle
stretched by the inverse scale, normalised per output sample. Neither
F.interpolate mode reproduces it (antialias=False is off by up to 73 grey
levels; antialias=True by ~2e-3, enough to flip FAST threshold tests). So the
port rebuilds the same separable weight matrices in numpy, in the reference's
float32 arithmetic, and applies them as Wy @ img @ Wx^T.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def pyramid_shapes(h: int, w: int, n_levels: int, scale: float):
    """Static (h, w) per level, mirroring cvRound(h/scale^l)."""
    return [
        (int(round(h / scale**lvl)), int(round(w / scale**lvl)))
        for lvl in range(n_levels)
    ]


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) float32 weights of an antialiased triangle resize.

    Same arithmetic as jax.image.resize(method="bilinear", antialias=True):
    sample positions and distances in float32, the kernel widened by
    1/scale when downsampling, columns normalised to sum 1, and samples
    outside the input zeroed.
    """
    scale = out_size / in_size
    inv_scale = np.float32(1.0 / scale)
    kernel_scale = np.maximum(inv_scale, np.float32(1.0))
    sample_f = (np.arange(out_size, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=np.float32)[:, None]) / kernel_scale
    weights = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True, dtype=np.float32)
    eps = np.float32(1000.0 * np.finfo(np.float32).eps)
    weights = np.where(
        np.abs(total) > eps, weights / np.where(total != 0, total, np.float32(1.0)), 0
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    weights = np.where(inside[None, :], weights, 0)
    return np.ascontiguousarray(weights.T.astype(np.float32))


def resize(imgs, wy, wx):
    """(B, H, W) -> (B, h, w) with weights wy (h, H), wx (w, W)."""
    return torch.matmul(torch.matmul(wy, imgs), wx.transpose(0, 1))


def gauss_kernel1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    k /= k.sum()
    return k.astype(np.float32)


def gaussian_blur(imgs, taps):
    """Separable blur with reflect padding; imgs (B, H, W), taps (k,) float32.

    The taps are accumulated one shifted slice at a time, in the reference's
    order, so the float32 sums round as the reference's do."""
    ksize = taps.shape[0]
    r = ksize // 2
    h, w = imgs.shape[-2:]
    a = F.pad(imgs, (0, 0, r, r), mode="reflect")
    out = taps[0] * a[..., 0:h, :]
    for i in range(1, ksize):
        out = out + taps[i] * a[..., i : i + h, :]
    a = F.pad(out, (r, r, 0, 0), mode="reflect")
    out = taps[0] * a[..., :, 0:w]
    for i in range(1, ksize):
        out = out + taps[i] * a[..., :, i : i + w]
    return out
