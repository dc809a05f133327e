"""Monocular depth + segmentation network for semantic reconstruction.

Port of orb_slam3_modified_tpu/models/depth.py (DepthSegNet :39-69,
load_depth_model, make_depth_fn, make_seg_fn, default_depth_model), the
package's stand-in for the fork's ZoeDepth depth and OneFormer segmentation
(depth_estimate/predict_depth.py, image_segmentation/oneformer/; both feed
mono_semantic, README.md:247-267): a small U-Net trained on the synthetic
renderer's exact depth and surface masks, gray image -> metric depth map
and per-pixel class logits (background 0, surface 1).

The flax module becomes an nn.Module with the same arithmetic: 3x3
convolutions with SAME (1-pixel) padding, NCHW where flax is NHWC (the
decoder concatenates the upsampled map before the skip, as flax does), the
tanh GELU (flax nn.gelu's default), 2x2 average pools, and bilinear resizes
with half-pixel centres that antialias when they shrink (jax.image.resize's
"bilinear"; F.interpolate(antialias=True)). The depth head is
1 / (softplus + 1 / max_depth). It holds no TPU kernel: its convolutions
are flax nn.Conv compiled by XLA in the reference, F.conv2d here (TF32 off,
as the package sets it).

Weights: assets/depth_seg_net.npz holds the state_dict as plain named
arrays and the reference's meta strings; scripts/convert_depth_net.py makes
it from the reference's flax asset (convert.depth_net_state_dict). Against
the flax net on the CPU (tests/test_torch_depth.py): depth within 2e-5
relative (measured 2.4e-6) at 96x128 and through make_depth_fn at 480x752,
logits within 1e-4, class maps equal wherever the two logits are more than
1e-3 apart (measured: equal everywhere).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .. import resolve_device

ASSET = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets", "depth_seg_net.npz")


def _resize(x, size):
    """jax.image.resize(..., "bilinear") on (B, C, H, W)."""
    return F.interpolate(x, size=tuple(size), mode="bilinear", align_corners=False,
                         antialias=True)


class _ConvBlock(nn.Module):
    def __init__(self, cin: int, ch: int):
        super().__init__()
        self.conv0 = nn.Conv2d(cin, ch, 3, padding=1)
        self.conv1 = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        x = F.gelu(self.conv0(x), approximate="tanh")
        return F.gelu(self.conv1(x), approximate="tanh")


class DepthSegNet(nn.Module):
    """Tiny U-Net: 3 down levels + skips; joint depth + seg heads."""

    def __init__(self, base: int = 16, n_classes: int = 2, max_depth: float = 30.0):
        super().__init__()
        b = base
        self.max_depth = max_depth
        # flax's creation order: e0, e1, e2, bottleneck, d2, d1, d0
        self.blocks = nn.ModuleList([
            _ConvBlock(1, b), _ConvBlock(b, 2 * b), _ConvBlock(2 * b, 4 * b),
            _ConvBlock(4 * b, 8 * b), _ConvBlock(12 * b, 4 * b), _ConvBlock(6 * b, 2 * b),
            _ConvBlock(3 * b, b),
        ])
        self.inv_head = nn.Conv2d(b, 1, 3, padding=1)  # flax Conv_0
        self.seg_head = nn.Conv2d(b, n_classes, 3, padding=1)  # flax Conv_1

    def forward(self, x):
        """x: (B, 1, H, W) in [0, 1], H and W multiples of 8 -> (depth (B,
        H, W) meters, seg logits (B, n_classes, H, W))."""
        blk = self.blocks
        e0 = blk[0](x)
        e1 = blk[1](F.avg_pool2d(e0, 2))
        e2 = blk[2](F.avg_pool2d(e1, 2))
        z = blk[3](F.avg_pool2d(e2, 2))
        for skip, block in ((e2, blk[4]), (e1, blk[5]), (e0, blk[6])):
            z = block(torch.cat([_resize(z, skip.shape[-2:]), skip], dim=1))
        inv = self.inv_head(z)[:, 0]
        # inverse-depth parameterization (near resolution where it matters)
        depth = 1.0 / (F.softplus(inv) + 1.0 / self.max_depth)
        return depth, self.seg_head(z)


def load_depth_model(path: str, device="cuda"):
    """(DepthSegNet with the file's weights on `device`, in eval mode; meta
    dict of strings)."""
    dev = resolve_device(device)
    with np.load(path) as d:
        meta = dict(str(kv).split("=", 1) for kv in d["meta"]) if "meta" in d.files else {}
        state = {k: torch.from_numpy(d[k]) for k in d.files if k != "meta"}
    net = DepthSegNet(base=int(meta.get("base", 16)), n_classes=int(meta.get("n_classes", 2)),
                      max_depth=float(meta.get("max_depth", 30.0)))
    net.load_state_dict(state)
    return net.to(dev).eval(), meta


def _run_at_train_res(net: DepthSegNet, img, train_hw):
    """Resize to the net's training resolution, run, resize the maps back:
    (depth (H, W), seg logits (C, H, W)) on the net's device. The net is
    trained at one (H, W) with matched intrinsics; running it at the native
    resolution would change the per-pixel field of view it learned."""
    dev = next(net.parameters()).device
    x = torch.as_tensor(np.asarray(img, np.float32), device=dev)[None, None] / 255.0
    h, w = x.shape[-2:]
    with torch.inference_mode():
        depth, seg = net(_resize(x, train_hw))
        return _resize(depth[:, None], (h, w))[0, 0], _resize(seg, (h, w))[0]


def make_depth_fn(net: DepthSegNet, train_hw=(96, 128)):
    """image (H, W) uint8 / float grey levels -> metric depth (H, W) float32
    numpy: the depth_fn plug of recon.cloud.semantic_cloud."""
    return lambda img: _run_at_train_res(net, img, train_hw)[0].cpu().numpy()


def make_seg_fn(net: DepthSegNet, train_hw=(96, 128)):
    """image (H, W) -> class map (H, W) int32 numpy (the first class of a tie)."""
    return lambda img: (torch.argmax(_run_at_train_res(net, img, train_hw)[1], dim=0)
                        .to(torch.int32).cpu().numpy())


def default_depth_model(device="cuda"):
    """The package's trained model (assets/depth_seg_net.npz) as (net, meta),
    or None if the asset is absent."""
    if not os.path.exists(ASSET):
        return None
    return load_depth_model(ASSET, device)
