"""Rendered synthetic frames: a textured plane under a known trajectory.

Numpy port of camera_rays and render_textured_scene from
orb_slam3_modified_tpu/utils/synthetic_dataset.py.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..cameras import unproject, unproject_np
from ..tracking.fused import MapCache


def make_texture(seed: int = 0, small: int = 96, size: int = 1024) -> np.ndarray:
    """(size, size) float32 texture: seeded uniform noise at small x small,
    upsampled bicubically (the scene bench.py renders, without cv2)."""
    rng = np.random.default_rng(seed)
    tex = torch.from_numpy(rng.uniform(0, 255, (small, small)).astype(np.float32))
    up = F.interpolate(tex[None, None], size=(size, size), mode="bicubic", align_corners=False)
    return up[0, 0].numpy()


def seed_map_cache(cam, feats, T_cw, plane_z: float, cap: int) -> MapCache:
    """A map cache from keyframes of a rendered plane: each valid feature of
    feats (K, N) is back-projected through its keyframe's true pose T_cw (K)
    onto the plane z = plane_z; the first `cap` points are kept, the rest of
    the cache is invalid padding. Built on the features' device."""
    dev = feats.uv.device
    R = T_cw.R.to(dev)
    t = T_cw.t.to(dev)
    rays = unproject(cam, feats.uv)  # (K, N, 3) camera frame, z = 1
    d = torch.matmul(rays, R)  # world directions: R^T ray
    c = -torch.matmul(R.transpose(-1, -2), t[..., None])[..., 0]  # (K, 3)
    s = (plane_z - c[:, None, 2]) / d[..., 2]
    pos = c[:, None, :] + s[..., None] * d
    keep = (feats.valid & (s > 0)).reshape(-1)
    pos = pos.reshape(-1, 3)[keep][:cap]
    desc = feats.desc.reshape(-1, feats.desc.shape[-1])[keep][:cap]
    n = pos.shape[0]
    cache = MapCache(
        pos=torch.zeros((cap, 3), dtype=torch.float32, device=dev),
        desc=torch.zeros((cap, desc.shape[-1]), dtype=torch.int32, device=dev),
        valid=torch.zeros(cap, dtype=torch.bool, device=dev),
        mp_id=torch.full((cap,), -1, dtype=torch.int32, device=dev),
    )
    cache.pos[:n] = pos
    cache.desc[:n] = desc
    cache.valid[:n] = True
    cache.mp_id[:n] = torch.arange(n, dtype=torch.int32, device=dev)
    return cache


def camera_rays(cam):
    """(H*W, 3) unit-plane rays for every pixel (constant per camera)."""
    ys, xs = np.mgrid[0 : cam.height, 0 : cam.width]
    uv = np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.float32)
    return unproject_np(cam, uv)


def render_textured_scene(
    T_cw: np.ndarray,  # (4, 4) world->cam
    cam,
    texture: np.ndarray,  # (TH, TW) float32 texture on the z=plane_z plane
    plane_z: float = 6.0,
    plane_half: float = 12.0,
    rays_c: np.ndarray = None,  # optional precomputed camera_rays(cam)
):
    """Render a textured plane by inverse warping (plane z=plane_z in world;
    texture mapped over [-half, half]^2; background 20)."""
    h, w = cam.height, cam.width
    if rays_c is None:
        rays_c = camera_rays(cam)
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    c = -R.T @ t  # camera center
    d = rays_c @ R  # (N, 3) world dirs
    denom = d[:, 2]
    denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
    s = (plane_z - c[2]) / denom
    pw = c[None] + s[:, None] * d
    valid = (s > 0.1) & (np.abs(pw[:, 0]) < plane_half) & (np.abs(pw[:, 1]) < plane_half)
    th, tw = texture.shape
    pw = np.nan_to_num(pw)  # invalid rays are masked by `valid` below
    tx = ((pw[:, 0] + plane_half) / (2 * plane_half) * (tw - 1)).astype(np.int32)
    ty = ((pw[:, 1] + plane_half) / (2 * plane_half) * (th - 1)).astype(np.int32)
    tx = np.clip(tx, 0, tw - 1)
    ty = np.clip(ty, 0, th - 1)
    img = np.where(valid, texture[ty, tx], 20.0)
    return img.reshape(h, w).astype(np.float32)


def render_sequence(cam, T_cw, texture, plane_z: float = 2.0, plane_half: float = 10.0):
    """(F, H, W) uint8 frames of the textured plane seen from the poses T_cw
    (SE3 of F CPU tensors), as bench.py renders its headline scene."""
    rays = camera_rays(cam)
    frames = []
    for R, t in zip(T_cw.R.numpy(), T_cw.t.numpy()):
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        img = render_textured_scene(T, cam, texture, plane_z, plane_half, rays)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(frames)
