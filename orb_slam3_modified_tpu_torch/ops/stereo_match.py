"""Stereo feature matching and the RGB-D depth lookup.

Port of orb_slam3_modified_tpu/ops/stereo_match.py (Frame::
ComputeStereoMatches, src/Frame.cc:811; ComputeStereoFishEyeMatches :1126;
ComputeStereoFromRGBD :984).

- `match_stereo` (rectified pairs): one (F_L, F_R) Hamming matrix, masked by
  the row band (2 * 1.2^max(level) px), the disparity range (0.1, bf/min_z)
  and |level_l - level_r| <= 1, then the first argmin per left feature,
  TH_HIGH and depth = bf / disparity. On CUDA tensors the matrix is the
  hand-written kernel's matrix entry (ops/hamming.py::hamming_matrix,
  csrc/hamming.cu), the masks and reductions are torch ops.
- `match_stereo_general` (non-rectified, e.g. KB8 fisheye): mutual best
  descriptor match on the same matrix entry, then two-view triangulation
  against the left -> right extrinsics and the reference's gates.
- `refine_disparity_sad`: SAD over shifted patches plus a parabola fit (off
  the main path, in the reference too).
- `depth_from_depthmap`: RGB-D depth at the keypoints, a gather.

`bf / x` is written as a tensor division: a Python scalar divided by a
tensor is a reciprocal and a product in torch, which rounds differently from
the reference's division.
"""
from __future__ import annotations

import torch

from ..cameras import Camera, unproject
from ..geom.triangulation import depth_and_reproj_checks, triangulate_rays
from ..lie.se3 import SE3
from .hamming import MAX_DIST, hamming_matrix
from .orientation import gather_patches

TH_HIGH = 100


def _div(num: float, den):
    """num / den in float32 as the reference rounds it (one division)."""
    return torch.full_like(den, num) / den


def match_stereo(uv_l, desc_l, level_l, valid_l, uv_r, desc_r, level_r, valid_r, bf: float,
                 min_z: float):
    """Match left -> right features of a rectified pair. bf: baseline * fx
    (the reference's mbf); min_z: the least depth (bf / the largest
    disparity). Returns (u_right (F,), depth (F,), valid (F,)), -1 where
    unmatched."""
    lvl = torch.maximum(level_l[:, None], level_r[None, :]).to(torch.float32)
    row_ok = torch.abs(uv_l[:, 1:2] - uv_r[None, :, 1]) <= 2.0 * torch.pow(1.2, lvl)
    disp = uv_l[:, 0:1] - uv_r[None, :, 0]  # positive for a valid pair
    disp_ok = (disp > 0.1) & (disp < bf / min_z)
    lvl_ok = torch.abs(level_l[:, None] - level_r[None, :]) <= 1
    allowed = valid_l[:, None] & valid_r[None, :] & row_ok & disp_ok & lvl_ok
    dm = torch.where(allowed, hamming_matrix(desc_l, desc_r), MAX_DIST)
    best = torch.argmin(dm, dim=1)
    bd = torch.gather(dm, 1, best[:, None])[:, 0]
    matched = bd < TH_HIGH
    u_r = torch.where(matched, uv_r[best, 0], -1.0)
    disparity = torch.where(matched, uv_l[:, 0] - u_r, -1.0)
    depth = torch.where(matched & (disparity > 0.1), _div(bf, torch.clamp(disparity, min=0.1)),
                        -1.0)
    return u_r, depth, matched & (depth > 0)


def refine_disparity_sad(img_l, img_r, uv_l, u_r, matched, half_w: int = 5, search: int = 5):
    """Sub-pixel u_r by SAD + parabola (the refinement of
    ComputeStereoMatches, src/Frame.cc:880): the (2w+1)^2 patch slides
    along the row around the match, the SAD minimum and its two neighbours
    fit a parabola. img_l, img_r (H, W) float32."""
    xs_l = uv_l[:, 0].to(torch.int32)
    ys = uv_l[:, 1].to(torch.int32)
    patch_l = gather_patches(img_l[None], ys[None], xs_l[None], half_w)[0]  # (N, S, S)
    base = u_r.to(torch.int32)
    costs = []
    for shift in range(-search, search + 1):
        xr = torch.clamp(base + shift, half_w, img_r.shape[1] - half_w - 1)
        patch_r = gather_patches(img_r[None], ys[None], xr[None], half_w)[0]
        costs.append(torch.sum(torch.abs(patch_l - patch_r), dim=(-2, -1)))
    costs = torch.stack(costs, dim=-1)  # (N, 2s+1)
    b = torch.clamp(torch.argmin(costs, dim=-1), 1, 2 * search - 1)
    c0 = torch.gather(costs, 1, (b - 1)[:, None])[:, 0]
    c1 = torch.gather(costs, 1, b[:, None])[:, 0]
    c2 = torch.gather(costs, 1, (b + 1)[:, None])[:, 0]
    denom = c0 + c2 - 2 * c1
    flat = torch.abs(denom) > 1e-6
    delta = torch.where(flat, 0.5 * (c0 - c2) / torch.where(flat, denom, 1.0), 0.0)
    u_refined = u_r + (b - search).to(torch.float32) + torch.clamp(delta, -1.0, 1.0)
    return torch.where(matched, u_refined, u_r)


def match_stereo_general(uv_l, desc_l, level_l, valid_l, uv_r, desc_r, level_r, valid_r,
                         cam_l: Camera, cam_r: Camera, R_rl, t_rl, max_dist: int = 50,
                         reproj_chi2: float = 5.991, max_parallax_cos: float = 0.9998):
    """Non-rectified stereo: mutual best descriptor match, then triangulation
    against the extrinsics (p_r = R_rl p_l + t_rl) with
    KannalaBrandt8::TriangulateMatches' depth / parallax / reprojection gates
    (include/CameraModels/KannalaBrandt8.h:78-86). Returns (depth (F,),
    valid (F,)): the left camera's depth, <= 0 where rejected."""
    dev, dt = uv_l.device, uv_l.dtype
    lvl_ok = torch.abs(level_l[:, None] - level_r[None, :]) <= 1
    dm = torch.where(valid_l[:, None] & valid_r[None, :] & lvl_ok,
                     hamming_matrix(desc_l, desc_r), MAX_DIST)
    best = torch.argmin(dm, dim=1)
    bd = torch.gather(dm, 1, best[:, None])[:, 0]
    mutual = torch.argmin(dm, dim=0)[best] == torch.arange(uv_l.shape[0], device=dev)
    matched = (bd < max_dist) & mutual & valid_l
    ray_l = unproject(cam_l, uv_l)
    ray_r = unproject(cam_r, uv_r[best])
    T_cw1 = SE3(torch.eye(3, dtype=dt, device=dev), torch.zeros(3, dtype=dt, device=dev))
    T_cw2 = SE3(torch.as_tensor(R_rl, dtype=dt).to(dev), torch.as_tensor(t_rl, dtype=dt).to(dev))
    pw = triangulate_rays(T_cw1.inverse(), T_cw2.inverse(), ray_l, ray_r)
    x1 = ray_l[..., :2] / torch.clamp(ray_l[..., 2:], min=1e-9)
    x2 = ray_r[..., :2] / torch.clamp(ray_r[..., 2:], min=1e-9)
    # unit-plane threshold: chi2 / focal^2
    thr = _div(reproj_chi2, torch.minimum(cam_l.params[0], cam_r.params[0]) ** 2)
    ok3d = depth_and_reproj_checks(T_cw1, T_cw2, pw, x1, x2, thr, max_parallax_cos)[0]
    depth = torch.where(matched & ok3d, pw[..., 2], -1.0)
    return depth, matched & ok3d & (pw[..., 2] > 0)


def depth_from_depthmap(uv, depth_map, depth_scale: float = 1.0):
    """RGB-D: the depth map at the keypoints' pixels (truncated, clipped),
    times depth_scale; -1 where it reads <= 0. uv (..., F, 2), depth_map
    (..., H, W) with the same leading axes (a chunk's K frames at once)."""
    h, w = depth_map.shape[-2:]
    x = torch.clamp(uv[..., 0].to(torch.int64), 0, w - 1)
    y = torch.clamp(uv[..., 1].to(torch.int64), 0, h - 1)
    flat = depth_map.reshape(*depth_map.shape[:-2], h * w)
    d = torch.gather(flat, -1, y * w + x) * depth_scale
    return torch.where(d > 0, d, -1.0)


def virtual_right(uv, depth, bf: float, valid=None):
    """RGB-D's virtual right coordinate uR = u - bf / z where the depth is
    valid (and valid, when given), else -1 (ComputeStereoFromRGBD)."""
    ok = depth > 0 if valid is None else (depth > 0) & valid
    return torch.where(ok, uv[..., 0] - _div(bf, torch.clamp(depth, min=1e-6)), -1.0)
