"""Relocalization: BoW candidates, then batched PnP RANSAC and a robust polish.

Port of orb_slam3_modified_tpu/loop/relocalization.py
(Tracking::Relocalization, src/Tracking.cc:3612:
DetectRelocalizationCandidates -> SearchByBoW -> MLPnPsolver RANSAC ->
PoseOptimization). The minimal solver is a 6-point DLT of the projection
matrix, all N_HYP hypotheses as one batched eigendecomposition on the
inputs' device, then rotation orthonormalization and the IRLS-LM polish of
optim/pose_opt.py.

The descriptor match is features/matcher.py::mutual_best_match without a
mask at (F, F): on CUDA tensors the fused entry of csrc/hamming.cu. The
minimal sets come from loop/sim3_solver.py::_sample_minimal_sets (a CPU
generator seeded with the frame id, uploaded), one function for both
RANSACs. torch.linalg.eigh returns eigenvectors of either sign; the DLT
fixes the sign by det(M) > 0, so the pose does not depend on it. A^T A
squares the DLT's condition number, so its eigenvector is taken in float64:
in float32 the reference's (XLA's) and torch's solvers each stray from the
exact DLT pose of the same six points, each its own way.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..cameras import Camera, unproject
from ..features.matcher import TH_LOW, mutual_best_match, resolve_duplicate_targets
from ..lie import so3
from ..lie.se3 import SE3, SE3np
from ..optim.pose_opt import pose_optimization
from ..slam_map.map_state import NO_POINT
from ..tracking.tracker import _pad1
from ..utils.fetch import fetch, upload
from . import sim3_solver

N_HYP = 128
MIN_SET = 6
PNP_CAP = 512  # associations per PnP problem (static shape)


class PnPResult(NamedTuple):
    success: torch.Tensor
    T_cw: SE3
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _p6p_dlt(pw, rays):
    """Batched 6-point DLT: pw (..., 6, 3) world points, rays (..., 6, 2)
    unit-plane observations. The projection matrix is the eigenvector of
    A^T A's smallest eigenvalue. Returns (R (..., 3, 3), t (..., 3))."""
    x, y = rays[..., 0], rays[..., 1]
    X = torch.cat([pw, torch.ones_like(pw[..., :1])], dim=-1)  # (..., 6, 4)
    zeros = torch.zeros_like(X)
    r1 = torch.cat([X, zeros, -x[..., None] * X], dim=-1)  # [X 0 -xX]
    r2 = torch.cat([zeros, X, -y[..., None] * X], dim=-1)  # [0 X -yX]
    A = torch.cat([r1, r2], dim=-2)  # (..., 12, 12)
    A = A.to(torch.float64)
    AtA = torch.einsum("...ji,...jk->...ik", A, A)
    p = torch.linalg.eigh(AtA)[1][..., :, 0].to(pw.dtype)
    P = p.reshape(*p.shape[:-1], 3, 4)
    M = P[..., :3]
    # sign and scale: det(M) > 0, rows of unit norm on average
    sign = torch.where(torch.linalg.det(M) < 0, -1.0, 1.0)
    M = M * sign[..., None, None]
    p4 = P[..., 3] * sign[..., None]
    scale = torch.clamp(torch.linalg.det(M), min=1e-12) ** (1.0 / 3.0)
    return so3.normalize(M / scale[..., None, None]), p4 / scale[..., None]


def pnp_ransac(cam: Camera, pw, uv, valid, key: int, err_px: float = 5.99,
               min_inliers: int = 15) -> PnPResult:
    """Batched-hypothesis PnP: pw (N, 3) world points, uv (N, 2) pixels,
    valid (N,) bool; key seeds the minimal sets."""
    rays = unproject(cam, uv)
    rays2 = rays[..., :2] / rays[..., 2:3]
    idx = sim3_solver._sample_minimal_sets(key, valid, N_HYP, MIN_SET).to(pw.device)
    R, t = _p6p_dlt(pw[idx], rays2[idx])  # (H, 3, 3), (H, 3)
    pc = torch.einsum("hij,nj->hni", R, pw) + t[:, None]
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    proj = pc[..., :2] / zs[..., None]
    f = cam.params[0]
    err = torch.sum((proj - rays2[None]) ** 2, dim=-1) * (f * f)
    inl = valid[None] & (z > 0) & (err < err_px)
    n_inl = inl.sum(dim=-1)
    best = torch.argmax(n_inl)
    return PnPResult(n_inl[best] >= min_inliers, SE3(R[best], t[best]), inl[best], n_inl[best])


def relocalize(cam: Camera, kfdb, voc, slam_map, feats, inv_s2_levels, frame_key: int,
               max_candidates: int = 5, feats_dev=None):
    """One relocalization attempt of a frame against the keyframe database.

    cam: the camera on the solving device; feats: the frame's host Features
    (uint32 descriptors); feats_dev: the same on the device (uploaded here
    when None). Returns (T_cw SE3np, obs_mp (F,) int32) or None."""
    m = slam_map
    dev = cam.params.device
    if feats_dev is None:
        feats_dev = (upload(np.ascontiguousarray(feats.desc, np.uint32).view(np.int32), dev),
                     upload(np.asarray(feats.valid, bool), dev))
    else:
        feats_dev = (feats_dev.desc, feats_dev.valid)
    desc_np = np.asarray(feats.desc)
    valid_np = np.asarray(feats.valid)
    uv_np = np.asarray(feats.uv)
    level_np = np.asarray(feats.level)
    words = voc.transform_np(desc_np[valid_np])
    F = len(valid_np)
    for c in kfdb.query(words, exclude=set(), n_best=max_candidates):
        c = int(c)
        if not m.kf_valid[c]:
            continue
        slots, mps = m.observations_of_kf(c)
        if len(mps) < 15:
            continue
        vk = np.zeros(F, bool)
        vk[: min(len(slots), F)] = True
        idx, ok, dist = mutual_best_match(
            upload(_pad1(m.kf_desc[c, slots], F).view(np.int32), dev), upload(vk, dev),
            *feats_dev, max_dist=TH_LOW, ratio=0.75)
        idx_np, keep_np = fetch((idx, resolve_duplicate_targets(idx, ok, dist, F)))
        keep_np[len(slots):] = False
        if keep_np.sum() < 15:
            continue
        sel = np.flatnonzero(keep_np)[:PNP_CAP]
        mp = mps[sel]
        f_slot = idx_np[sel]
        n = len(mp)
        res = pnp_ransac(cam, upload(_pad1(m.mp_pos[mp], PNP_CAP), dev),
                         upload(_pad1(uv_np[f_slot], PNP_CAP), dev),
                         upload(np.arange(PNP_CAP) < n, dev), frame_key)
        ok_np, inl, R0, t0 = fetch((res.success, res.inliers, res.T_cw.R, res.T_cw.t))
        if not bool(ok_np):
            continue
        # polish with the robust pose solve on the inlier set
        inl = inl[:n]
        n_in = int(inl.sum())
        popt = pose_optimization(
            SE3(upload(R0, dev), upload(t0, dev)), cam,
            upload(_pad1(m.mp_pos[mp[inl]], PNP_CAP), dev),
            upload(_pad1(uv_np[f_slot[inl]], PNP_CAP), dev),
            upload(_pad1(inv_s2_levels[level_np[f_slot[inl]]], PNP_CAP, 1.0), dev),
            valid=upload(np.arange(PNP_CAP) < n_in, dev))
        R, t, good, n_good = fetch((popt.T_cw.R, popt.T_cw.t, popt.inliers, popt.n_inliers))
        if int(n_good) < 15:
            continue
        obs = np.full(F, NO_POINT, np.int32)
        good = good[:n_in]
        obs[f_slot[inl][good]] = mp[inl][good]
        return SE3np(R, t), obs
    return None
