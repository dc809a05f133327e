"""Fused visual-inertial tracking step.

Port of orb_slam3_modified_tpu/tracking/vi_fused.py, the inertial analog of
tracking/fused.py for the chunked frontend. Per frame (VITrackStep):

- the frame's preintegration at the carried bias (PreintegrateIMU,
  src/Tracking.cc:1627),
- the IMU prediction of the pose (PredictStateIMU, :1741),
- two windowed Hamming mutual-best-match passes (radius 15 then 4 px per
  octave, the fused kernel) each followed by the joint {previous, current}
  30-D visual-inertial frame solve with the carried 15-D marginal prior
  (PoseInertialOptimizationLastFrame + Marginalize, src/Optimizer.cc:4875 /
  :2960, optim/vi_pose_opt.py), over the matched rows compacted to the front,
- a brute-force recovery pass under a weak prior when the second pass keeps
  fewer than 25 inliers,
- the acceptance gate, the trace cap of the carried marginal, and the
  per-feature cache association,

carrying {pose, velocity, bias, marginal} in VITrackState. A rejected frame
keeps the IMU prediction: in-chunk dead reckoning, the tracker's
RECENTLY_LOST hold (src/Tracking.cc:1984-2016).

Two departures from the reference's form, neither of its results:
- The reference integrates each frame's samples inside its lax.scan at the
  carried bias. The port integrates a chunk's frames in one batched loop
  (imu/preintegration.py::integrate, which takes the (K, S) batches the
  reference's integrate_chunk vmaps) at
  the bias the chunk starts from, and each frame's interval is moved to the
  carried bias to first order (preintegration.rebias, ORB-SLAM3's own
  update of a preintegration whose bias changed): the bias moves by a
  random walk between frames, so the change is second order in it.
- The reference's lax.cond recovery becomes tracking/fused.py's host-read
  gate (the pass runs only when a frame needs it), and its branch-free
  torch.where form while a CUDA graph is being captured.

One departure of result: a carried marginal that is not positive definite
is replaced by the near-fixed anchor. The reference carries it, its next
solve's prior Cholesky factor turns NaN, and every solve returns its seed
(the IMU prediction) until a keyframe resets the prior; the port's factor
(cholesky_ex) would be a partial one instead. tests/test_torch_vi_chunked.py
shows such a frame.

The three VI chunk steps sit beside their visual siblings in
tracking/chunked.py. merge_np and pre_slice_np are the host retire loop's
numpy helpers; the reference's integrate_chunk is integrate itself, which
takes leading batch axes.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..cameras import Camera, project
from ..features.matcher import (
    TH_HIGH, TH_LOW, mutual_best_match, resolve_duplicate_targets, windowed_mutual_best_match,
)
from ..imu.preintegration import ImuBias, Preintegrated, predict_state, rebias
from ..lie.se3 import SE3
from ..optim.vi_pose_opt import _body_from_cam, _cam_from_body, vi_pose_optimization_marg
from .fused import CACHE_CAP, MapCache, _branch_free

# near-fixed anchor information used when a frame's solve fails and the
# carried marginal is not trustworthy (the tracker's _FIXED_ANCHOR_INFO)
_FIXED_INFO = np.diag(
    np.concatenate([np.full(6, 1e6), np.full(3, 1e4), np.full(6, 1e4)])).astype(np.float32)

# the weak anchor of the recovery solve: after a background map correction
# the dead-reckoned prediction can be decimeters off, and a near-fixed prior
# would pin the pose to it through the stiff IMU factor; pose and velocity
# go free (the bias stays pinned) so the brute matches can pull the state
# onto the corrected map (the analog of the prior-free
# TrackReferenceKeyFrame fallback, src/Tracking.cc:2723)
_WEAK_INFO = np.diag(
    np.concatenate([np.full(6, 1e-1), np.full(3, 1.0), np.full(6, 1e4)])).astype(np.float32)


class VITrackState(NamedTuple):
    R: torch.Tensor  # (3, 3) camera T_cw
    t: torch.Tensor  # (3,)
    v_w: torch.Tensor  # (3,) body velocity in world
    bg: torch.Tensor  # (3,) gyro bias (absolute)
    ba: torch.Tensor  # (3,)
    H_prior: torch.Tensor  # (15, 15) marginal information on the current state
    ok: torch.Tensor  # () bool


class VIStepOutput(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    v_w: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    n_inliers: torch.Tensor  # () int32; -n_inliers - 1 where the solve was rejected
    obs_cache_idx: torch.Tensor  # (F,) int32 cache index per feature or -1
    pre: Preintegrated  # the frame's preintegration (the host merges it per keyframe)


def _pick(use, a, b):
    """torch.where(use, a, b) over every field of two VIMargResults."""
    return type(a)(*(
        SE3(torch.where(use, x.R, y.R), torch.where(use, x.t, y.t)) if isinstance(x, SE3)
        else torch.where(use, x, y) for x, y in zip(a, b)))


class VITrackStep(nn.Module):
    """(state, cache, features, pre) -> (state, out) for one frame; pre: the
    frame's preintegration at any bias (moved to the carried one here).
    bf > 0 and f_ur add the rectified-stereo uR rows (the stereo and RGB-D
    VI steps)."""

    def __init__(self, cam: Camera, inv_s2_levels, feat_cap: int, imu_cfg, iters: int = 6,
                 bf: float = 0.0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.kind, self.width, self.height = cam.kind, cam.width, cam.height
        self.register_buffer("cam_params", cam.params.to(dev), persistent=False)

        def buf(name, a):
            self.register_buffer(name, torch.as_tensor(np.asarray(a, np.float32)).to(dev),
                                 persistent=False)

        buf("inv_s2_levels", inv_s2_levels)
        buf("R_bc", np.eye(3) if imu_cfg.R_bc is None else imu_cfg.R_bc)
        buf("t_bc", np.zeros(3) if imu_cfg.t_bc is None else imu_cfg.t_bc)
        buf("fixed_info", _FIXED_INFO)
        buf("weak_info", _WEAK_INFO)
        self.feat_cap = feat_cap
        self.iters = iters
        self.bf = float(bf)

    @property
    def cam(self):
        return Camera(self.kind, self.cam_params, self.width, self.height)

    def forward(self, state: VITrackState, cache: MapCache, f_uv, f_desc, f_level, f_valid,
                pre: Preintegrated, f_ur=None):
        cam = self.cam
        dev = f_uv.device
        stereo = f_ur is not None and self.bf > 0
        bf = torch.full((), self.bf, device=dev) if stereo else None
        n_lvl = self.inv_s2_levels.shape[0]
        R_bc, t_bc = self.R_bc, self.t_bc
        # this frame's interval at the carried bias, then the IMU prediction
        # from the previous frame's body state
        bias = ImuBias(state.bg, state.ba)
        pre = rebias(pre, bias)
        R_wb_prev, p_wb_prev = _body_from_cam(state.R, state.t, R_bc, t_bc)
        R_wb_pred, v_pred, p_wb_pred = predict_state(R_wb_prev, state.v_w, p_wb_prev, pre, bias)
        T_pred = SE3(*_cam_from_body(R_wb_pred, p_wb_pred, R_bc, t_bc))

        def match(T, radius_scale):
            pc = T.apply(cache.pos)
            uv_pred = project(cam, pc)
            in_view = (
                cache.valid
                & (pc[..., 2] > 0.05)
                & (uv_pred[..., 0] >= -20)
                & (uv_pred[..., 0] < cam.width + 20)
                & (uv_pred[..., 1] >= -20)
                & (uv_pred[..., 1] < cam.height + 20)
            )
            r = radius_scale * torch.pow(1.2, f_level.to(torch.float32))
            idx, okm, dist = windowed_mutual_best_match(
                cache.desc, in_view, f_desc, f_valid, uv_pred, f_uv, r, max_dist=TH_HIGH,
                ratio=0.9,
            )
            return idx, resolve_duplicate_targets(idx, okm, dist, self.feat_cap)

        # the solve runs over a compacted row set: each feature claims at
        # most one cache row, so the matched rows gathered to the front lose
        # nothing and the visual block shrinks ~cache / feat_cap times
        n_rows = min(self.feat_cap, CACHE_CAP)

        def vi_solve(T_seed, idx, keep, H_prior=None, it=None):
            sel = torch.argsort(-keep.to(torch.int32), stable=True)[:n_rows]  # matched first
            idx_s = idx[sel]
            inv_s2 = self.inv_s2_levels[torch.clamp(f_level[idx_s], 0, n_lvl - 1)]
            res = vi_pose_optimization_marg(
                T_seed, cam, cache.pos[sel], f_uv[idx_s], inv_s2, keep[sel], R_wb_prev,
                p_wb_prev, state.v_w, state.H_prior if H_prior is None else H_prior,
                pre.dT, pre.dR, pre.dV, pre.dP, pre.JRg, pre.JVg, pre.JVa, pre.JPg, pre.JPa,
                C=pre.C, iters=self.iters if it is None else it, R_bc=R_bc, t_bc=t_bc,
                ur_obs=f_ur[idx_s] if stereo else None, bf=bf,
            )
            # the inliers back on the full cache rows
            inl = torch.zeros_like(keep).index_put((sel,), res.inliers)
            return res._replace(inliers=inl)

        idx1, keep1 = match(T_pred, 15.0)
        res1 = vi_solve(T_pred, idx1, keep1)
        idx2, keep2 = match(res1.T_cw, 4.0)
        res2 = vi_solve(res1.T_cw, idx2, keep2)

        need_rec = res2.n_inliers < 25
        if not _branch_free(f_uv) and not bool(need_rec):
            use_rec = need_rec  # False: the recovery pass is skipped
            res, idx_f, good = res2, idx2, keep2 & res2.inliers
        else:
            # brute descriptor match, then a windowed polish, both under the
            # weak prior with twice the iterations (the seed can be hundreds
            # of px off after a map correction)
            idxr, okr, distr = mutual_best_match(
                cache.desc, cache.valid, f_desc, f_valid, max_dist=TH_LOW, ratio=0.8,
            )
            keepr = resolve_duplicate_targets(idxr, okr, distr, self.feat_cap)
            resr0 = vi_solve(T_pred, idxr, keepr, H_prior=self.weak_info, it=2 * self.iters)
            idxr2, keepr2 = match(resr0.T_cw, 6.0)
            resr = vi_solve(resr0.T_cw, idxr2, keepr2, H_prior=self.weak_info,
                            it=2 * self.iters)
            use_rec = need_rec & (resr.n_inliers > res2.n_inliers)
            res = _pick(use_rec, resr, res2)
            idx_f = torch.where(use_rec, idxr2, idx2)
            good = torch.where(use_rec, keepr2 & resr.inliers, keep2 & res2.inliers)
        n_inl = res.n_inliers
        # a velocity jump beyond 3 m/s is a marginal solve gone wrong: reject
        # it and dead-reckon; recovery solves and strong visual consensus
        # (40+ inliers) are exempt
        dv_jump = torch.linalg.norm(res.v_w - v_pred)
        ok = (n_inl >= 20) & ((dv_jump < 3.0) | use_rec | (n_inl >= 40))
        # accepted: the solved state; rejected: the IMU prediction
        R_new = torch.where(ok, res.T_cw.R, T_pred.R)
        t_new = torch.where(ok, res.T_cw.t, T_pred.t)
        v_new = torch.where(ok, res.v_w, v_pred)
        bg_new = torch.where(ok, state.bg + res.dbg, state.bg)
        ba_new = torch.where(ok, state.ba + res.dba, state.ba)
        # cap the carried information: the device chain sees keyframes only at
        # retire time, and an uncapped Schur carry compounds into a prior that
        # locks drift in
        tr = torch.trace(res.H_marg)
        H_capped = res.H_marg * torch.clamp(1e7 / torch.clamp(tr, min=1e-3), max=1.0)
        # an indefinite marginal is not trustworthy either: the float32
        # Schur complement cancels the ~5e10 gyro-walk information, and
        # where that leaves a negative eigenvalue the next solve's prior
        # factor fails (the reference's turns NaN and its solve returns the
        # seed until a keyframe resets the prior); re-anchor near-fixed as a
        # rejected frame does
        pd = torch.linalg.cholesky_ex(H_capped + 1e-8 * torch.eye(15, device=dev))[1] == 0
        H_new = torch.where(ok & pd, H_capped, self.fixed_info)
        src = torch.arange(cache.pos.shape[0], dtype=torch.int32, device=dev)
        obs = torch.full((self.feat_cap,), -1, dtype=torch.int32, device=dev).scatter_reduce(
            0, idx_f, torch.where(good & ok, src, -1), "amax", include_self=True)
        new_state = VITrackState(R=R_new, t=t_new, v_w=v_new, bg=bg_new, ba=ba_new,
                                 H_prior=H_new, ok=ok)
        n_out = torch.where(ok, n_inl, -torch.clamp(n_inl, min=0) - 1)
        return new_state, VIStepOutput(R_new, t_new, v_new, bg_new, ba_new, n_out, obs, pre)


def make_vi_step_body(cam: Camera, inv_s2_levels, feat_cap: int, imu_cfg, iters: int = 6,
                      bf: float = 0.0, device="cuda"):
    """The per-frame VI step as a VITrackStep module (see VITrackStep)."""
    return VITrackStep(cam, inv_s2_levels, feat_cap, imu_cfg, iters, bf=bf, device=device)


def stack_frames(trees):
    """Per-frame trees of tensors (named tuples, nested) -> one tree with a
    leading frame axis."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    return type(first)(*(stack_frames(list(x)) for x in zip(*trees)))


def _nrm(R):
    u, _, vt = np.linalg.svd(R)
    return (u @ vt).astype(np.float32)


def _hat(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], np.float32)


def merge_np(p1, p2) -> Preintegrated:
    """imu/preintegration.py::merge in numpy for the host retire loop (a
    device merge would cost a dispatch per frame while the card streams the
    next chunk). Fields may be numpy arrays or CPU tensors; returns numpy
    arrays (dT 0-d)."""
    a = {f: np.asarray(x, np.float32) for f, x in zip(Preintegrated._fields[:10], p1[:10])}
    b = {f: np.asarray(x, np.float32) for f, x in zip(Preintegrated._fields[:10], p2[:10])}
    dT = a["dT"] + b["dT"]
    t2 = float(b["dT"])
    w1 = float(a["dT"]) / max(float(dT), 1e-9)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return Preintegrated(
        dT=f32(dT),
        dR=_nrm(a["dR"] @ b["dR"]),
        dV=f32(a["dV"] + a["dR"] @ b["dV"]),
        dP=f32(a["dP"] + a["dV"] * t2 + a["dR"] @ b["dP"]),
        C=f32(a["C"] + b["C"]),
        JRg=f32(b["dR"].T @ a["JRg"] + b["JRg"]),
        JVg=f32(a["JVg"] + a["dR"] @ b["JVg"] - a["dR"] @ _hat(b["dV"]) @ a["JRg"]),
        JVa=f32(a["JVa"] + a["dR"] @ b["JVa"]),
        JPg=f32(a["JPg"] + a["JVg"] * t2 + a["dR"] @ b["JPg"]
                - a["dR"] @ _hat(b["dP"]) @ a["JRg"]),
        JPa=f32(a["JPa"] + a["JVa"] * t2 + a["dR"] @ b["JPa"]),
        bias=ImuBias(f32(p1.bias.bg), f32(p1.bias.ba)),
        avg_a=f32(w1 * np.asarray(p1.avg_a) + (1 - w1) * np.asarray(p2.avg_a)),
        avg_w=f32(w1 * np.asarray(p1.avg_w) + (1 - w1) * np.asarray(p2.avg_w)),
    )


def pre_slice_np(pres, i) -> Preintegrated:
    """Frame i's Preintegrated from a chunk's stacked host (numpy) one."""
    return Preintegrated(*(np.asarray(x[i]) for x in pres[:10]),
                         ImuBias(*(np.asarray(x[i]) for x in pres.bias)),
                         *(np.asarray(x[i]) for x in pres[11:]))
