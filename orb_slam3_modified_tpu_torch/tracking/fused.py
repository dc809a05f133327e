"""Fused tracking step: match against the device map cache, then solve the pose.

Port of orb_slam3_modified_tpu/tracking/fused.py. Per frame: constant-velocity
prediction, two windowed Hamming mutual-best-match + IRLS-LM passes (radius
15 then 4 px per octave), and a brute-force recovery pass (reference analog:
TrackReferenceKeyFrame after a motion-model failure) when the second pass
keeps fewer than 25 inliers.

The reference gates the recovery pass with lax.cond. The port reads the
gate on the host and runs the pass only when a frame needs it: the step is
bound by the host's launches, so skipping the pass's two solves is worth more
than the one device-to-host read per frame (PERF.md). While a CUDA graph is
being captured a host read is not allowed; the step then computes the pass
every frame and selects with torch.where, which gives the same result.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from .. import resolve_device
from ..cameras import Camera, project
from ..features.matcher import TH_HIGH, TH_LOW, mutual_best_match, resolve_duplicate_targets
from ..lie.se3 import SE3
from ..optim.pose_opt import pose_optimization


def _branch_free(t) -> bool:
    """True while a CUDA graph is being captured on t's device, where the
    recovery gate cannot be read on the host."""
    return t.is_cuda and torch.cuda.is_current_stream_capturing()


class MapCache(NamedTuple):
    pos: torch.Tensor  # (C, 3) float32
    desc: torch.Tensor  # (C, 8) int32 (the reference's uint32 bits)
    valid: torch.Tensor  # (C,) bool
    mp_id: torch.Tensor  # (C,) int32 global ids (host decodes matches)


class DeviceTrackState(NamedTuple):
    R: torch.Tensor  # (3, 3) current T_cw
    t: torch.Tensor  # (3,)
    R_prev: torch.Tensor
    t_prev: torch.Tensor
    ok: torch.Tensor  # () bool: last step had enough inliers


class StepOutput(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    n_inliers: torch.Tensor  # () int32
    obs_cache_idx: torch.Tensor  # (F,) int32 cache index per feature or -1


class TrackStep(nn.Module):
    """(state, cache, features) -> (state, out) for one frame.

    Holds the camera parameters and the per-level inverse sigma^2 as
    buffers. bf > 0 enables rectified-stereo rows for features with
    f_ur >= 0."""

    def __init__(
        self, cam: Camera, inv_s2_levels, feat_cap: int, rounds: int = 4,
        iters: int = 8, bf: float = 0.0, device="cuda",
    ):
        super().__init__()
        dev = resolve_device(device)
        self.kind, self.width, self.height = cam.kind, cam.width, cam.height
        self.register_buffer("cam_params", cam.params.to(dev), persistent=False)
        self.register_buffer(
            "inv_s2_levels",
            torch.as_tensor(inv_s2_levels, dtype=torch.float32).to(dev),
            persistent=False,
        )
        self.feat_cap = feat_cap
        self.rounds, self.iters = rounds, iters
        self.bf = float(bf)

    @property
    def cam(self):
        return Camera(self.kind, self.cam_params, self.width, self.height)

    def forward(self, state: DeviceTrackState, cache: MapCache, f_uv, f_desc,
                f_level, f_valid, f_ur=None):
        cam = self.cam
        stereo = f_ur is not None and self.bf > 0
        bf = torch.full((), self.bf, device=f_uv.device) if stereo else None
        n_lvl = self.inv_s2_levels.shape[0]

        def solve(T_init, idx, keep):
            inv_s2 = self.inv_s2_levels[torch.clamp(f_level[idx], 0, n_lvl - 1)]
            return pose_optimization(
                T_init, cam, cache.pos, f_uv[idx], inv_s2, self.rounds, self.iters,
                valid=keep, ur_obs=f_ur[idx] if stereo else None, bf=bf,
            )

        def match_and_optimize(T_init, radius_scale):
            pc = T_init.apply(cache.pos)
            uv_pred = project(cam, pc)
            in_view = (
                cache.valid
                & (pc[..., 2] > 0.05)
                & (uv_pred[..., 0] >= -20)
                & (uv_pred[..., 0] < cam.width + 20)
                & (uv_pred[..., 1] >= -20)
                & (uv_pred[..., 1] < cam.height + 20)
            )
            d2 = uv_pred[:, None, :] - f_uv[None, :, :]
            r = radius_scale * torch.pow(1.2, f_level.to(torch.float32))
            spatial = torch.sum(d2 * d2, dim=-1) < (r * r)[None, :]
            idx, okm, dist = mutual_best_match(
                cache.desc, in_view, f_desc, f_valid, max_dist=TH_HIGH, ratio=0.9,
                extra_mask=spatial,
            )
            keep = resolve_duplicate_targets(idx, okm, dist, self.feat_cap)
            return solve(T_init, idx, keep), idx, keep

        # constant-velocity prediction: T_pred = (T T_prev^-1) T
        T = SE3(state.R, state.t)
        vel = T @ SE3(state.R_prev, state.t_prev).inverse()
        T_pred = vel @ T

        res1, _, _ = match_and_optimize(T_pred, 15.0)
        # second pass from the refined pose with a tight radius
        res2, idx2, keep2 = match_and_optimize(res1.T_cw, 4.0)

        need_rec = res2.n_inliers < 25
        if not _branch_free(f_uv) and not bool(need_rec):
            use_rec = need_rec  # False: the recovery pass is skipped
            n_inl, T_sel, idx_f, good = res2.n_inliers, res2.T_cw, idx2, keep2 & res2.inliers
        else:
            # brute descriptor match, no motion window, then a windowed polish
            idxr, okr, distr = mutual_best_match(
                cache.desc, cache.valid, f_desc, f_valid, max_dist=TH_LOW, ratio=0.8,
            )
            keepr = resolve_duplicate_targets(idxr, okr, distr, self.feat_cap)
            resr0 = solve(T, idxr, keepr)
            resr, idxr2, keepr2 = match_and_optimize(resr0.T_cw, 6.0)
            use_rec = need_rec & (resr.n_inliers > res2.n_inliers)
            n_inl = torch.where(use_rec, resr.n_inliers, res2.n_inliers)
            T_sel = SE3(
                torch.where(use_rec, resr.T_cw.R, res2.T_cw.R),
                torch.where(use_rec, resr.T_cw.t, res2.T_cw.t),
            )
            idx_f = torch.where(use_rec, idxr2, idx2)
            good = torch.where(use_rec, keepr2 & resr.inliers, keep2 & res2.inliers)

        ok = n_inl >= 20
        R_new = torch.where(ok, T_sel.R, T_pred.R)
        t_new = torch.where(ok, T_sel.t, T_pred.t)
        # per-feature cache association (invert idx_f: feature -> cache entry)
        src = torch.arange(cache.pos.shape[0], dtype=torch.int32, device=f_uv.device)
        obs = torch.full(
            (self.feat_cap,), -1, dtype=torch.int32, device=f_uv.device
        ).scatter_reduce(0, idx_f, torch.where(good, src, -1), "amax", include_self=True)
        # a recovery jump invalidates the constant-velocity history
        R_prev = torch.where(use_rec, R_new, state.R)
        t_prev = torch.where(use_rec, t_new, state.t)
        new_state = DeviceTrackState(R=R_new, t=t_new, R_prev=R_prev, t_prev=t_prev, ok=ok)
        return new_state, StepOutput(R_new, t_new, n_inl, obs)


def make_step_body(
    cam: Camera, inv_s2_levels, feat_cap: int, rounds: int = 4, iters: int = 8,
    bf: float = 0.0, device="cuda",
):
    """The per-frame step as a TrackStep module (see TrackStep)."""
    return TrackStep(cam, inv_s2_levels, feat_cap, rounds, iters, bf=bf, device=device)
