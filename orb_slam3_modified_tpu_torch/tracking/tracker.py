"""Per-frame tracking front end: monocular, stereo and RGB-D.

Port of orb_slam3_modified_tpu/tracking/tracker.py (Tracking: Track()
:1797, TrackWithMotionModel :2857, TrackReferenceKeyFrame :2723,
TrackLocalMap :2952, MonocularInitialization :2451, NeedNewKeyFrame :3067,
CreateNewKeyFrame :3219 of src/Tracking.cc).

The tracker is a host state machine over the numpy map (slam_map/
map_state.py). Frames arrive as host Features (numpy: uv (F, 2) float32,
desc (F, 8) uint32, angle, level int32, response, valid bool); the heavy
steps run on `device`: the matchers (features/matcher.py; every match with a
mask goes through the Hamming matrix kernel on the card), the pose solve,
the two-view initializer and bundle adjustment. Inputs are uploaded with
device= set explicitly, so no call silently takes a CPU path, and results
come back through one readback each (utils/fetch.py). Poses between frames
are numpy (SE3np).

States mirror eTrackingState: NOT_INITIALIZED -> OK -> RECENTLY_LOST -> LOST,
with the map reset one level up (system/slam_system.py). A lost frame tries
relocalization through the `relocalize_fn` hook (loop/relocalization.py,
wired by the system when loop closing is on).

Stereo and RGB-D frames come with a metric depth per feature, and a right-
image u per feature (rectified stereo, or RGB-D's virtual right uR = u -
bf/z). With depth the map starts from one frame (StereoInitialization,
src/Tracking.cc:2338), keyframes spawn close points from depth
(CreateNewKeyFrame, :3260), and the frame-to-frame odometry of localization
mode tracks the last frame's depth points; with uR and bf > 0 the pose
solves and the bundle adjustments carry (u, v, uR) rows.

With an IMU (`tracker.imu`, tracking/imu_frontend.py, wired by the system for
the inertial sensors) every frame's samples are preintegrated on the device;
once the staged init has run, the IMU predicts the pose, the pose solves
become the 30-D visual-inertial solve with its marginalization prior
(optim/vi_pose_opt.py), short visual blackouts are bridged by dead
reckoning, keyframes follow at least every half second and keep coming
while RECENTLY_LOST, and each keyframe may trigger the next init stage.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..cameras import Camera, project_np, unproject, unproject_np
from ..features.extractor import Features
from ..features.matcher import (
    TH_HIGH, TH_LOW, mutual_best_match, resolve_duplicate_targets, search_by_projection,
    search_for_initialization,
)
from ..geom import reconstruct_two_views
from ..lie.se3 import SE3, SE3np
from ..optim.ba import BAProblem, bundle_adjust, to_device
from ..optim.pose_opt import pose_optimization
from ..optim.vi_pose_opt import vi_pose_optimization_marg
from ..slam_map.map_state import NO_POINT, MapState
from ..utils.fetch import fetch, upload

NOT_INITIALIZED = 0
OK = 1
RECENTLY_LOST = 2
LOST = 3

POSE_OPT_CAP = 2048  # association capacity of a pose solve (static shape)

# Near-fixed anchor information of the VI solve where no covariance-derived
# prior exists (right after init or relocalization): the reference fixes the
# anchor vertices (setFixed in PoseInertialOptimizationLastKeyFrame,
# src/Optimizer.cc:4491); a stiff finite information is the joint solver's
# equivalent.
_FIXED_ANCHOR_INFO = np.diag(
    np.concatenate([np.full(6, 1e6), np.full(3, 1e4), np.full(6, 1e4)])).astype(np.float32)


def inv_level_sigma2(n_levels: int = 8, scale: float = 1.2) -> np.ndarray:
    """(n_levels,) float32 information per octave, 1 / scale^(2 level)
    (ORB-SLAM3 mvInvLevelSigma2)."""
    return (1.0 / scale ** (2.0 * np.arange(n_levels))).astype(np.float32)


def _pad1(a, n, fill=0):
    a = np.asarray(a)
    if len(a) >= n:
        return a[:n]
    return np.concatenate([a, np.full((n - len(a), *a.shape[1:]), fill, a.dtype)])


def host_camera(cam: Camera) -> Camera:
    """The same camera with its parameters on the CPU, for numpy host math
    (project_np / unproject_np read the parameters on every call)."""
    return Camera(cam.kind, cam.params.detach().cpu(), cam.width, cam.height)


@dataclasses.dataclass
class TrackerConfig:
    cam: Camera = None
    n_levels: int = 8
    scale: float = 1.2
    local_points_cap: int = 2048  # candidate budget for TrackLocalMap
    min_matches_init: int = 100  # reference: mvIniMatches >= 100
    min_inliers_track: int = 10  # reference: nmatchesMap >= 10
    min_inliers_local: int = 30  # reference: mnMatchesInliers < 30 -> lost
    max_frames_between_kf: int = 20  # reference mMaxFrames = fps (20 on EuRoC)
    min_frames_between_kf: int = 3  # reference mMinFrames
    # keep creating keyframes on IMU-predicted poses while RECENTLY_LOST
    # (mInsertKFsLost, include/Tracking.h:300)
    insert_kfs_when_lost: bool = True
    kf_tracked_ratio: float = 0.9  # reference thRefRatio for mono
    depth_point_max: float = 40.0  # stereo / RGB-D close-point depth gate (m)
    bf: float = 0.0  # stereo baseline * fx (reference mbf); 0 = no (u, v, uR) rows
    recently_lost_budget: int = 60  # frames before LOST (~3 s, src/Tracking.cc:1990)
    cam_np: Camera = dataclasses.field(default=None, init=False, repr=False)

    def __post_init__(self):
        if self.cam is not None:
            self.cam_np = host_camera(self.cam)

    def scale_factors(self):
        return self.scale ** np.arange(self.n_levels)

    def inv_level_sigma2(self):
        return inv_level_sigma2(self.n_levels, self.scale)


@dataclasses.dataclass
class FrameRecord:
    """What the tracker remembers about the last processed frame."""

    features: Features  # host (numpy) features
    T_cw: SE3np
    obs_mp: np.ndarray  # (F,) int32 map point per feature or NO_POINT
    ts: float
    frame_id: int
    depth: np.ndarray = None  # (F,) metric depth per feature, <= 0 invalid
    ur: np.ndarray = None  # (F,) right-image u per feature, < 0 = monocular


def features_to_device(f: Features, device) -> Features:
    """Host Features -> Features on `device` (descriptors as int32 bits)."""
    return Features(
        uv=upload(np.asarray(f.uv, np.float32), device),
        desc=upload(np.asarray(f.desc, np.uint32).view(np.int32), device),
        angle=upload(np.asarray(f.angle, np.float32), device),
        level=upload(np.asarray(f.level, np.int32), device),
        response=upload(np.asarray(f.response, np.float32), device),
        valid=upload(np.asarray(f.valid, bool), device),
    )


def features_to_host(f: Features) -> Features:
    """Device Features of one frame -> host Features (descriptors as uint32),
    one readback."""
    f = fetch(tuple(f))
    return Features(f[0], f[1].view(np.uint32), *f[2:])


class Tracker:
    def __init__(self, cfg: TrackerConfig, slam_map: MapState, device="cuda"):
        self.cfg = cfg
        self.map = slam_map
        self.device = resolve_device(device)
        self.cam = Camera(cfg.cam.kind, cfg.cam.params.to(self.device), cfg.cam.width,
                          cfg.cam.height)
        self.state = NOT_INITIALIZED
        self.velocity: Optional[SE3np] = None  # T_cur_last
        self.last: Optional[FrameRecord] = None
        self.init_frame: Optional[FrameRecord] = None
        self.ref_kf: int = -1
        self.frame_id = 0
        self.frames_since_kf = 0
        self.lost_frames = 0
        # poses RELATIVE to the reference keyframe (mlRelativeFramePoses), so
        # later map corrections apply retroactively at save time
        self.trajectory = []  # (ts, fid, ref_kf, ref_frame_id, T_rel, T_abs)
        self.n_last_inliers = 0
        self.on_keyframe = None  # callback(kf_idx): local mapping hook
        # () -> bool: local mapper backlogged (NeedNewKeyFrame's
        # bLocalMappingIdle, src/Tracking.cc:3099)
        self.mapper_busy_fn = None
        # (feats, frame_id) -> (T_cw SE3np, obs_mp (F,)) | None: relocalization
        # against the keyframe database (Tracking::Relocalization,
        # src/Tracking.cc:3612, from the RECENTLY_LOST branch)
        self.relocalize_fn = None
        # tracking/imu_frontend.py::ImuFrontend for the inertial sensors
        self.imu = None
        self._vi_prior_src = None  # which prior the last VI solve took ("marg" / "kf" / "fixed")
        self.only_tracking = False  # localization mode (mbOnlyTracking)
        self.vo_mode = False  # mbVO analog
        self._dev_feats = None
        self._cur_depth = None  # this frame's (F,) depth / uR, or None
        self._cur_ur = None

    # ------------------------------------------------------------ helpers
    def _up(self, arr, dtype=None):
        arr = np.asarray(arr)
        return upload(arr if dtype is None else arr.astype(dtype), self.device)

    def _up_desc(self, desc_u32):
        return upload(np.ascontiguousarray(desc_u32, np.uint32).view(np.int32), self.device)

    def _feats_dev(self, feats: Features) -> Features:
        """This frame's features on the device, uploaded once per frame."""
        if self._dev_feats is None or self._dev_feats[0] is not feats:
            self._dev_feats = (feats, features_to_device(feats, self.device))
        return self._dev_feats[1]

    # ------------------------------------------------------------------ API
    def track(self, feats: Features, ts: float, depth=None, imu_samples=None,
              ur=None) -> Optional[np.ndarray]:
        """Process one frame. Returns T_cw (4x4 numpy) or None while lost.

        depth: (F,) metric depth per feature (stereo / RGB-D; <= 0 invalid);
        with it the map initializes from one frame and keyframes spawn close
        points. ur: (F,) right-image u (< 0 monocular), the third residual
        row of every pose solve when cfg.bf > 0. imu_samples: (acc (N, 3),
        gyro (N, 3), dts (N,)) measured since the previous frame, with an
        IMU frontend attached."""
        fid = self.frame_id
        self.frame_id += 1
        self._cur_depth = None if depth is None else np.asarray(depth, np.float32)
        self._cur_ur = None if ur is None else np.asarray(ur, np.float32)
        # timestamp sanity (src/Tracking.cc:1822-1858): a backward jump drops
        # the motion model and the IMU integration, a large gap forces the
        # loss path
        imu = self.imu
        if self.last is not None:
            dt_gap = ts - self.last.ts
            if dt_gap < 0:
                if imu is not None:
                    imu.preint_frame = None
                    imu.preint_kf = None
                    imu.marg_prior = None
                    imu._marg_pending = None
                self.velocity = None
            elif dt_gap > 1.0 and self.state == OK:
                self.state = RECENTLY_LOST
                self.lost_frames = self.cfg.recently_lost_budget  # -> LOST next miss
                self.velocity = None
        if imu is not None and imu_samples is not None and len(imu_samples[2]):
            imu.integrate_frame(*imu_samples)
        if self.state == NOT_INITIALIZED:
            if self._cur_depth is not None:
                T = self._initialize_with_depth(feats, ts, fid)
            else:
                T = self._initialize(feats, ts, fid)
        elif self.state in (OK, RECENTLY_LOST):
            T = self._track_frame(feats, ts, fid)
        else:  # LOST: handled by the system (map reset / new map)
            T = None
        if T is None:
            return None
        T_abs = np.eye(4)
        T_abs[:3, :3] = T.R
        T_abs[:3, 3] = T.t
        ref = self.ref_kf
        if ref >= 0 and self.map.kf_valid[ref]:
            T_rel = T_abs @ np.linalg.inv(self._kf_matrix(ref))
            ref_fid = int(self.map.kf_frame_id[ref])
        else:
            ref, ref_fid, T_rel = -1, -1, T_abs
        self.trajectory.append((ts, fid, ref, ref_fid, T_rel, T_abs))
        return T_abs

    def _kf_matrix(self, k):
        T = np.eye(4, dtype=np.float64)
        T[:3, :3] = self.map.kf_R[k]
        T[:3, 3] = self.map.kf_t[k]
        return T

    def absolute_trajectory(self):
        """Replay the relative-pose log against the CURRENT keyframe poses
        (SaveTrajectoryTUM, src/System.cc:609-700); culled reference
        keyframes are followed through the spanning-tree parent chain via the
        cull-time relative pose (src/System.cc:648-663). [(ts, fid, T_cw)]."""
        m = self.map
        out = []
        for ts, fid, ref, ref_fid, T_rel, T_abs in self.trajectory:
            T_rel = np.asarray(T_rel, np.float64)
            hops = 0
            while (ref >= 0 and hops < 64
                   and not (m.kf_valid[ref] and int(m.kf_frame_id[ref]) == ref_fid)):
                redirect = m.culled_redirect.get((ref, ref_fid))
                if redirect is None:
                    ref = -1
                    break
                parent, parent_fid, T_cp = redirect
                T_rel = T_rel @ T_cp
                ref, ref_fid = parent, parent_fid
                hops += 1
            if ref >= 0 and m.kf_valid[ref] and int(m.kf_frame_id[ref]) == ref_fid:
                out.append((ts, fid, T_rel @ self._kf_matrix(ref)))
            else:
                out.append((ts, fid, T_abs))
        return out

    # ----------------------------------------------------- initialization
    def _new_init_frame(self, feats, ts, fid):
        return FrameRecord(feats, SE3np.identity(), np.full(len(feats.valid), NO_POINT, np.int32),
                           ts, fid)

    def _initialize(self, feats: Features, ts: float, fid: int):
        n_valid = int(np.asarray(feats.valid).sum())
        if self.init_frame is None:
            if n_valid >= self.cfg.min_matches_init:
                self.init_frame = self._new_init_frame(feats, ts, fid)
                if self.imu is not None:
                    self.imu.preint_kf = None  # the interval spans the init pair only
            return None
        f0 = self.init_frame.features
        d0, d1 = features_to_device(f0, self.device), self._feats_dev(feats)
        idx, ok, _ = search_for_initialization(
            d0.uv, d0.angle, d0.desc, d0.valid, d1.uv, d1.angle, d1.desc, d1.valid)
        n_matches = int(ok.sum())
        if n_matches < self.cfg.min_matches_init:
            # reference: reset the initializer on too few matches
            self.init_frame = (self._new_init_frame(feats, ts, fid)
                               if n_valid >= self.cfg.min_matches_init else None)
            if self.imu is not None:
                self.imu.preint_kf = None
            return None
        # unit-plane coordinates of the matched pairs
        r0 = unproject(self.cam, d0.uv)
        r1 = unproject(self.cam, d1.uv[idx])
        x0 = r0[..., :2] / r0[..., 2:3]
        x1 = r1[..., :2] / r1[..., 2:3]
        focal = float(self.cfg.cam_np.params[0])
        gen = torch.Generator(device=self.device).manual_seed(fid)
        res, idx_np = fetch((reconstruct_two_views(x0, x1, ok, focal, gen), idx))
        if not bool(res.success):
            return None
        self._create_initial_map(f0, feats, idx_np, res, ts, fid)
        return self.last.T_cw

    def _initialize_with_depth(self, feats: Features, ts: float, fid: int):
        """StereoInitialization (src/Tracking.cc:2338): one keyframe at the
        origin, a point for every feature with depth."""
        m = self.map
        d = self._cur_depth
        valid = np.asarray(feats.valid) & (d > 0)
        if valid.sum() < 100:
            return None
        k = m.alloc_keyframe()
        self._write_keyframe(k, feats, SE3np.identity(), ts, fid)
        m.kf_ur[k] = self._cur_ur if self._cur_ur is not None else -1.0
        m.kf_parent[k] = -1
        slots = np.flatnonzero(valid)
        rays = unproject_np(self.cfg.cam_np, np.asarray(feats.uv))[slots]
        pts = rays / rays[:, 2:3] * d[slots, None]  # camera frame = world (T = I)
        mp_idx = m.alloc_points(len(slots))
        m.mp_pos[mp_idx] = pts.astype(np.float32)
        m.mp_first_kf[mp_idx] = k
        m.kf_obs[k, slots] = mp_idx
        m.update_point_stats(mp_idx, self.cfg.scale_factors())
        obs = np.full(len(feats.valid), NO_POINT, np.int32)
        obs[slots] = mp_idx
        self.last = FrameRecord(feats, SE3np.identity(), obs, ts, fid, depth=d, ur=self._cur_ur)
        self.ref_kf = k
        self.state = OK
        self.frames_since_kf = 0
        self.velocity = None
        if self.on_keyframe is not None:
            self.on_keyframe(k)
        return self.last.T_cw

    def _create_initial_map(self, f0: Features, f1: Features, idx_np, res, ts, fid):
        """CreateInitialMapMonocular (src/Tracking.cc:2529): two keyframes,
        triangulated points, a 20-iteration BA, scale set by the median depth."""
        cfg = self.cfg
        m = self.map
        good = np.asarray(res.valid)
        pts = np.asarray(res.points)
        med = float(np.median(pts[good][:, 2]))  # depth in cam0 = world
        if med <= 0:
            return
        pts = pts / med
        T21 = SE3np(res.T_21.R, res.T_21.t / med)
        k0 = m.alloc_keyframe()
        k1 = m.alloc_keyframe()
        for k, f, T, t_s, f_id in (
            (k0, f0, SE3np.identity(), self.init_frame.ts, self.init_frame.frame_id),
            (k1, f1, T21, ts, fid),
        ):
            self._write_keyframe(k, f, T, t_s, f_id)
        m.kf_parent[k0] = -1
        m.kf_parent[k1] = k0
        slots0 = np.flatnonzero(good)
        mp_idx = m.alloc_points(len(slots0))
        m.mp_pos[mp_idx] = pts[slots0]
        m.mp_first_kf[mp_idx] = k0
        m.kf_obs[k0, slots0] = mp_idx
        m.kf_obs[k1, idx_np[slots0]] = mp_idx
        m.update_point_stats(mp_idx, cfg.scale_factors())
        self._initial_ba(k0, k1)  # GlobalBundleAdjustemnt(20)
        obs1 = np.full(len(f1.valid), NO_POINT, np.int32)
        obs1[idx_np[slots0]] = m.kf_obs[k0, slots0]
        self.last = FrameRecord(f1, SE3np(m.kf_R[k1].copy(), m.kf_t[k1].copy()), obs1, ts, fid)
        self.ref_kf = k1
        self.state = OK
        self.frames_since_kf = 0
        self.velocity = None
        if self.imu is not None:  # the two keyframes open the inertial chain
            self.imu.on_initial_keyframes(k0, k1, self.init_frame.ts, ts, m)
        if self.on_keyframe is not None:
            self.on_keyframe(k0)
            self.on_keyframe(k1)

    def _write_keyframe(self, k, f: Features, T: SE3np, ts, fid):
        m = self.map
        m.kf_R[k] = T.R
        m.kf_t[k] = T.t
        m.kf_ts[k] = ts
        m.kf_frame_id[k] = fid
        m.kf_uv[k] = f.uv
        m.kf_desc[k] = f.desc
        m.kf_level[k] = f.level
        m.kf_angle[k] = f.angle
        m.kf_feat_valid[k] = f.valid

    def _initial_ba(self, k0, k1):
        m = self.map
        kf_sel = np.array([k0, k1])
        mp_sel = m.point_indices()
        prob = _build_ba_problem(m, self.cfg, kf_sel, mp_sel, fixed=np.array([True, False]))
        res = fetch(bundle_adjust(to_device(prob, self.device), self.cam, 2, 10))
        _write_back_ba(m, prob, res, kf_sel, mp_sel)

    # ------------------------------------------------------- frame tracking
    def _track_frame(self, feats: Features, ts: float, fid: int):
        cfg = self.cfg
        m = self.map
        inv_s2_levels = cfg.inv_level_sigma2()
        imu = self.imu
        T_pred = None
        if imu is not None and imu.initialized:
            T_pred = imu.predict_pose(self.last.T_cw)
        if T_pred is None:
            T_pred = (self.velocity @ self.last.T_cw if self.velocity is not None
                      else self.last.T_cw)
        cap = len(feats.valid)
        obs_mp = np.full(cap, NO_POINT, np.int32)
        level = np.asarray(feats.level)
        uv = np.asarray(feats.uv)

        ok_track = False
        # --- TrackWithMotionModel: last frame's points by projection
        last_mp = self.last.obs_mp
        has_pt = last_mp != NO_POINT
        if has_pt.sum() >= 10:
            cand_mp = _pad1(last_mp[has_pt], cap, 0)  # static pad: <= cap points
            n_cand = min(int(has_pt.sum()), cap)
            cand_valid = np.zeros(cap, bool)
            cand_valid[:n_cand] = m.mp_valid[cand_mp[:n_cand]]
            pc = m.mp_pos[cand_mp] @ T_pred.R.T + T_pred.t
            uv_pred = project_np(cfg.cam_np, pc)
            lvl_pred = self._predict_levels(cand_mp, np.linalg.norm(pc, axis=-1))
            idx_np, keep_np = self._search(uv_pred, lvl_pred, m.mp_desc[cand_mp],
                                           (pc[:, 2] > 0) & cand_valid, feats, 15.0, 0.9)
            keep_np[n_cand:] = False
            if keep_np.sum() >= 20:
                sel = np.flatnonzero(keep_np)
                T_opt, inl = self._pose_opt(T_pred, m.mp_pos[cand_mp[sel]], uv[idx_np[sel]],
                                            inv_s2_levels[level[idx_np[sel]]],
                                            self._ur_of(idx_np[sel]))
                if int(inl.sum()) >= cfg.min_inliers_track:
                    ok_track = True
                    obs_mp[idx_np[sel[inl]]] = cand_mp[sel[inl]]
                    T_cur = T_opt
        if not ok_track:
            # --- TrackReferenceKeyFrame: brute match to the ref KF's points
            T_cur, obs_mp, ok_track = self._track_reference_kf(feats, T_pred)
        if not ok_track and self.relocalize_fn is not None:
            rel = self.relocalize_fn(feats, fid)
            if rel is not None:
                T_cur, obs_mp = rel
                ok_track = True
                self.velocity = None
                if imu is not None:  # a relocalized pose breaks the prior's anchoring
                    imu.marg_prior = None
                    imu._marg_pending = None
        if not ok_track and self.only_tracking:
            # mbVO: frame-to-frame odometry on depth points (none in mono)
            T_vo, ok_vo = self._track_vo(feats, T_pred)
            if ok_vo:
                self.vo_mode = True
                self.lost_frames = 0
                self.state = OK
                return self._commit_frame(self._record(feats, T_vo, obs_mp, ts, fid),
                                          imu_velocity=True)
        if not ok_track:
            self.lost_frames += 1
            if self.state == OK:
                self.state = RECENTLY_LOST
            elif self.lost_frames > cfg.recently_lost_budget:
                self.state = LOST
            # IMU dead reckoning bridges a short visual blackout: the
            # predicted pose is published while RECENTLY_LOST (Track()'s
            # RECENTLY_LOST branch, src/Tracking.cc:1990-2016)
            if (imu is not None and imu.initialized and self.state == RECENTLY_LOST
                    and imu.preint_frame is not None):
                rec = self._record(feats, T_pred, obs_mp, ts, fid)
                if self.last is not None:
                    # a marginal from a failed solve is anchored at a rejected state
                    imu._marg_pending = None
                    imu.commit_frame_velocity(self.last.T_cw, T_pred, ts - self.last.ts)
                self.last = rec
                self.frames_since_kf += 1
                return T_pred
            return None

        # --- TrackLocalMap
        T_cur, obs_mp, n_inl = self._track_local_map(feats, T_cur, obs_mp)
        self.n_last_inliers = n_inl
        rec = self._record(feats, T_cur, obs_mp, ts, fid)
        if self.only_tracking and n_inl < cfg.min_inliers_local:
            # frozen map, thinning overlap: stay alive in VO mode
            self.vo_mode = n_inl < cfg.min_inliers_track
            self.lost_frames = 0
            return self._commit_frame(rec, imu_velocity=True)
        if n_inl < cfg.min_inliers_local:
            self.state = RECENTLY_LOST
            self.lost_frames += 1
            if self.lost_frames > cfg.recently_lost_budget:
                self.state = LOST
            self._commit_frame(rec)  # keep the motion model alive
            # InsertKFsWhenLost: with an initialized IMU the predicted pose is
            # still trusted, so the map keeps growing while visually weak
            if (cfg.insert_kfs_when_lost and imu is not None and imu.initialized
                    and self.state == RECENTLY_LOST
                    and self.frames_since_kf >= cfg.min_frames_between_kf
                    and int((obs_mp != NO_POINT).sum()) >= 15):
                self._create_keyframe(rec)
            return T_cur
        self.state = OK
        self.lost_frames = 0
        self.vo_mode = False
        self._commit_frame(rec, imu_velocity=True)
        if self._need_new_keyframe(n_inl):
            self._create_keyframe(rec)
        return T_cur

    def _record(self, feats, T, obs_mp, ts, fid) -> FrameRecord:
        return FrameRecord(feats, T, obs_mp, ts, fid, depth=self._cur_depth, ur=self._cur_ur)

    def _ur_of(self, feat_idx):
        """This frame's uR of the given features, or None (monocular)."""
        return None if self._cur_ur is None else self._cur_ur[feat_idx]

    def _commit_frame(self, rec: FrameRecord, imu_velocity: bool = False):
        if imu_velocity and self.imu is not None and self.last is not None:
            self.imu.commit_frame_velocity(self.last.T_cw, rec.T_cw, rec.ts - self.last.ts)
        self._update_motion_model(rec)
        self.last = rec
        self.frames_since_kf += 1
        return rec.T_cw

    def _search(self, uv_pred, lvl_pred, pt_desc_u32, pt_valid, feats, radius_px, ratio,
                f_valid=None):
        """search_by_projection of host candidates against this frame on the
        device, then resolve_duplicate_targets; returns host (idx, keep)."""
        f = self._feats_dev(feats)
        radius = self._up(radius_px * self.cfg.scale_factors(), np.float32)
        idx, okm, dist = search_by_projection(
            self._up(uv_pred, np.float32), self._up(lvl_pred, np.int32),
            self._up_desc(pt_desc_u32), self._up(pt_valid, bool),
            f.uv, f.level, f.desc, f.valid if f_valid is None else self._up(f_valid, bool),
            radius, level_tol=1, max_dist=TH_HIGH, ratio=ratio,
        )
        keep = resolve_duplicate_targets(idx, okm, dist, f.uv.shape[0])
        return fetch((idx, keep))

    def _predict_levels(self, mp_idx, dist):
        """Predicted octave from the distance to the camera center
        (MapPoint::PredictScale: ceil(log(max_dist/dist)/log(scale)), clipped)."""
        max_d = self.map.mp_max_dist[mp_idx]
        ratio = np.where(np.isfinite(max_d) & (max_d > 0), max_d, 1.0) / np.maximum(dist, 1e-6)
        lvl = np.ceil(np.log(np.maximum(ratio, 1e-6)) / np.log(self.cfg.scale))
        return np.clip(lvl, 0, self.cfg.n_levels - 1).astype(np.int32)

    def _pose_opt(self, T0: SE3np, pts_w, uv, inv_s2, ur=None):
        """Pose solve on the device; associations padded to POSE_OPT_CAP.
        ur: (N,) right-image u (< 0 monocular) for (u, v, uR) rows, used
        when cfg.bf > 0 (EdgeStereoOnlyPose). Once the IMU is initialized
        it is the visual-inertial solve against the previous state with its
        15-D prior (PoseInertialOptimizationLastFrame, src/Optimizer.cc:4875),
        whose marginal becomes the next frame's prior."""
        n = min(len(pts_w), POSE_OPT_CAP)
        valid = np.zeros(POSE_OPT_CAP, bool)
        valid[:n] = True
        stereo = ur is not None and self.cfg.bf > 0
        ur_p = _pad1(np.asarray(ur, np.float32), POSE_OPT_CAP, -1.0) if stereo else None
        T0_d = SE3(self._up(T0.R, np.float32), self._up(T0.t, np.float32))
        pts_d = self._up(_pad1(pts_w, POSE_OPT_CAP), np.float32)
        uv_d = self._up(_pad1(uv, POSE_OPT_CAP), np.float32)
        is2_d = self._up(_pad1(inv_s2, POSE_OPT_CAP, 1.0), np.float32)
        ur_d = self._up(ur_p) if stereo else None
        bf_d = self._up(np.float32(self.cfg.bf)).reshape(()) if stereo else None
        imu = self.imu
        if (imu is not None and imu.initialized and imu.preint_frame is not None
                and self.last is not None):
            pre = imu.preint_frame
            # the previous BODY state through the rig extrinsics (ImuCamPose,
            # include/G2oTypes.h:60-128)
            R_bc = np.asarray(imu.cfg.R_bc, np.float32)
            t_bc = np.asarray(imu.cfg.t_bc, np.float32)
            R_cw_prev, t_cw_prev, v_prev, H_prior, self._vi_prior_src = self._vi_prior_for_frame()
            R_bw_prev = R_bc @ R_cw_prev
            t_bw_prev = R_bc @ t_cw_prev + t_bc
            res = vi_pose_optimization_marg(
                T0_d, self.cam, pts_d, uv_d, is2_d, self._up(valid),
                self._up(R_bw_prev.T, np.float32), self._up(-R_bw_prev.T @ t_bw_prev, np.float32),
                self._up(v_prev, np.float32), self._up(H_prior, np.float32),
                pre.dT, pre.dR, pre.dV, pre.dP, pre.JRg, pre.JVg, pre.JVa, pre.JPg, pre.JPa,
                C=pre.C, R_bc=self._up(R_bc), t_bc=self._up(t_bc), ur_obs=ur_d, bf=bf_d)
            T, inl, v_w, H_marg = fetch((res.T_cw, res.inliers, res.v_w, res.H_marg))
            imu._pred_v = v_w
            imu._marg_pending = H_marg
            return SE3np(*T), inl[: len(pts_w)]
        res = pose_optimization(T0_d, self.cam, pts_d, uv_d, is2_d, valid=self._up(valid),
                                ur_obs=ur_d, bf=bf_d)
        res = fetch((res.T_cw, res.inliers))
        return SE3np(*res[0]), res[1][: len(pts_w)]

    def _vi_prior_for_frame(self):
        """The anchor state and 15-D information of the VI frame solve:
        (R_cw_prev, t_cw_prev, v_prev, H_prior, source), source
        - "marg": the previous frame's state with the Schur marginal of its
          solve (PoseInertialOptimizationLastFrame, src/Optimizer.cc:4875);
        - "kf": the first frame after a keyframe, anchored on the keyframe's
          CURRENT map state (the mapper's VI refinement included) with the
          posterior captured when the frame became that keyframe
          (PoseInertialOptimizationLastKeyFrame, :4491);
        - "fixed": no usable prior (after init or relocalization): the anchor
          held near-fixed, as the reference's setFixed."""
        imu = self.imu
        m = self.map
        if imu.marg_prior is not None:
            return (self.last.T_cw.R.astype(np.float32), self.last.T_cw.t.astype(np.float32),
                    np.asarray(imu.v_w, np.float32), imu.marg_prior, "marg")
        k = self.ref_kf
        if k >= 0 and m.kf_valid[k] and int(m.kf_frame_id[k]) == self.last.frame_id:
            kp = imu.kf_prior
            anchored = kp is not None and kp[0] == k and kp[1] == int(m.kf_frame_id[k])
            return (m.kf_R[k].astype(np.float32), m.kf_t[k].astype(np.float32),
                    m.kf_vel[k].astype(np.float32), kp[2] if anchored else _FIXED_ANCHOR_INFO,
                    "kf" if anchored else "fixed")
        return (self.last.T_cw.R.astype(np.float32), self.last.T_cw.t.astype(np.float32),
                np.asarray(imu.v_w, np.float32), _FIXED_ANCHOR_INFO, "fixed")

    def _track_reference_kf(self, feats: Features, T_pred):
        """TrackReferenceKeyFrame (src/Tracking.cc:2723): match against the
        reference keyframe's observed points, ratio 0.7."""
        m = self.map
        k = self.ref_kf
        cap = len(feats.valid)
        obs_mp = np.full(cap, NO_POINT, np.int32)
        if k < 0 or not m.kf_valid[k]:
            return T_pred, obs_mp, False
        slots, mps = m.observations_of_kf(k)
        if len(slots) < 15:
            return T_pred, obs_mp, False
        n_obs = min(len(slots), cap)
        kf_desc = _pad1(m.kf_desc[k, slots], cap, 0)
        kf_valid = np.zeros(cap, bool)
        kf_valid[:n_obs] = m.mp_valid[mps[:n_obs]]
        slots, mps = _pad1(slots, cap, 0), _pad1(mps, cap, 0)
        f = self._feats_dev(feats)
        # no mask: on the card this is the fused entry of the Hamming kernel
        idx, okm, dist = mutual_best_match(
            self._up_desc(kf_desc), self._up(kf_valid), f.desc, f.valid,
            max_dist=TH_LOW, ratio=0.7)
        keep = resolve_duplicate_targets(idx, okm, dist, cap)
        idx_np, keep_np = fetch((idx, keep))
        keep_np[n_obs:] = False
        if keep_np.sum() < 15:
            return T_pred, obs_mp, False
        sel = np.flatnonzero(keep_np)
        T_opt, inl = self._pose_opt(
            T_pred, m.mp_pos[mps[sel]], np.asarray(feats.uv)[idx_np[sel]],
            self.cfg.inv_level_sigma2()[np.asarray(feats.level)[idx_np[sel]]],
            self._ur_of(idx_np[sel]))
        if int(inl.sum()) < self.cfg.min_inliers_track:
            return T_pred, obs_mp, False
        obs_mp[idx_np[sel[inl]]] = mps[sel[inl]]
        return T_opt, obs_mp, True

    def _track_vo(self, feats: Features, T_pred):
        """Frame-to-frame odometry against the last frame's depth points, no
        map involved (the points UpdateLastFrame spawns from depth,
        src/Tracking.cc:2790, tracked while mbVO, :2050-2090). Monocular
        frames carry no depth, so this needs a stereo / RGB-D sensor, as in
        the reference. Returns (T, ok)."""
        last = self.last
        if last is None or last.depth is None:
            return T_pred, False
        cfg = self.cfg
        f0 = last.features
        d = np.asarray(last.depth)
        valid0 = np.asarray(f0.valid) & (d > 0) & (d < cfg.depth_point_max)
        if valid0.sum() < 20:
            return T_pred, False
        rays = unproject_np(cfg.cam_np, np.asarray(f0.uv))
        pc = rays / np.maximum(rays[:, 2:3], 1e-9) * d[:, None]
        T_wc = last.T_cw.inverse()
        pw = pc @ T_wc.R.T + T_wc.t
        pcur = pw @ T_pred.R.T + T_pred.t
        idx_np, keep_np = self._search(project_np(cfg.cam_np, pcur), np.asarray(f0.level),
                                       np.asarray(f0.desc), (pcur[:, 2] > 0.05) & valid0, feats,
                                       15.0, 0.9)
        if keep_np.sum() < 20:
            return T_pred, False
        sel = np.flatnonzero(keep_np)
        T_opt, inl = self._pose_opt(
            T_pred, pw[sel].astype(np.float32), np.asarray(feats.uv)[idx_np[sel]],
            cfg.inv_level_sigma2()[np.asarray(feats.level)[idx_np[sel]]],
            self._ur_of(idx_np[sel]))
        return T_opt, int(inl.sum()) >= 20

    def _track_local_map(self, feats: Features, T_cur: SE3np, obs_mp):
        """TrackLocalMap (src/Tracking.cc:2952): local points of the
        covisible keyframes, projected and matched, then one more solve."""
        cfg = self.cfg
        m = self.map
        cur_pts = obs_mp[obs_mp != NO_POINT]
        if len(cur_pts) == 0:
            return T_cur, obs_mp, 0
        local_kfs = np.flatnonzero(m.point_observers(cur_pts))
        extra = [m.best_covisible(k, 5) for k in local_kfs[:20]]  # UpdateLocalKeyFrames
        if extra:
            local_kfs = np.unique(np.concatenate([local_kfs, *extra]))
        if len(local_kfs):
            # reference keyframe: the one sharing most observations
            shared = np.isin(m.kf_obs[local_kfs], cur_pts).sum(axis=1)
            self.ref_kf = int(local_kfs[int(np.argmax(shared))])
        obs = m.kf_obs[local_kfs]
        mp_set = np.unique(obs[obs != NO_POINT])
        mp_set = mp_set[m.mp_valid[mp_set]]
        mp_new = mp_set[~np.isin(mp_set, cur_pts)][: cfg.local_points_cap]
        add_idx = np.empty(0, np.int64)
        add_feat = np.empty(0, np.int64)
        if len(mp_new) > 0:
            pos = m.mp_pos[mp_new]
            pc = pos @ T_cur.R.T + T_cur.t
            uv_pred = project_np(cfg.cam_np, pc)
            # frustum gates (Frame::isInFrustum, src/Frame.cc:512): image
            # bounds, scale-invariance range, viewing cosine >= 0.5
            dist_c = np.linalg.norm(pc, axis=-1)
            view = pos - (-T_cur.R.T @ T_cur.t)[None]
            view_cos = np.einsum("ij,ij->i", view, m.mp_normal[mp_new]) / np.maximum(dist_c, 1e-9)
            view_cos = np.where(np.linalg.norm(m.mp_normal[mp_new], axis=-1) > 0.5, view_cos, 1.0)
            max_d = m.mp_max_dist[mp_new]
            in_range = (dist_c >= 0.8 * m.mp_min_dist[mp_new]) & np.where(
                np.isfinite(max_d), dist_c <= 1.2 * max_d, True)
            in_img = (
                (pc[:, 2] > 0.05)
                & (uv_pred[:, 0] >= 0) & (uv_pred[:, 0] < cfg.cam.width)
                & (uv_pred[:, 1] >= 0) & (uv_pred[:, 1] < cfg.cam.height)
                & in_range & (view_cos >= 0.5)
            )
            npts = len(mp_new)
            pad = cfg.local_points_cap - npts  # static shape
            f_free = np.asarray(feats.valid) & (obs_mp == NO_POINT)  # unmatched features only
            idx_np, keep_np = self._search(
                np.pad(uv_pred, ((0, pad), (0, 0))),
                np.pad(self._predict_levels(mp_new, dist_c), (0, pad)),
                np.pad(m.mp_desc[mp_new], ((0, pad), (0, 0))),
                np.pad(in_img & m.mp_valid[mp_new], (0, pad)),
                feats, 4.0, 0.8, f_valid=f_free,
            )
            keep_np, idx_np = keep_np[:npts], idx_np[:npts]
            add_idx = mp_new[np.flatnonzero(keep_np)]
            add_feat = idx_np[np.flatnonzero(keep_np)]
            m.mp_visible[mp_new[in_img]] += 1
        # combined association set -> final pose solve
        all_mp = np.concatenate([cur_pts, add_idx])
        all_feat = np.concatenate([np.flatnonzero(obs_mp != NO_POINT), add_feat]).astype(np.int64)
        T_opt, inl = self._pose_opt(
            T_cur, m.mp_pos[all_mp], np.asarray(feats.uv)[all_feat],
            cfg.inv_level_sigma2()[np.asarray(feats.level)[all_feat]], self._ur_of(all_feat))
        obs_out = np.full(len(feats.valid), NO_POINT, np.int32)
        obs_out[all_feat[inl]] = all_mp[inl]
        m.mp_found[all_mp[inl]] += 1
        return T_opt, obs_out, int(inl.sum())

    def _update_motion_model(self, rec: FrameRecord):
        self.velocity = rec.T_cw @ self.last.T_cw.inverse() if self.last is not None else None

    def _need_new_keyframe(self, n_inl):
        """NeedNewKeyFrame (src/Tracking.cc:3067), the mono conditions: enough
        frames passed or tracked ratio below thRefRatio, and a match floor."""
        if self.only_tracking or self.ref_kf < 0:
            return False
        n_ref = len(self.map.observations_of_kf(self.ref_kf)[0])
        max_gap = self.cfg.max_frames_between_kf
        if self.imu is not None:
            # inertial rule: a keyframe at least every 0.5 s keeps the
            # preintegration chain short and, before init, reaches the
            # 10-keyframe init gate quickly (NeedNewKeyFrame's
            # t - mpLastKeyFrame->mTimeStamp >= 0.5, src/Tracking.cc:3067 region)
            max_gap = max(1, max_gap // 2)
        c1 = self.frames_since_kf >= max_gap
        c2 = n_inl < self.cfg.kf_tracked_ratio * max(n_ref, 1)
        if self.mapper_busy_fn is not None and self.mapper_busy_fn():
            # backlogged mapper: only force a keyframe when tracking starves
            c2 = c2 and n_inl < 0.25 * max(n_ref, 1)
        return (c1 or c2) and n_inl >= 15 and self.frames_since_kf >= self.cfg.min_frames_between_kf

    def _create_keyframe(self, rec: FrameRecord):
        """CreateNewKeyFrame (src/Tracking.cc:3219)."""
        m = self.map
        k = m.alloc_keyframe()
        self._write_keyframe(k, rec.features, rec.T_cw, rec.ts, rec.frame_id)
        m.kf_obs[k] = rec.obs_mp
        m.kf_ur[k] = rec.ur if rec.ur is not None else -1.0
        # spanning tree: parent = the reference keyframe at creation
        m.kf_parent[k] = self.ref_kf if (self.ref_kf >= 0 and m.kf_valid[self.ref_kf]) else -1
        if rec.depth is not None:
            self._spawn_depth_points(k, rec)
        if self.imu is not None:
            self.imu.on_keyframe(k, rec.ts, m)
            self.imu.maybe_initialize(m, self)
        self.ref_kf = k
        self.frames_since_kf = 0
        if self.on_keyframe is not None:
            self.on_keyframe(k)

    def _spawn_depth_points(self, k: int, rec: FrameRecord):
        """Close points from depth at keyframe insertion (CreateNewKeyFrame's
        stereo path, src/Tracking.cc:3260): up to the 100 closest unmatched
        features with a valid depth."""
        m = self.map
        f = rec.features
        d = rec.depth
        free = (np.asarray(f.valid) & (m.kf_obs[k] == NO_POINT) & (d > 0)
                & (d < self.cfg.depth_point_max))
        slots = np.flatnonzero(free)
        if len(slots) == 0:
            return
        slots = slots[np.argsort(d[slots])[:100]]
        rays = unproject_np(self.cfg.cam_np, np.asarray(f.uv))[slots]
        pc = rays / rays[:, 2:3] * d[slots, None]
        T_wc = rec.T_cw.inverse()
        try:
            mp_idx = m.alloc_points(len(slots))
        except RuntimeError:  # map full: no close points for this keyframe
            return
        m.mp_pos[mp_idx] = (pc @ T_wc.R.T + T_wc.t).astype(np.float32)
        m.mp_first_kf[mp_idx] = k
        m.kf_obs[k, slots] = mp_idx
        m.update_point_stats(mp_idx, self.cfg.scale_factors())


def _build_ba_problem(m: MapState, cfg: TrackerConfig, kf_sel, mp_sel, fixed):
    """A BAProblem of numpy arrays for the selected keyframes / points
    (uploaded in one batch by optim/ba.py::to_device); with cfg.bf > 0 it
    carries the keyframes' uR (stereo rows where >= 0)."""
    inv_s2_levels = cfg.inv_level_sigma2()
    kf_pos = {int(k): i for i, k in enumerate(kf_sel)}
    mp_pos = np.full(m.mp_valid.shape[0], -1, np.int64)
    mp_pos[mp_sel] = np.arange(len(mp_sel))
    stereo = cfg.bf > 0
    obs_cam, obs_pt, obs_uv, obs_is2, obs_ur = [], [], [], [], []
    for k in kf_sel:
        slots, mps = m.observations_of_kf(int(k))
        sel = mp_pos[mps] >= 0
        slots, mps = slots[sel], mps[sel]
        obs_cam.append(np.full(len(slots), kf_pos[int(k)], np.int32))
        obs_pt.append(mp_pos[mps].astype(np.int32))
        obs_uv.append(m.kf_uv[int(k), slots])
        obs_is2.append(inv_s2_levels[m.kf_level[int(k), slots]])
        if stereo:
            obs_ur.append(m.kf_ur[int(k), slots])
    obs_cam = np.concatenate(obs_cam)
    return BAProblem(
        T_cw=SE3np(m.kf_R[kf_sel].copy(), m.kf_t[kf_sel].copy()),
        cam_fixed=np.asarray(fixed, bool),
        points=m.mp_pos[mp_sel].copy(),
        pt_valid=m.mp_valid[mp_sel].copy(),
        obs_cam=obs_cam,
        obs_pt=np.concatenate(obs_pt),
        obs_uv=np.concatenate(obs_uv).astype(np.float32),
        obs_inv_s2=np.concatenate(obs_is2).astype(np.float32),
        obs_valid=np.ones(len(obs_cam), bool),
        obs_ur=np.concatenate(obs_ur).astype(np.float32) if stereo else None,
        bf=np.float32(cfg.bf) if stereo else None,
    )


def _write_back_ba(m: MapState, prob, res, kf_sel, mp_sel):
    """Host BAResult -> map; slices off any bucket padding (_pad_problem)."""
    m.kf_R[kf_sel] = np.asarray(res.T_cw.R)[: len(kf_sel)]
    m.kf_t[kf_sel] = np.asarray(res.T_cw.t)[: len(kf_sel)]
    m.mp_pos[mp_sel] = np.asarray(res.points)[: len(mp_sel)]
