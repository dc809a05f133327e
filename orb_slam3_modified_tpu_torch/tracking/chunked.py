"""Chunked tracking: K frames per device step, the host half behind it.

Port of orb_slam3_modified_tpu/tracking/chunked.py, monocular, stereo and
RGB-D, each with or without an IMU:
- `make_chunk_step` / ChunkStep: batched ORB extraction over the chunk, then
  the fused track step for each frame in order, carrying DeviceTrackState.
  `make_chunk_step_stereo` / StereoChunkStep extracts a chunk's left and
  right images as one 2K-image batch and matches each frame left -> right
  (ops/stereo_match.py, the Hamming kernel's matrix entry, one launch per
  frame) before the per-frame loop, which tracks with (u, v, uR) rows.
  `make_chunk_step_rgbd` / RgbdChunkStep looks the depth up at the keypoints
  of all K frames in one gather and derives the virtual right uR = u - bf/z.
  A chunk's stereo matches and depth lookups do not depend on the track
  state, so they run before the loop.
- `make_vi_chunk_step` / VIChunkStep (and its stereo and RGB-D siblings,
  the reference's make_vi_chunk_step* in tracking/vi_fused.py): once the
  IMU is initialized, the same extraction, stereo match or depth lookup,
  then the chunk's IMU samples integrated in one batched loop and the VI
  step (tracking/vi_fused.py::VITrackStep) for each frame in order,
  carrying VITrackState.
- `ChunkedTracker`: the host driver over tracking/tracker.py. It buffers
  frames (each uploaded as it arrives), dispatches a chunk, and starts the
  readback of the chunk's outputs and features into pinned host memory; a
  chunk later (lag) it retires the frames: replays the keyframe policy per
  frame (NeedNewKeyFrame, src/Tracking.cc:3067), creates keyframes
  retroactively, and refreshes the device map cache from the numpy map.
  Initialization and loss recovery go through the per-frame slow path
  (Tracker.track), and a mid-chunk loss replays the kept host images through
  it until tracking recovers.
- With an IMU (`tracker.imu`): before the IMU init the visual step tracks
  and one batched integration a chunk keeps the keyframe chain's intervals
  (the retire merges them per frame, merge_np); the staged init, run by the
  mapper worker (asynchronous) or inside keyframe creation (synchronous),
  realigns the world by a similarity that the frontend applies exactly to
  the chunks in flight and to the device state, and switches to the VI
  step; frames whose VI solve was rejected are published as dead-reckoned
  poses for up to DR_BUDGET frames; the device state hands its velocity and
  bias back to the IMU frontend at keyframes and losses, and adopts the
  biases the solvers refine.

Where the reference pads a short chunk with copies of its last frame (a
fixed shape for XLA) and carries the device state through them, the port
runs the chunk at its own length.
"""
from __future__ import annotations

import logging
import threading
from collections import deque

import numpy as np
import torch
from torch import nn

from .. import resolve_device
from ..features.extractor import ExtractorConfig, Features, ORBExtractor
from ..imu.preintegration import ImuBias, integrate
from ..lie.se3 import SE3np
from ..ops.stereo_match import depth_from_depthmap, match_stereo, virtual_right
from ..slam_map.map_state import NO_POINT
from ..utils.fetch import Readback, fetch, upload
from ..utils.timing import TimeStats
from .fused import CACHE_CAP, DeviceTrackState, MapCache, StepOutput, TrackStep
from .tracker import LOST, OK, RECENTLY_LOST, FrameRecord, features_to_host
from .vi_fused import (
    _FIXED_INFO, VITrackState, VITrackStep, merge_np, pre_slice_np, stack_frames,
)

log = logging.getLogger(__name__)

HARD_FLOOR = 12  # inliers below which a chunk-stepped frame counts as lost
LOW_STREAK_LIMIT = 3  # frames under min_inliers_local before a forced keyframe
IMU_CAP = 64  # padded IMU samples per frame gap (the reference's IMU_BATCH)
DR_BUDGET = 24  # dead-reckoned frames (~1.2 s) before the frontend counts a loss


class ChunkStep(nn.Module):
    """(state, cache, imgs (K, H, W) uint8) -> (state', outs, feats); outs and
    feats are stacked over the K frames and stay on the device."""

    def __init__(self, cam, inv_s2_levels, ecfg: ExtractorConfig, rounds=3, iters=6,
                 device="cuda", bf: float = 0.0, step: nn.Module = None):
        super().__init__()
        dev = resolve_device(device)
        self.extractor = ORBExtractor(ecfg, cam.height, cam.width, device=dev)
        self.step = step if step is not None else TrackStep(
            cam, inv_s2_levels, ecfg.n_features, rounds, iters, bf=bf, device=dev)

    def track(self, state: DeviceTrackState, cache: MapCache, feats: Features, urs=None):
        """The fused step for each of the K frames in order; urs (K, F) adds
        the frames' (u, v, uR) rows."""
        outs = []
        for k in range(feats.uv.shape[0]):
            state, out = self.step(state, cache, feats.uv[k], feats.desc[k], feats.level[k],
                                   feats.valid[k], None if urs is None else urs[k])
            outs.append(out)
        return state, StepOutput(*(torch.stack(f) for f in zip(*outs)))

    def forward(self, state: DeviceTrackState, cache: MapCache, imgs):
        feats = self.extractor(imgs)
        state, outs = self.track(state, cache, feats)
        return state, outs, feats


class StereoChunkStep(ChunkStep):
    """(state, cache, imgs_l, imgs_r (K, H, W) uint8) -> (state', outs, left
    feats, ur (K, F), depth (K, F)): both images of every frame in one
    extraction batch (the reference's parallel left / right extraction,
    src/Frame.cc:122-123), the rectified row-band match of each frame, then
    the track loop with stereo rows."""

    def __init__(self, cam, inv_s2_levels, ecfg: ExtractorConfig, bf: float, min_z: float,
                 rounds=3, iters=6, device="cuda"):
        super().__init__(cam, inv_s2_levels, ecfg, rounds, iters, device, bf=float(bf))
        self.bf, self.min_z = float(bf), float(min_z)

    def match(self, feats: Features, feats_r: Features):
        """Each frame's left -> right match (ComputeStereoMatches,
        src/Frame.cc:811): ur, depth (K, F), -1 where unmatched."""
        urs, depths = [], []
        for k in range(feats.uv.shape[0]):
            u_r, d, ok = match_stereo(feats.uv[k], feats.desc[k], feats.level[k], feats.valid[k],
                                      feats_r.uv[k], feats_r.desc[k], feats_r.level[k],
                                      feats_r.valid[k], self.bf, self.min_z)
            urs.append(torch.where(ok, u_r, -1.0))
            depths.append(torch.where(ok, d, -1.0))
        return torch.stack(urs), torch.stack(depths)

    def forward(self, state: DeviceTrackState, cache: MapCache, imgs_l, imgs_r):
        K = imgs_l.shape[0]
        both = self.extractor(torch.cat([imgs_l, imgs_r]))
        feats = Features(*(f[:K] for f in both))
        urs, depths = self.match(feats, Features(*(f[K:] for f in both)))
        state, outs = self.track(state, cache, feats, urs)
        return state, outs, feats, urs, depths


class RgbdChunkStep(ChunkStep):
    """(state, cache, imgs (K, H, W) uint8, depth maps (K, H, W) float32) ->
    (state', outs, feats, ur (K, F), depth (K, F)): the depth at each
    keypoint and the virtual right uR = u - bf/z feed the same stereo rows
    (ComputeStereoFromRGBD, src/Frame.cc:984); bf = 0 spawns points from
    depth without stereo rows."""

    def __init__(self, cam, inv_s2_levels, ecfg: ExtractorConfig, bf: float,
                 depth_scale: float = 1.0, th_far: float = 0.0, rounds=3, iters=6,
                 device="cuda"):
        super().__init__(cam, inv_s2_levels, ecfg, rounds, iters, device, bf=float(bf))
        self.bf, self.depth_scale, self.th_far = float(bf), float(depth_scale), float(th_far)

    def lookup(self, feats: Features, dmaps):
        """ur, depth (K, F) of the chunk's keypoints, in one gather."""
        d = depth_from_depthmap(feats.uv, dmaps, self.depth_scale)
        if self.th_far > 0:
            d = torch.where(d > self.th_far, -1.0, d)
        if self.bf > 0:
            ur = virtual_right(feats.uv, d, self.bf, feats.valid)
        else:
            ur = torch.full_like(d, -1.0)
        return ur, d

    def forward(self, state: DeviceTrackState, cache: MapCache, imgs, dmaps):
        feats = self.extractor(imgs)
        urs, depths = self.lookup(feats, dmaps)
        state, outs = self.track(state, cache, feats, urs)
        return state, outs, feats, urs, depths


def make_chunk_step(cam, inv_s2_levels, ecfg: ExtractorConfig, rounds=3, iters=6,
                    device="cuda"):
    """The chunk step as a ChunkStep module; frames must be cam.height x cam.width."""
    return ChunkStep(cam, inv_s2_levels, ecfg, rounds, iters, device=device)


def make_chunk_step_stereo(cam, inv_s2_levels, ecfg: ExtractorConfig, bf: float, min_z: float,
                           rounds=3, iters=6, device="cuda"):
    """The stereo chunk step as a StereoChunkStep module (rectified pairs)."""
    return StereoChunkStep(cam, inv_s2_levels, ecfg, bf, min_z, rounds, iters, device=device)


def make_chunk_step_rgbd(cam, inv_s2_levels, ecfg: ExtractorConfig, bf: float,
                         depth_scale: float = 1.0, th_far: float = 0.0, rounds=3, iters=6,
                         device="cuda"):
    """The RGB-D chunk step as an RgbdChunkStep module."""
    return RgbdChunkStep(cam, inv_s2_levels, ecfg, bf, depth_scale, th_far, rounds, iters,
                         device=device)


def _frame(tree, k):
    """Frame k of a tree of stacked tensors (named tuples, nested)."""
    if isinstance(tree, torch.Tensor):
        return tree[k]
    return type(tree)(*(_frame(x, k) for x in tree))


class VIChunkStep(ChunkStep):
    """(state, cache, imgs (K, H, W) uint8, acc, gyro (K, S, 3), dts, valid
    (K, S)) -> (state', outs, feats): the extraction, then the K frames'
    IMU samples integrated in one batched loop at the chunk's starting bias
    (the reference's integrate_chunk), then the VI step for each frame in
    order (each frame's interval moved to the carried bias, VITrackStep).
    Trim S to the chunk's largest valid count: padded samples change
    nothing and each costs a loop iteration."""

    def __init__(self, cam, inv_s2_levels, ecfg: ExtractorConfig, imu_cfg, iters=6,
                 device="cuda", bf: float = 0.0):
        dev = resolve_device(device)
        super().__init__(cam, inv_s2_levels, ecfg, device=dev, step=VITrackStep(
            cam, inv_s2_levels, ecfg.n_features, imu_cfg, iters, bf=bf, device=dev))
        self.noise = (imu_cfg.noise_gyro, imu_cfg.noise_acc, imu_cfg.walk_gyro,
                      imu_cfg.walk_acc, imu_cfg.freq)

    def track(self, state: VITrackState, cache: MapCache, feats: Features, imu, urs=None):
        """imu: (acc, gyro, dts, valid) of the K frames on the device; urs
        (K, F) adds the frames' (u, v, uR) rows."""
        pres = integrate(*imu, ImuBias(state.bg, state.ba), *self.noise)
        outs = []
        for k in range(feats.uv.shape[0]):
            state, out = self.step(state, cache, feats.uv[k], feats.desc[k], feats.level[k],
                                   feats.valid[k], _frame(pres, k),
                                   None if urs is None else urs[k])
            outs.append(out)
        return state, stack_frames(outs)

    def forward(self, state: VITrackState, cache: MapCache, imgs, acc, gyro, dts, valid):
        feats = self.extractor(imgs)
        state, outs = self.track(state, cache, feats, (acc, gyro, dts, valid))
        return state, outs, feats


class VIStereoChunkStep(VIChunkStep):
    """StereoChunkStep's extraction and match, then VIChunkStep's track with
    the (u, v, uR) rows (the reference's stereo-inertial chunk, its flagship
    configuration)."""

    match = StereoChunkStep.match

    def __init__(self, cam, inv_s2_levels, ecfg: ExtractorConfig, imu_cfg, bf: float,
                 min_z: float, iters=6, device="cuda"):
        super().__init__(cam, inv_s2_levels, ecfg, imu_cfg, iters, device, bf=float(bf))
        self.bf, self.min_z = float(bf), float(min_z)

    def forward(self, state: VITrackState, cache: MapCache, imgs_l, imgs_r, acc, gyro, dts,
                valid):
        K = imgs_l.shape[0]
        both = self.extractor(torch.cat([imgs_l, imgs_r]))
        feats = Features(*(f[:K] for f in both))
        urs, depths = self.match(feats, Features(*(f[K:] for f in both)))
        state, outs = self.track(state, cache, feats, (acc, gyro, dts, valid), urs)
        return state, outs, feats, urs, depths


class VIRgbdChunkStep(VIChunkStep):
    """RgbdChunkStep's depth lookup, then VIChunkStep's track with the
    virtual-right rows (Examples/RGB-D-Inertial)."""

    lookup = RgbdChunkStep.lookup

    def __init__(self, cam, inv_s2_levels, ecfg: ExtractorConfig, imu_cfg, bf: float,
                 depth_scale: float = 1.0, th_far: float = 0.0, iters=6, device="cuda"):
        super().__init__(cam, inv_s2_levels, ecfg, imu_cfg, iters, device, bf=float(bf))
        self.bf, self.depth_scale, self.th_far = float(bf), float(depth_scale), float(th_far)

    def forward(self, state: VITrackState, cache: MapCache, imgs, dmaps, acc, gyro, dts, valid):
        feats = self.extractor(imgs)
        urs, depths = self.lookup(feats, dmaps)
        state, outs = self.track(state, cache, feats, (acc, gyro, dts, valid), urs)
        return state, outs, feats, urs, depths


def make_vi_chunk_step(cam, inv_s2_levels, ecfg: ExtractorConfig, imu_cfg, iters=6,
                       device="cuda"):
    """The monocular-inertial chunk step as a VIChunkStep module."""
    return VIChunkStep(cam, inv_s2_levels, ecfg, imu_cfg, iters, device=device)


def make_vi_chunk_step_stereo(cam, inv_s2_levels, ecfg: ExtractorConfig, imu_cfg, bf: float,
                              min_z: float, iters=6, device="cuda"):
    """The stereo-inertial chunk step as a VIStereoChunkStep module."""
    return VIStereoChunkStep(cam, inv_s2_levels, ecfg, imu_cfg, bf, min_z, iters, device=device)


def make_vi_chunk_step_rgbd(cam, inv_s2_levels, ecfg: ExtractorConfig, imu_cfg, bf: float,
                            depth_scale: float = 1.0, th_far: float = 0.0, iters=6,
                            device="cuda"):
    """The RGB-D-inertial chunk step as a VIRgbdChunkStep module."""
    return VIRgbdChunkStep(cam, inv_s2_levels, ecfg, imu_cfg, bf, depth_scale, th_far, iters,
                           device=device)


def _fix_outs(outs, start, A, s_al, vi):
    """A world similarity on a retired chunk's host outputs from frame
    `start` on: R' = R A^T, t' = s t and, VI, v' = s A v. The staged init
    realigns the world while chunks are in flight; this is exact, with no
    replay."""
    R = np.array(outs.R)
    t = np.array(outs.t)
    R[start:] = R[start:] @ A.T
    t[start:] = s_al * t[start:]
    if vi:
        v = np.array(outs.v_w)
        v[start:] = s_al * v[start:] @ A.T
        return outs._replace(R=R, t=t, v_w=v)
    return outs._replace(R=R, t=t)


def _tree_map(fn, tree):
    if isinstance(tree, tuple):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    return fn(tree)


class _PendingChunk:
    __slots__ = ("fids", "tss", "n_valid", "readback", "outs", "feats", "urs", "depths",
                 "pres", "cache_ids", "imgs", "imgs_r", "imu", "vi", "world_fix")

    def __init__(self, fids, tss, readback, cache_ids, imgs, imgs_r, imu=None, vi=False):
        self.fids = fids
        self.tss = tss
        self.n_valid = len(fids)
        # (StepOutput or VIStepOutput, Features, ur, depth, the frames'
        # Preintegrated before the IMU init) copying home
        self.readback = readback
        self.outs = self.feats = None  # host copies, once retired
        self.urs = self.depths = None  # (K, F) host copies (stereo / RGB-D), once retired
        self.pres = None  # the frames' intervals (host), visual chunks with an IMU
        self.cache_ids = cache_ids
        # host copies, for the slow-path replay after a loss: the images, and
        # the right images (stereo) or depth maps (RGB-D), else Nones; the
        # padded IMU stacks (acc, gyro, dts, valid) with an IMU
        self.imgs = imgs
        self.imgs_r = imgs_r
        self.imu = imu
        self.vi = vi  # outs is a VIStepOutput
        self.world_fix = []  # [(A, s)] similarities to apply at retire


class ChunkedTracker:
    """Chunk-pipelined frontend over tracking/tracker.py.

    track_image() returns the (frame_id, ts, T_abs 4x4 | None) triples of
    the frames this call retired (frames come back up to chunk * (lag + 1)
    frames later); flush() retires the rest."""

    def __init__(self, tracker, ecfg: ExtractorConfig, chunk: int = 16, lag: int = 1,
                 map_lock=None, rounds: int = 3, iters: int = 6, stereo: bool = False,
                 min_z: float = 0.3, rgbd: bool = False, depth_scale: float = 1.0,
                 th_far: float = 0.0):
        if tracker.cfg.cam.height == 0 or tracker.cfg.cam.width == 0:
            raise ValueError("the camera needs its image size for the chunk step")
        if stereo and rgbd:
            raise ValueError("a frontend is stereo or RGB-D, not both")
        self.tracker = tracker
        self.cfg = tracker.cfg
        self.device = tracker.device
        self.ecfg = ecfg
        self.chunk = chunk
        self.lag = lag
        # reentrant: the retire loop holds it per frame, keyframe creation and
        # the slow path take it again on the same thread
        self.map_lock = map_lock or threading.RLock()
        self.rounds = rounds
        self.iters = iters
        # stereo: rectified pairs, matched per frame (min_z: the least depth);
        # RGB-D: a float32 depth map per frame (depth_scale: map units to
        # meters; th_far > 0 drops farther readings)
        self.stereo = stereo
        self.min_z = min_z
        self.rgbd = rgbd
        self.depth_scale = depth_scale
        self.th_far = th_far
        self._step = None
        # [(fid, ts, img_u8 host, img device, right image / depth map host,
        #   device, padded IMU (acc, gyro, dts, valid) or None)]
        self._buf = []
        self._pending: deque[_PendingChunk] = deque()
        self.state: DeviceTrackState | VITrackState | None = None
        self.cache: MapCache | None = None
        self.cache_ids: np.ndarray | None = None
        # consecutive frames below min_inliers_local: one dip must not
        # trigger the slow-path replay (the reference tolerates ~3 s of
        # RECENTLY_LOST, src/Tracking.cc:1990); below HARD_FLOOR it does
        self._low_streak = 0
        self.stats = TimeStats()  # per-stage wall time
        # the AsyncLocalMapper, if mapping runs on a worker: its keyframes are
        # released at the end of each retire and drained at the start of the
        # next, so the worker runs during the dispatch in between
        self.async_mapper = None
        self.loss_fn = None  # Atlas recovery on LOST (SlamSystem._handle_loss)
        # device-state anchors: [(kf, frame_id, T_kw 4x4)] recorded when the
        # cache is built; a background commit that moves the map before the
        # next retire is applied to the device state through the anchor's
        # pose delta
        self._anchor = None
        # ---- inertial: the IMU frontend (tracking/imu_frontend.py) or None
        self.imu = tracker.imu
        self._vi = False  # the IMU is initialized: the VI chunk step runs
        # consumption epochs: imu.align_log (every similarity the staged init
        # applied to the map, each applied to the frontend once) and
        # imu.bias_epoch (biases the solvers refined, adopted by the device
        # state, UpdateFrameIMU, src/Tracking.cc:3983)
        self._align_epoch = 0
        self._bias_epoch = 0
        self._dr_streak = 0  # consecutive dead-reckoned frames
        # the bias the pre-init chunks integrate at: the IMU frontend's as of
        # the last retire or slow-path frame (the dispatch runs while the
        # mapper worker may be committing a new one)
        self._pre_bias = None if self.imu is None else self.imu.bias
        # camera frame spacing, for the velocity seed of the switch to VI
        self._frame_dt = None
        self._last_ts = None

    # ------------------------------------------------------------- cache
    def refresh_cache(self):
        """Rebuild the device point cache from the current local map: the
        whole active map while it fits CACHE_CAP, else the reference
        keyframe's covisibility window. One pinned upload per field."""
        t = self.tracker
        m = t.map
        k = t.ref_kf
        if k < 0 or not m.kf_valid[k]:
            return
        all_mp = m.point_indices()
        if len(all_mp) <= CACHE_CAP:
            mp = all_mp
        else:
            window = [k] + [int(x) for x in m.best_covisible(k, 10, min_weight=5)]
            obs = m.kf_obs[window]
            mp = np.unique(obs[obs >= 0])
            mp = mp[m.mp_valid[mp]][:CACHE_CAP]
        n = len(mp)
        pos = np.zeros((CACHE_CAP, 3), np.float32)
        desc = np.zeros((CACHE_CAP, 8), np.uint32)
        valid = np.zeros(CACHE_CAP, bool)
        ids = np.full(CACHE_CAP, -1, np.int32)
        pos[:n] = m.mp_pos[mp]
        desc[:n] = m.mp_desc[mp]
        valid[:n] = True
        ids[:n] = mp
        dev = self.device
        self.cache = MapCache(upload(pos, dev), upload(desc.view(np.int32), dev),
                              upload(valid, dev), upload(ids, dev))
        self.cache_ids = ids

    def _up(self, a):
        return upload(np.asarray(a, np.float32), self.device)

    def _sync_state_from_tracker(self):
        t = self.tracker
        T = t.last.T_cw
        ok = torch.ones((), dtype=torch.bool, device=self.device)
        if self._vi:
            # the VI state from the tracker and the IMU frontend (after a
            # stage change, a loss, a slow-path frame)
            imu = self.imu
            self.state = VITrackState(
                R=self._up(T.R), t=self._up(T.t), v_w=self._up(imu.v_w),
                bg=imu.bias.bg.to(self.device), ba=imu.bias.ba.to(self.device),
                H_prior=self._up(imu.marg_prior if imu.marg_prior is not None else _FIXED_INFO),
                ok=ok)
            return
        T_prev = T if t.velocity is None else t.velocity.inverse() @ T
        self.state = DeviceTrackState(R=self._up(T.R), t=self._up(T.t), R_prev=self._up(T_prev.R),
                                      t_prev=self._up(T_prev.t), ok=ok)

    def _fix_device_state(self, A, s_al):
        """A world similarity on the device state (x' = s A x)."""
        At = self._up(A)
        st = self.state
        if isinstance(st, VITrackState):
            # the marginal's tangent frame rotated with the world
            return st._replace(R=st.R @ At.T, t=s_al * st.t, v_w=s_al * (At @ st.v_w),
                               H_prior=self._up(_FIXED_INFO))
        return DeviceTrackState(st.R @ At.T, s_al * st.t, st.R_prev @ At.T, s_al * st.t_prev,
                                st.ok)

    def _vi_state_from_device(self, A, s_al):
        """The first VI state when the staged init switches the pipeline: the
        visual head pose in the new world, and the velocity finite-
        differenced from the visual state's own last two poses (the keyframe
        chain's newest velocity is up to chunk * (lag + 1) frames stale),
        under a prior that keeps pose and bias stiff and the velocity
        moderately free."""
        imu = self.imu
        At = self._up(A)
        R_new = self.state.R @ At.T
        t_new = s_al * self.state.t
        v_seed = np.asarray(imu.v_w, np.float32)
        dt = self._frame_dt
        if dt and dt > 0:
            R_h, t_h, R_p, t_p = fetch((R_new, t_new, self.state.R_prev, self.state.t_prev))
            R_p = R_p @ A.T
            t_p = s_al * t_p
            v_fd = (-R_h.T @ t_h + R_p.T @ t_p) / dt
            if np.isfinite(v_fd).all() and np.linalg.norm(v_fd) < 50.0:
                # the camera centre's velocity ~ the body's (the lever arm is
                # second order for a seed the solver refines)
                v_seed = v_fd.astype(np.float32)
        H0 = _FIXED_INFO.copy()
        H0[6:9, 6:9] = np.eye(3, dtype=np.float32) * 10.0
        return VITrackState(R=R_new, t=t_new, v_w=self._up(v_seed),
                            bg=imu.bias.bg.to(self.device), ba=imu.bias.ba.to(self.device),
                            H_prior=self._up(H0),
                            ok=torch.ones((), dtype=torch.bool, device=self.device))

    def _switch_to_vi(self, A=None, s_al=1.0):
        """The IMU came up: the VI chunk step from the next dispatch on."""
        self._vi = True
        self._step = None
        if self.state is not None and A is not None:
            self.state = self._vi_state_from_device(A, s_al)

    def _consume_alignments(self, p: _PendingChunk = None, start: int = 0) -> bool:
        """Apply the similarities the asynchronous staged init committed
        since the last call (InitializeIMU on the LocalMapping thread,
        src/LocalMapping.cc:200), map lock held: to the retiring chunk's
        frames from `start` on, to every pending chunk, and to the device
        state (switching to the VI step at the first init); then the cache
        is rebuilt."""
        imu = self.imu
        if imu is None or self._align_epoch >= len(imu.align_log):
            return False
        while self._align_epoch < len(imu.align_log):
            A, s_al = imu.align_log[self._align_epoch]
            self._align_epoch += 1
            if p is not None:
                p.outs = _fix_outs(p.outs, start, A, s_al, p.vi)
            for q in self._pending:
                q.world_fix.append((A, s_al))
            if imu.initialized and not self._vi:
                self._switch_to_vi(A, s_al)
            elif self.state is not None:
                self.state = self._fix_device_state(A, s_al)
        # the similarity moved the state and the map together: the anchors'
        # poses from before it must not be differenced against the map after
        self._anchor = None
        self.refresh_cache()
        return True

    def _adopt_bias(self):
        """Push solver-refined biases (VI window BA, staged init) into the
        device state: the per-frame walk is stiff and cannot absorb an
        init's residual gravity tilt."""
        imu = self.imu
        if self._vi and self.state is not None and self._bias_epoch < imu.bias_epoch:
            self._bias_epoch = imu.bias_epoch
            self.state = self.state._replace(bg=imu.bias.bg.to(self.device),
                                             ba=imu.bias.ba.to(self.device))

    def _hand_back(self, p: _PendingChunk, i):
        """The device-solved inertial state of frame i to the IMU frontend
        (a keyframe carries it; the slow path predicts from it)."""
        imu = self.imu
        imu.v_w = np.asarray(p.outs.v_w[i], np.float32)
        imu.bias = ImuBias(self._up(p.outs.bg[i]), self._up(p.outs.ba[i]))

    def _preint_host(self):
        """The keyframe interval as numpy (the retire loop merges on the host)."""
        pre = self.imu.preint_kf
        if pre is not None and isinstance(pre.dT, torch.Tensor):
            self.imu.preint_kf = fetch(pre)

    def _preint_device(self):
        """The keyframe interval on the device (the slow path merges there)."""
        pre = self.imu.preint_kf if self.imu is not None else None
        if pre is not None and not isinstance(pre.dT, torch.Tensor):
            self.imu.preint_kf = _tree_map(self._up, pre)

    def _record_anchor(self):
        """Record the poses of the reference keyframe AND two close
        covisibles (map lock held): culling between dispatches must not
        leave the device state uncorrected."""
        t = self.tracker
        m = t.map
        k = t.ref_kf
        if k < 0 or not m.kf_valid[k]:
            self._anchor = None
            return
        anchors = []
        for a in [int(k)] + [int(x) for x in m.best_covisible(int(k), 2, min_weight=5)]:
            if m.kf_valid[a]:
                anchors.append((a, int(m.kf_frame_id[a]), t._kf_matrix(a)))
        self._anchor = anchors or None

    def _apply_anchor_correction(self):
        """Apply the first surviving anchor's pose delta since the last
        record to the device state (map lock held): the async local BA moved
        the map between dispatches."""
        if self._anchor is None or self.state is None:
            return
        m = self.tracker.map
        for ak, afid, aT in self._anchor:
            if not (m.kf_valid[ak] and int(m.kf_frame_id[ak]) == afid):
                continue
            W = np.linalg.inv(aT) @ self.tracker._kf_matrix(ak)
            if np.abs(W - np.eye(4)).max() > 1e-7:
                self._apply_world_correction(W)
            return
        log.info("anchor keyframes all culled; device state uncorrected")

    def _apply_world_correction(self, W):
        """T' = T @ W for the device pose and its predecessor, on the device.
        The VI state's velocity rotates with it (v' = W_R^T v), and a large
        correction re-anchors the marginal prior near-fixed (its tangent
        frame moved)."""
        Wt = torch.as_tensor(W, dtype=torch.float32).to(self.device)
        bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=self.device)

        def corr(R, tt):
            T4 = torch.cat([torch.cat([R, tt[:, None]], dim=1), bottom], dim=0) @ Wt
            return T4[:3, :3], T4[:3, 3]

        R1, t1 = corr(self.state.R, self.state.t)
        if isinstance(self.state, VITrackState):
            big = np.abs(W[:3, 3]).max() > 0.05 or np.abs(W[:3, :3] - np.eye(3)).max() > 0.02
            self.state = self.state._replace(
                R=R1, t=t1, v_w=Wt[:3, :3].T @ self.state.v_w,
                H_prior=self._up(_FIXED_INFO) if big else self.state.H_prior)
            return
        R0, t0 = corr(self.state.R_prev, self.state.t_prev)
        self.state = DeviceTrackState(R1, t1, R0, t0, self.state.ok)

    def _chunk_step(self) -> ChunkStep:
        if self._step is None:
            args = (self.tracker.cam, self.cfg.inv_level_sigma2(), self.ecfg)
            if self._vi:
                icfg = self.imu.cfg
                if self.stereo:
                    self._step = make_vi_chunk_step_stereo(*args, icfg, self.cfg.bf, self.min_z,
                                                           self.iters, device=self.device)
                elif self.rgbd:
                    self._step = make_vi_chunk_step_rgbd(*args, icfg, self.cfg.bf,
                                                         self.depth_scale, self.th_far,
                                                         self.iters, device=self.device)
                else:
                    self._step = make_vi_chunk_step(*args, icfg, self.iters, device=self.device)
            elif self.stereo:
                self._step = make_chunk_step_stereo(*args, self.cfg.bf, self.min_z, self.rounds,
                                                    self.iters, device=self.device)
            elif self.rgbd:
                self._step = make_chunk_step_rgbd(*args, self.cfg.bf, self.depth_scale,
                                                  self.th_far, self.rounds, self.iters,
                                                  device=self.device)
            else:
                self._step = make_chunk_step(*args, self.rounds, self.iters, device=self.device)
        return self._step

    # -------------------------------------------------------------- track
    def track_image(self, img, ts: float, img_right=None, imu_samples=None, depth_img=None):
        """img: (H, W) uint8 (or castable); img_right: the rectified right
        image, required in stereo mode; depth_img: (H, W) depth map (times
        depth_scale: meters), required in RGB-D mode; imu_samples: (acc (N,
        3), gyro (N, 3), dts (N,)) measured since the previous frame, for a
        tracker with an IMU frontend (ignored without one). Returns the
        retired frames."""
        if self.rgbd:
            if depth_img is None:
                raise ValueError("an RGB-D frontend needs depth_img with every frame")
            img_right = np.asarray(depth_img, np.float32)  # the depth rides the right slot
        elif self.stereo:
            if img_right is None:
                raise ValueError("a stereo frontend needs img_right with every frame")
            img_right = np.asarray(img_right, np.uint8)
        else:
            img_right = None
        if self.imu is None:
            imu_samples = None
        if self._last_ts is not None and ts > self._last_ts:
            self._frame_dt = ts - self._last_ts
        self._last_ts = ts
        t = self.tracker
        retired = []
        if t.state != OK or t.ref_kf < 0:
            # everything dispatched or buffered lands first
            retired += self.flush()
            retired.append(self._track_slow(np.asarray(img, np.uint8), ts, img_right,
                                            imu_samples))
            return retired
        img_h = np.asarray(img, np.uint8)
        with self.stats.measure("upload"):
            # one frame's copies as it arrives
            img_d = upload(img_h, self.device)
            imgr_d = None if img_right is None else upload(img_right, self.device)
        imu_p = None if self.imu is None else _pad_imu(imu_samples)
        self._buf.append((t.frame_id, ts, img_h, img_d, img_right, imgr_d, imu_p))
        t.frame_id += 1
        # while tracking sags, dispatch every 4 frames so keyframes and cache
        # refreshes land sooner
        effective = 4 if self._low_streak >= 2 else self.chunk
        if len(self._buf) >= effective:
            self._dispatch_buffer()
            while len(self._pending) > self.lag:
                retired += self._retire_chunk(self._pending.popleft())
        return retired

    def flush(self):
        """Dispatch any buffered frames and retire every pending chunk."""
        t = self.tracker
        if (t.state != OK or t.ref_kf < 0) and (self._buf or self._pending):
            # the fast path is unusable: replay everything through the slow path
            replay = []
            while self._pending:
                q = self._pending.popleft()
                replay += self._frames_of(q, 0)
            replay += self._buffered_frames()
            results = []
            for fid, ts, img, img_r, imu_s in replay:
                t.frame_id = fid
                results.append(self._track_slow(img, ts, img_r, imu_s))
            return results
        retired = []
        if self._buf:
            self._dispatch_buffer()
        while self._pending:
            retired += self._retire_chunk(self._pending.popleft())
        return retired

    # ------------------------------------------------------------ internal
    def _drain_mapper(self):
        """Hand the held keyframes to the async mapper and wait until it has
        processed them (map lock not held)."""
        if self.async_mapper is not None:
            with self.stats.measure("mapper_wait"):
                self.async_mapper.flush()

    @staticmethod
    def _frames_of(q: _PendingChunk, start: int):
        """(fid, ts, img, right image / depth map, IMU samples) of a pending
        chunk's frames from `start` on, for the slow-path replay."""
        return [(q.fids[i], q.tss[i], q.imgs[i], q.imgs_r[i],
                 None if q.imu is None else _imu_raw(tuple(x[i] for x in q.imu)))
                for i in range(start, q.n_valid)]

    def _buffered_frames(self):
        """The buffered frames for the slow-path replay; the buffer empties."""
        frames = [(b[0], b[1], b[2], b[4], None if b[6] is None else _imu_raw(b[6]))
                  for b in self._buf]
        self._buf = []
        return frames

    def _slow_frame(self, img_d, img_r):
        """The slow path's frame through the extractor on the device, with
        its stereo match (stereo) or depth lookup (RGB-D): host (Features,
        depth, ur), depth and ur None for a monocular frame."""
        step = self._chunk_step()
        if not (self.stereo or self.rgbd):
            feats = Features(*(f[0] for f in step.extractor(img_d[None])))
            return features_to_host(feats), None, None
        if self.stereo:
            both = step.extractor(torch.stack([img_d, upload(img_r, self.device)]))
            feats, feats_r = (Features(*(f[i] for f in both)) for i in (0, 1))
            u_r, d, ok = match_stereo(feats.uv, feats.desc, feats.level, feats.valid,
                                      feats_r.uv, feats_r.desc, feats_r.level, feats_r.valid,
                                      self.cfg.bf, self.min_z)
            feats, ur, depth = fetch((feats, torch.where(ok, u_r, -1.0), torch.where(ok, d, -1.0)))
        else:
            feats = Features(*(f[0] for f in step.extractor(img_d[None])))
            d = depth_from_depthmap(feats.uv, upload(img_r, self.device), self.depth_scale)
            if self.th_far > 0:
                d = torch.where(d > self.th_far, -1.0, d)
            ur = virtual_right(feats.uv, d, self.cfg.bf) if self.cfg.bf > 0 else None
            feats, ur, depth = fetch((feats, ur, d))
        return Features(feats.uv, feats.desc.view(np.uint32), *feats[2:]), depth, ur

    def _track_slow(self, img, ts, img_r=None, imu_samples=None):
        """Per-frame slow path (initialization, recovery): the mapper is
        drained before and after, so the frame sees, and the fast path
        resumes on, a map no worker is changing. img_r: the frame's right
        image (stereo) or depth map (RGB-D)."""
        with self.stats.measure("slow_path"):
            t = self.tracker
            img_d = upload(np.asarray(img, np.uint8), self.device)
            feats, depth, ur = self._slow_frame(img_d, img_r)
            self._drain_mapper()
            with self.map_lock:
                self._preint_device()
                fid = t.frame_id
                T = t.track(feats, ts, depth=depth, ur=ur, imu_samples=imu_samples)
                if t.state == LOST and self.loss_fn is not None:
                    self.loss_fn()  # Atlas recovery: store the map / start fresh
            self._drain_mapper()
            with self.map_lock:
                # an init committed meanwhile (the tracker's pose moved with
                # the map): keep the epoch current; the state is rebuilt below
                self._consume_alignments()
                if t.state == OK:
                    if self.imu is not None and self.imu.initialized and not self._vi:
                        self._switch_to_vi()
                    self.refresh_cache()
                    self._sync_state_from_tracker()
                    self._record_anchor()
                if self.imu is not None:
                    self._pre_bias = self.imu.bias
        return (fid, ts, T)

    def _upload_imu(self, imu_stack):
        """The chunk's padded IMU stacks on the device, trimmed to its
        largest valid count."""
        n = max(1, int(imu_stack[3].sum(axis=1).max()))
        return tuple(upload(x[:, :n], self.device) for x in imu_stack)

    def _dispatch_buffer(self):
        # the cache was built at the end of the last retire (or by the slow
        # path); the map is not read here, the async mapper may be writing it
        if self.state is None or self.cache is None:
            with self.stats.measure("cache_refresh"), self.map_lock:
                self.refresh_cache()
                self._sync_state_from_tracker()
                self._record_anchor()
        step = self._chunk_step()
        imu_stack = None
        if self.imu is not None:
            # (acc, gyro, dts, valid), each (K, IMU_CAP, ...)
            imu_stack = tuple(np.stack([b[6][j] for b in self._buf]) for j in range(4))
        pres = None
        with self.stats.measure("dispatch"):
            imgs_d = torch.stack([b[3] for b in self._buf])
            right = (torch.stack([b[5] for b in self._buf]),) if self.stereo or self.rgbd else ()
            if self._vi:
                out = step(self.state, self.cache, imgs_d, *right, *self._upload_imu(imu_stack))
            else:
                out = step(self.state, self.cache, imgs_d, *right)
                if self.imu is not None:
                    # before the IMU init: the frames' intervals for the
                    # keyframe chain, one batched integration a chunk
                    c = self.imu.cfg
                    pres = integrate(*self._upload_imu(imu_stack), self._pre_bias,
                                     c.noise_gyro, c.noise_acc, c.walk_gyro, c.walk_acc, c.freq)
            self.state, outs, feats = out[:3]
            urs, depths = out[3:] if right else (None, None)
            # the outputs and the chunk's features start copying home now and
            # are read a chunk later; keyframe creation at retire time is then
            # pure host work
            readback = Readback((outs, feats, urs, depths, pres))
        self._pending.append(_PendingChunk([b[0] for b in self._buf], [b[1] for b in self._buf],
                                           readback, self.cache_ids,
                                           [b[2] for b in self._buf], [b[4] for b in self._buf],
                                           imu=imu_stack, vi=self._vi))
        self._buf = []

    @staticmethod
    def _features(p: _PendingChunk, i) -> Features:
        """Host features of frame i of a retired chunk (descriptors uint32)."""
        f = p.feats
        return Features(f.uv[i], f.desc[i].view(np.uint32), f.angle[i], f.level[i],
                        f.response[i], f.valid[i])

    def _retire_chunk(self, p: _PendingChunk):
        """Retire a chunk on a quiet map: wait for the keyframes released at
        the last retire, carry the mapper's moves (and an init's similarity)
        into the device state, replay the frames, build the next dispatch's
        cache, then release this retire's keyframes to the worker."""
        am = self.async_mapper
        if am is not None:
            with self.stats.measure("mapper_wait"):
                am.wait_drained()
        with self.stats.measure("retire_sync"):
            p.outs, p.feats, p.urs, p.depths, p.pres = p.readback.wait()
            p.readback = None
            for A, s_al in p.world_fix:
                p.outs = _fix_outs(p.outs, 0, A, s_al, p.vi)
        with self.stats.measure("retire_host"):
            with self.map_lock:
                self._consume_alignments(p, 0)
                self._adopt_bias()
                self._apply_anchor_correction()
            results = self._retire_frames(p, [])
        if self.state is not None:
            with self.stats.measure("cache_refresh"), self.map_lock:
                self.refresh_cache()
                self._adopt_bias()
                self._record_anchor()
        if self.imu is not None:
            self._pre_bias = self.imu.bias
        if am is not None:
            am.release()
        return results

    def _retire_frames(self, p, results):
        for i in range(p.n_valid):
            # per-frame lock scope; the replay (which drains the worker)
            # runs outside it
            with self.map_lock:
                replay_from = self._retire_one(p, i, results)
            if replay_from is not None:
                results += self._replay_after_loss(p, replay_from)
                return results
        return results

    def _retire_one(self, p, i, results):
        """Retire frame i of chunk p (map lock held). Returns the index to
        replay from after a loss, else None."""
        t = self.tracker
        m = t.map
        cfg = self.cfg
        imu = self.imu
        self._consume_alignments(p, i)
        if p.vi:
            R_all, t_all, n_inl_all, obs_cache_all = p.outs[:2] + p.outs[5:7]
        else:
            R_all, t_all, n_inl_all, obs_cache_all = p.outs
        fid, ts = p.fids[i], p.tss[i]
        depth = None if p.depths is None else p.depths[i]
        ur = None if p.urs is None else p.urs[i]
        enc = int(n_inl_all[i])
        # a VI frame whose solve was rejected carries -n_inliers - 1
        dead_reckoned = p.vi and enc < 0
        n_inl = -enc - 1 if dead_reckoned else enc
        R, tt = R_all[i], t_all[i]
        T = SE3np(R, tt)
        obs_mp = np.full(self.ecfg.n_features, NO_POINT, np.int32)
        hit = obs_cache_all[i] >= 0
        obs_mp[hit] = p.cache_ids[obs_cache_all[i][hit]]
        stale = (obs_mp != NO_POINT) & ~m.mp_valid[np.maximum(obs_mp, 0)]
        obs_mp[stale] = NO_POINT
        T_abs = np.eye(4)
        T_abs[:3, :3] = R
        T_abs[:3, 3] = tt
        if imu is not None:
            # the frame's interval joins the keyframe's (mpImuPreintegratedFromLastKF);
            # the slow path keeps the same field through integrate_frame
            self._preint_host()
            pre_i = pre_slice_np(p.outs.pre if p.vi else p.pres, i)
            imu.preint_kf = pre_i if imu.preint_kf is None else merge_np(imu.preint_kf, pre_i)
            if not p.vi and t.last is not None and ts > t.last.ts:
                # before the IMU init: the velocity from the camera centres
                c_prev = -t.last.T_cw.R.T @ t.last.T_cw.t
                imu.v_w = ((-R.T @ tt - c_prev) / (ts - t.last.ts)).astype(np.float32)
        if dead_reckoned:
            # the IMU bridges the visual dropout on the device (RECENTLY_LOST
            # with PredictStateIMU): the predicted pose is published, no
            # keyframe, for up to DR_BUDGET frames
            self._dr_streak += 1
            self._low_streak = 0
            if self._dr_streak <= DR_BUDGET:
                t.velocity = None
                t.last = FrameRecord(self._features(p, i), T, obs_mp, ts, fid, depth=depth, ur=ur)
                t.frames_since_kf += 1
                t.trajectory.append((ts, fid, -1, -1, T_abs, T_abs))
                results.append((fid, ts, T_abs))
                return None
            n_inl = 0  # the budget is spent: the loss below
        else:
            self._dr_streak = 0
        self._low_streak = self._low_streak + 1 if n_inl < cfg.min_inliers_local else 0
        if n_inl < HARD_FLOOR:
            # lost mid-chunk: the rest of this chunk and every later frame
            # replays through the per-frame slow path
            log.info("chunked loss at frame %d: n_inl=%d (vi=%s, kfs=%d mps=%d)", fid, n_inl,
                     p.vi, m.n_keyframes(), m.n_points())
            self._low_streak = 0
            self._dr_streak = 0
            t.state = RECENTLY_LOST
            t.last = FrameRecord(self._features(p, i), T, obs_mp, ts, fid, depth=depth, ur=ur)
            if p.vi:
                # the slow path predicts from the device's inertial state
                self._hand_back(p, i)
                imu.marg_prior = None
                imu._marg_pending = None
            self.state = None
            self.cache = None
            results.append((fid, ts, None))
            return i + 1  # the caller replays outside the lock
        # a sagging-but-alive streak: force one keyframe (longer cooldown than
        # the policy's) and stay on the fast path
        force_kf = (self._low_streak >= LOW_STREAK_LIMIT and n_inl >= 15
                    and t.frames_since_kf + 1 >= 2 * cfg.min_frames_between_kf)
        if force_kf:
            self._low_streak = 0
        rec = FrameRecord(self._features(p, i), T, obs_mp, ts, fid, depth=depth, ur=ur)
        if t.last is not None:
            vR = R @ t.last.T_cw.R.T
            t.velocity = SE3np(vR, tt - vR @ t.last.T_cw.t)
        t.last = rec
        t.frames_since_kf += 1
        t.n_last_inliers = n_inl
        ref = t.ref_kf
        if ref >= 0 and m.kf_valid[ref]:
            t.trajectory.append((ts, fid, ref, int(m.kf_frame_id[ref]),
                                 T_abs @ np.linalg.inv(t._kf_matrix(ref)), T_abs))
        else:
            t.trajectory.append((ts, fid, -1, -1, T_abs, T_abs))
        if force_kf or t._need_new_keyframe(n_inl):
            with self.stats.measure("keyframe"):
                if p.vi:
                    self._hand_back(p, i)  # the keyframe carries the solved state
                n_align = len(imu.align_log) if imu is not None else 0
                t._create_keyframe(rec)
                if imu is not None and len(imu.align_log) > n_align:
                    # the synchronous staged init realigned the world by a
                    # known similarity: the same goes to this chunk's later
                    # frames, the pending chunks and the device state
                    A, s_al = imu.last_alignment
                    p.outs = _fix_outs(p.outs, i + 1, A, s_al, p.vi)
                    self._align_epoch = len(imu.align_log)
                    for q in self._pending:
                        q.world_fix.append((A, s_al))
                    if imu.initialized and not self._vi:
                        self._switch_to_vi(A, s_al)
                    elif self.state is not None:
                        self.state = self._fix_device_state(A, s_al)
                else:
                    # a synchronous mapper may have moved the new keyframe:
                    # carry the correction W into the device state
                    W = np.linalg.inv(T_abs) @ t._kf_matrix(t.ref_kf)
                    if np.abs(W - np.eye(4)).max() > 1e-9 and self.state is not None:
                        self._apply_world_correction(W)
                    if p.vi and self.state is not None:
                        # the prior re-anchors at the keyframe (the first frame
                        # after a keyframe solves against it, src/Optimizer.cc:4491)
                        self.state = self.state._replace(H_prior=self._up(_FIXED_INFO))
                self._record_anchor()
        results.append((fid, ts, T_abs))
        return None

    def _replay_after_loss(self, p: _PendingChunk, start: int):
        """Feed the frames after a mid-chunk loss through the slow path until
        the tracker recovers, then hand the rest back to the fast path."""
        t = self.tracker
        results = []
        replay = self._frames_of(p, start)
        while self._pending:
            replay += self._frames_of(self._pending.popleft(), 0)
        replay += self._buffered_frames()
        for j, (fid, ts, img, img_r, imu_s) in enumerate(replay):
            if t.state == OK and t.ref_kf >= 0 and j > 0:
                for fid2, ts2, img2, img_r2, imu_s2 in replay[j:]:
                    t.frame_id = fid2
                    results += self.track_image(img2, ts2, imu_samples=imu_s2,
                                                **self._right_kw(img_r2))
                    t.frame_id = max(t.frame_id, fid2 + 1)
                return results
            t.frame_id = fid  # keep the original frame ids through the replay
            results.append(self._track_slow(img, ts, img_r, imu_s))
        return results

    def _right_kw(self, img_r):
        """track_image's keyword for a kept right image or depth map."""
        if self.rgbd:
            return {"depth_img": img_r}
        return {"img_right": img_r} if self.stereo else {}


def _pad_imu(imu_samples):
    """(acc, gyro, dts) -> IMU_CAP-padded (acc, gyro, dts, valid); None: no samples."""
    a = np.zeros((IMU_CAP, 3), np.float32)
    g = np.zeros((IMU_CAP, 3), np.float32)
    d = np.zeros(IMU_CAP, np.float32)
    v = np.zeros(IMU_CAP, bool)
    if imu_samples is not None:
        acc, gyro, dts = imu_samples
        n = min(len(dts), IMU_CAP)
        a[:n] = np.asarray(acc, np.float32).reshape(-1, 3)[:n]
        g[:n] = np.asarray(gyro, np.float32).reshape(-1, 3)[:n]
        d[:n] = np.asarray(dts, np.float32)[:n]
        v[:n] = True
    return a, g, d, v


def _imu_raw(imu_p):
    """The real samples of a padded (acc, gyro, dts, valid)."""
    a, g, d, v = imu_p
    n = int(v.sum())
    return (a[:n], g[:n], d[:n])
