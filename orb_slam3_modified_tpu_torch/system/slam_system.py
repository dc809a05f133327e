"""Top-level SLAM system: monocular, stereo and RGB-D, each with or without
an IMU.

Port of orb_slam3_modified_tpu/system/slam_system.py (System: ctor :41,
TrackMonocular :426, TrackStereo :271, TrackRGBD :349, Shutdown :555,
trajectory savers :609-700 of src/System.cc; the Atlas recovery of
Tracking::CreateMapInAtlas, src/Tracking.cc:2665, :2020-2026). It wires the
tracker, the local mapper and the loop closer over the shared numpy map,
relocalizes a lost tracker against the keyframe database, handles LOST ->
new map (which the closer merges back when it recognizes the place), and
writes trajectories in TUM format.

Stereo frames are matched left -> right on the device (rectified pinhole
pairs by row band, non-rectified ones such as KB8 fisheye by descriptor and
triangulation, ops/stereo_match.py); RGB-D frames look their depth up at the
keypoints and get the virtual right uR = u - bf/z. As in the reference, the
loop closer's Sim3 scale stays free for these sensors (only the inertial
ones fix it). Unlike the reference, which keeps the monocular keyframe
ratio for every sensor, these sensors take ORB-SLAM3's 0.75: a keyframe's
close points, spawned from depth and not yet re-observed, count in its
observations, and at 0.9 a mapper that keeps up inserts a keyframe every
few frames.

The inertial sensors (IMU_MONOCULAR, IMU_STEREO, IMU_RGBD) run frame by frame:
track_monocular_inertial, and track_stereo / track_rgbd with imu_samples=.
The tracker, the local mapper and the loop closer share one IMU frontend
(tracking/imu_frontend.py): preintegration, the staged init, the VI frame
solve, the mapper's VI window BA, the closer's scale-fixed Sim3, inertial
weld and VI global BA. IMU_MONOCULAR keeps the monocular keyframe ratio,
the other two the depth sensors'. The chunked frontend runs them too
(make_chunked_frontend, track_image(..., imu_samples=)): the VI chunk step
once the IMU is initialized, and the staged init on the mapper worker.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..bow.vocabulary import Vocabulary, default_vocabulary
from ..cameras import Camera
from ..cameras.rectify import make_keypoint_undistorter
from ..features.extractor import ExtractorConfig, Features, ORBExtractor
from ..lie import so3
from ..loop.loop_closer import LoopCloser, LoopCloserConfig
from ..loop.relocalization import relocalize
from ..mapping.local_mapper import LocalMapper, LocalMapperConfig
from ..ops.stereo_match import (
    depth_from_depthmap, match_stereo, match_stereo_general, virtual_right,
)
from ..slam_map.map_state import MapState
from ..tracking.tracker import (
    LOST, NOT_INITIALIZED, RECENTLY_LOST, Tracker, TrackerConfig, features_to_host,
)
from ..utils.fetch import fetch, upload
from ..utils.timing import TimeStats

MONOCULAR = 0
STEREO = 1
RGBD = 2
IMU_MONOCULAR = 3
IMU_STEREO = 4
IMU_RGBD = 5

_INERTIAL = (IMU_MONOCULAR, IMU_STEREO, IMU_RGBD)


@dataclasses.dataclass
class SystemConfig:
    cam: Camera = None
    sensor: int = MONOCULAR
    vocabulary: Vocabulary = None  # None: the vocabulary shipped in assets/
    max_kf: int = 512
    max_mp: int = 65536
    feat_cap: int = 1024
    use_loop_closing: bool = True  # the loopClosing YAML flag
    min_kfs_for_new_map: int = 10  # reference: > 10 KFs -> new map on LOST
    extractor: ExtractorConfig = None
    device: str = "cuda"
    # stereo / RGB-D (the reference's Settings stereo block, include/Settings.h:44-121)
    bf: float = 0.0  # baseline * fx (mbf); rectified pairs, RGB-D's virtual baseline
    min_depth: float = 0.3  # stereo: the least depth (= bf / the largest disparity)
    depth_scale: float = 1.0  # RGB-D: depth map units -> meters (mDepthMapFactor)
    # depth readings beyond this are dropped (thFarPoints, src/System.cc:199-209); 0 = off
    th_far_points: float = 0.0
    # non-rectified stereo (fisheye): the right camera and T_rl (4, 4), p_right = T_rl p_left
    cam_right: Camera = None
    T_rl: object = None
    # pinhole radial-tangential distortion (k1, k2, p1, p2[, k3]): keypoints are
    # undistorted after extraction, descriptors stay on the raw image
    # (Frame::UndistortKeyPoints, src/Frame.cc:746)
    dist: object = None
    imu: object = None  # tracking/imu_frontend.py::ImuConfig of the inertial sensors


class SlamSystem:
    def __init__(self, cfg: SystemConfig):
        if cfg.sensor not in (MONOCULAR, STEREO, RGBD) + _INERTIAL:
            raise ValueError(f"unknown sensor {cfg.sensor}")
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.map = MapState.create(cfg.max_kf, cfg.max_mp, cfg.feat_cap)
        # NeedNewKeyFrame's thRefRatio (src/Tracking.cc): 0.9 monocular (with
        # or without IMU), 0.75 stereo / RGB-D; the JAX package takes 0.9 for
        # every sensor
        mono = cfg.sensor in (MONOCULAR, IMU_MONOCULAR)
        self.tcfg = TrackerConfig(cam=cfg.cam, bf=float(cfg.bf),
                                  kf_tracked_ratio=0.9 if mono else 0.75)
        self.tracker = Tracker(self.tcfg, self.map, device=self.device)
        self.mapper = LocalMapper(LocalMapperConfig(), self.tcfg, self.map, device=self.device)
        self.timing = TimeStats()
        self.async_mapper = None
        self.closer = None
        if cfg.use_loop_closing:
            voc = cfg.vocabulary or default_vocabulary()
            self.closer = LoopCloser(LoopCloserConfig(), self.tcfg, voc, self.map,
                                     device=self.device)
            self.tracker.relocalize_fn = self._relocalize
        self._last_reloc_fail = None
        self.reloc_attempts = 0
        self.reloc_successes = 0
        self.tracker.on_keyframe = self._on_keyframe
        if cfg.sensor in _INERTIAL:
            from ..tracking.imu_frontend import ImuConfig, ImuFrontend

            imu_cfg = cfg.imu or ImuConfig()
            # a stereo / RGB-D-inertial map is metric from the baseline: the
            # init must not re-solve its scale (InitializeIMU's bMonocular,
            # src/LocalMapping.cc:1173)
            imu_cfg.mono = cfg.sensor == IMU_MONOCULAR
            imu = ImuFrontend(imu_cfg, device=self.device)
            self.tracker.imu = imu
            self.mapper.imu = imu
            if self.closer is not None:
                # gravity fixes roll and pitch and, with the IMU, the scale:
                # the loop Sim3 is scale-fixed (bFixScale)
                self.closer.cfg.fix_scale = True
                self.closer.imu = imu
                self.closer.vi_refine_fn = self.mapper._vi_refine  # MergeInertialBA
        self.ecfg = cfg.extractor or ExtractorConfig(n_features=cfg.feat_cap)
        self._extractor = None
        self._undistort_kp = None
        if cfg.dist is not None and np.any(np.asarray(cfg.dist) != 0):
            c = cfg.cam.params.detach().cpu().numpy().astype(np.float64)
            K = np.array([[c[0], 0, c[2]], [0, c[1], c[3]], [0, 0, 1]])
            self._undistort_kp = make_keypoint_undistorter(K, cfg.dist)
        self.poses = []  # (ts, T_cw 4x4 or None)
        self._localization_only = False

    # ------------------------------------------------------ mode / reset API
    def activate_localization_mode(self):
        """Tracking only: the map is frozen, no keyframes are created
        (System::ActivateLocalizationMode, include/System.h:156)."""
        self._localization_only = True
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        """System::DeactivateLocalizationMode (include/System.h:160)."""
        self._localization_only = False
        self.tracker.only_tracking = False

    def _clear_map(self, all_maps: bool):
        m = self.map
        for k in m.keyframe_indices(all_maps=all_maps):
            m.remove_keyframe(int(k))
        mps = m.point_indices(all_maps=all_maps)
        if len(mps):
            m.remove_point(mps)

    def reset(self):
        """Full reset: every map of the atlas and the tracker state
        (System::Reset -> Tracking::Reset, src/Tracking.cc:3782)."""
        self._clear_map(all_maps=True)
        m = self.map
        m.active_map = 0
        m.n_maps = 1
        m.imu_initialized = False
        m.n_inertial_ba = 0
        m.culled_redirect.clear()
        self._reset_tracker()
        self.poses = []

    def reset_active_map(self):
        """Reset only the active map (Tracking::ResetActiveMap,
        src/Tracking.cc:3843)."""
        self._clear_map(all_maps=False)
        self._reset_tracker()

    def _reset_tracker(self):
        t = self.tracker
        t.state = NOT_INITIALIZED
        t.init_frame = None
        t.last = None
        t.velocity = None
        t.ref_kf = -1
        t.lost_frames = 0
        t.frames_since_kf = 0
        imu = t.imu
        if imu is not None:
            imu.preint_frame = None
            imu.preint_kf = None
            imu.marg_prior = None
            imu._marg_pending = None
            imu.kf_chain = []
            imu.first_kf_ts = None
            imu.initialized = False
            imu.stage = 0
            imu.bad_imu = False
            imu.t_motion = 0.0
            imu.v_w = np.zeros(3, np.float32)
            imu.refine_idx = 0
            imu._epoch += 1  # in-flight asynchronous init solves abort at commit

    def _relocalize(self, feats, frame_id):
        """Relocalization with consecutive failing attempts spaced three
        frames apart (each costs a BoW query, matches, a batched PnP RANSAC
        and a polish)."""
        last = self._last_reloc_fail
        if last is not None and 0 <= frame_id - last < 3:
            return None
        self.reloc_attempts += 1
        with self.timing.measure("relocalize"):
            res = relocalize(self.tracker.cam, self.closer.kfdb, self.closer.voc, self.map, feats,
                             self.tcfg.inv_level_sigma2(), frame_id,
                             feats_dev=self.tracker._feats_dev(feats))
        self._last_reloc_fail = frame_id if res is None else None
        self.reloc_successes += res is not None
        return res

    # ------------------------------------------------------------------ API
    def _extract(self, *images) -> Features:
        """Device Features (B, F) of the images, extracted as one batch."""
        imgs = upload(np.stack([np.asarray(im, np.float32) for im in images]), self.device)
        if self._extractor is None:
            self._extractor = ORBExtractor(self.ecfg, imgs.shape[1], imgs.shape[2],
                                           device=self.device)
        return self._extractor(imgs)

    def _post_extract(self, feats: Features) -> Features:
        """Keypoint undistortion when dist is set (on the device)."""
        if self._undistort_kp is None:
            return feats
        return feats._replace(uv=self._undistort_kp(feats.uv))

    def track_monocular(self, image, ts: float):
        """image: (H, W) grayscale [0, 255] -> T_cw (4, 4) or None
        (System::TrackMonocular, src/System.cc:426)."""
        with self.timing.measure("extract"):
            feats = self._post_extract(Features(*(f[0] for f in self._extract(image))))
            feats = features_to_host(feats)
        return self.track_features(feats, ts)

    def track_monocular_inertial(self, image, ts: float, imu_samples):
        """The monocular-inertial entry (System::TrackMonocular with
        vImuMeas, src/System.cc:426): imu_samples = (acc (N, 3), gyro (N, 3),
        dts (N,)) measured since the previous frame."""
        with self.timing.measure("extract"):
            feats = self._post_extract(Features(*(f[0] for f in self._extract(image))))
            feats = features_to_host(feats)
        return self.track_features(feats, ts, imu_samples=imu_samples)

    def track_stereo(self, img_left, img_right, ts: float, imu_samples=None):
        """System::TrackStereo (src/System.cc:271): both images extracted in
        one batch, then the rectified row-band match (pinhole pairs) or, with
        cam_right set, the descriptor + triangulation match (non-rectified /
        fisheye); depth beyond th_far_points is dropped. imu_samples: the
        stereo-inertial sensor's samples since the previous frame."""
        with self.timing.measure("extract"):
            both = self._extract(img_left, img_right)
            feats, feats_r = (Features(*(f[i] for f in both)) for i in (0, 1))
        cfg = self.cfg
        with self.timing.measure("stereo_match"):
            if cfg.cam_right is not None:
                T_rl = torch.as_tensor(np.asarray(cfg.T_rl, np.float32))
                depth, ok = match_stereo_general(
                    feats.uv, feats.desc, feats.level, feats.valid,
                    feats_r.uv, feats_r.desc, feats_r.level, feats_r.valid,
                    cfg.cam, cfg.cam_right, T_rl[:3, :3], T_rl[:3, 3])
                ur = None
            else:
                u_r, depth, ok = match_stereo(
                    feats.uv, feats.desc, feats.level, feats.valid,
                    feats_r.uv, feats_r.desc, feats_r.level, feats_r.valid,
                    cfg.bf, cfg.min_depth)
                ur = torch.where(ok, u_r, -1.0)
            depth = torch.where(ok, depth, -1.0)  # unmatched rows spawn no depth points
            if cfg.th_far_points > 0:
                far = depth > cfg.th_far_points
                depth = torch.where(far, -1.0, depth)
                ur = None if ur is None else torch.where(far, -1.0, ur)
            feats, depth, ur = fetch((feats, depth, ur))
        return self.track_features(Features(feats.uv, feats.desc.view(np.uint32), *feats[2:]),
                                   ts, depth=depth, ur=ur, imu_samples=imu_samples)

    def track_rgbd(self, image, depth_map, ts: float, imu_samples=None):
        """System::TrackRGBD (src/System.cc:349): the depth at each keypoint
        (times depth_scale, beyond th_far_points dropped) and, with bf > 0,
        the virtual right uR = u - bf/z (ComputeStereoFromRGBD,
        src/Frame.cc:984). imu_samples: the RGB-D-inertial sensor's samples
        since the previous frame."""
        cfg = self.cfg
        with self.timing.measure("extract"):
            feats = self._post_extract(Features(*(f[0] for f in self._extract(image))))
        with self.timing.measure("depth_lookup"):
            d = depth_from_depthmap(feats.uv, upload(np.asarray(depth_map, np.float32),
                                                     self.device), cfg.depth_scale)
            if cfg.th_far_points > 0:
                d = torch.where(d > cfg.th_far_points, -1.0, d)
            ur = virtual_right(feats.uv, d, cfg.bf) if cfg.bf > 0 else None
            feats, d, ur = fetch((feats, d, ur))
        return self.track_features(Features(feats.uv, feats.desc.view(np.uint32), *feats[2:]),
                                   ts, depth=d, ur=ur, imu_samples=imu_samples)

    def track_features(self, feats: Features, ts: float, depth=None, ur=None, imu_samples=None):
        """Feature-level entry: host Features (numpy, uint32 descriptors);
        depth / ur (F,) for stereo and RGB-D frames, imu_samples for the
        inertial sensors (see Tracker.track)."""
        with self.timing.measure("track"):
            T = self.tracker.track(feats, ts, depth=depth, ur=ur, imu_samples=imu_samples)
        self._handle_loss()
        self.poses.append((ts, T))
        return T

    def _on_keyframe(self, k: int):
        with self.timing.measure("local_mapping"):
            self.mapper.on_keyframe(k)
        if self.closer is not None:
            with self.timing.measure("loop_closing"):
                self.closer.on_keyframe(k)

    def make_chunked_frontend(self, chunk: int = 16, lag: int = 1, async_mapping: bool = True,
                              stereo: bool = False, rgbd: bool = False):
        """Chunk-pipelined image frontend (tracking/chunked.py): one device
        step extracts and tracks `chunk` frames, and local mapping, then loop
        closing, move to a worker thread (the reference's tracking,
        local-mapping and loop-closing threads, src/System.cc:197,214; here
        the closer runs after each keyframe's mapping on the same worker,
        its global BA inline). Feed it track_image(img, ts) (stereo: with
        img_right=; RGB-D: with depth_img=; the inertial sensors: with
        imu_samples=) and read the retired (frame_id, ts, T_cw | None)
        triples; call flush() at the end of the sequence, then shutdown().
        With the async mapper the inertial sensors' staged IMU init runs on
        the worker after each keyframe's mapping (InitializeIMU on the
        LocalMapping thread, src/LocalMapping.cc:200-230), and the frontend
        applies each similarity it commits; with async_mapping=False it runs
        inside keyframe creation."""
        from ..tracking.chunked import ChunkedTracker

        lock = None
        if async_mapping:
            from ..mapping.async_mapper import AsyncLocalMapper

            am = AsyncLocalMapper(
                self.mapper, post_fn=self.closer.on_keyframe if self.closer is not None else None)
            self.async_mapper = am
            self.tracker.on_keyframe = am.on_keyframe
            self.tracker.mapper_busy_fn = am.busy
            lock = am.lock
            imu = self.tracker.imu
            if imu is not None:
                imu.async_init = True
                imu.map_lock = am.lock
                # the reference also hands the init an abort_gba_fn that stops
                # a stale global BA thread before it realigns the map; the
                # port's closer runs global BA inline on this same worker, so
                # none can be in flight when the init commits
                am.init_fn = lambda: imu.run_pending_init(self.map, self.tracker)
        ct = ChunkedTracker(self.tracker, self.ecfg, chunk=chunk, lag=lag, map_lock=lock,
                            stereo=stereo, min_z=self.cfg.min_depth, rgbd=rgbd,
                            depth_scale=self.cfg.depth_scale, th_far=self.cfg.th_far_points)
        # the worker maps one retire's keyframes while the next chunk is
        # dispatched; the next retire waits for it (tracking/chunked.py)
        ct.async_mapper = self.async_mapper
        ct.loss_fn = self._handle_loss
        return ct

    def _handle_loss(self):
        """Multi-map recovery: on LOST, keep the map and start a new one, or
        reset a map of <= min_kfs_for_new_map keyframes
        (src/Tracking.cc:2020-2026). A bad IMU (too little motion before
        VIBA2 for the inertial init, mbBadImu, src/LocalMapping.cc:138-147)
        resets the active map."""
        t = self.tracker
        if t.imu is not None and t.imu.bad_imu:
            self.reset_active_map()
            return
        if t.state != LOST:
            return
        if self._localization_only:
            # frozen map: stay RECENTLY_LOST and keep trying against it
            t.state = RECENTLY_LOST
            t.lost_frames = 0
            return
        if t.imu is not None:
            t.imu._epoch += 1  # an in-flight asynchronous init solve belongs to the old map
        if self.map.n_keyframes() > self.cfg.min_kfs_for_new_map:
            self.map.create_new_map()
        else:
            self._clear_map(all_maps=False)
        t.state = NOT_INITIALIZED
        t.init_frame = None
        t.last = None
        t.velocity = None
        t.ref_kf = -1
        t.lost_frames = 0

    # ------------------------------------------------------------ trajectory
    # The files equal the reference's byte for byte for the same poses: the
    # quaternions come from lie/so3.py::quat_from_mat_np (float32, bit for
    # bit the reference's), and the formats are the reference's.
    @staticmethod
    def _tum_line(ts, T_wc):
        q = so3.quat_from_mat_np(T_wc[:3, :3])
        t = T_wc[:3, 3]
        return (f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}")

    @staticmethod
    def _write_lines(path: str, lines):
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")

    def _keyframes_by_time(self):
        m = self.map
        kfs = m.keyframe_indices(all_maps=True)
        return kfs[np.argsort(m.kf_ts[kfs])]

    def save_trajectory_tum(self, path: str):
        """TUM format: ts tx ty tz qx qy qz qw (System::SaveTrajectoryTUM,
        src/System.cc:609)."""
        self._write_lines(path, [self._tum_line(ts, np.linalg.inv(T))
                                 for ts, _, T in self.tracker.absolute_trajectory()])

    def save_keyframe_trajectory_tum(self, path: str):
        m = self.map
        lines = []
        for k in self._keyframes_by_time():
            T_wc = np.eye(4)
            T_wc[:3, :3] = m.kf_R[k].T
            T_wc[:3, 3] = -m.kf_R[k].T @ m.kf_t[k]
            lines.append(self._tum_line(m.kf_ts[k], T_wc))
        self._write_lines(path, lines)

    def _T_bc(self):
        """(4, 4) camera -> body of the inertial sensors, else None."""
        imu = self.tracker.imu
        if imu is None:
            return None
        T = np.eye(4)
        T[:3, :3] = np.asarray(imu.cfg.R_bc, np.float64)
        T[:3, 3] = np.asarray(imu.cfg.t_bc, np.float64)
        return T

    @staticmethod
    def _euroc_line(ts, T_xw):
        """ts_ns tx ty tz qw qx qy qz of the pose T_xw (world -> camera or body)."""
        T_wx = np.linalg.inv(T_xw)
        q = so3.quat_from_mat_np(T_wx[:3, :3])
        t = T_wx[:3, 3]
        return (f"{int(round(ts * 1e9))} {t[0]:.9f} {t[1]:.9f} {t[2]:.9f} "
                f"{q[0]:.9f} {q[1]:.9f} {q[2]:.9f} {q[3]:.9f}")

    def save_trajectory_euroc(self, path: str):
        """EuRoC format: ts_ns tx ty tz qw qx qy qz. The visual sensors
        write camera-to-world, the inertial ones body-to-world through T_bc
        (System::SaveTrajectoryEuRoC writes Twb = (Tbc * Tcw)^-1 with an
        IMU, src/System.cc:799-801)."""
        T_bc = self._T_bc()
        self._write_lines(path, [self._euroc_line(ts, T if T_bc is None else T_bc @ T)
                                 for ts, _, T in self.tracker.absolute_trajectory()])

    def save_keyframe_trajectory_euroc(self, path: str):
        """The keyframes in EuRoC format; body frame for the inertial sensors
        (System::SaveKeyFrameTrajectoryEuRoC, src/System.cc:830 region)."""
        m = self.map
        T_bc = self._T_bc()
        lines = []
        for k in self._keyframes_by_time():
            T = np.eye(4)
            T[:3, :3] = m.kf_R[k]
            T[:3, 3] = m.kf_t[k]
            lines.append(self._euroc_line(m.kf_ts[k], T if T_bc is None else T_bc @ T))
        self._write_lines(path, lines)

    def save_trajectory_kitti(self, path: str):
        """KITTI format: the row-major 3x4 T_wc, 12 numbers a line
        (System::SaveTrajectoryKITTI, src/System.cc:609-700 region)."""
        self._write_lines(path, [" ".join(f"{x:.9e}" for x in np.linalg.inv(T)[:3].reshape(-1))
                                 for _, _, T in self.tracker.absolute_trajectory()])

    def save_debug_data(self, path: str) -> int:
        """The IMU init's trace (System::SaveDebugData, src/System.cc:1305
        region): one JSON line per staged-init / refinement event with its
        kind, stage, solved scale, gravity rotation (9 numbers), solve wall
        time, sequence time and whether it was applied. Returns the count."""
        import json

        imu = self.tracker.imu
        events = imu.init_log if imu is not None else []
        with open(path, "w") as f:
            for e in events:
                row = dict(e)
                row["R_wg"] = np.asarray(row["R_wg"]).reshape(-1).tolist()
                f.write(json.dumps(row) + "\n")
        return len(events)

    def shutdown(self):
        """System::Shutdown (src/System.cc:555): drain and stop the mapper."""
        if self.async_mapper is not None:
            self.async_mapper.flush()
            self.async_mapper.shutdown()
        return self.timing.summary()
