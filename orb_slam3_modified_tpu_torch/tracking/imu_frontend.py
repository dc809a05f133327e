"""Visual-inertial tracking state: preintegration buffers and the staged
IMU init.

Port of orb_slam3_modified_tpu/tracking/imu_frontend.py (the IMU plumbing of
the reference's Tracking and LocalMapping threads: PreintegrateIMU
src/Tracking.cc:1627, PredictStateIMU :1741, UpdateFrameIMU :3983;
LocalMapping::InitializeIMU :1173 with priors 1e2 / 1e10, VIBA1 after 5 s
and VIBA2 after 15 s :207-230, ScaleRefinement :1429). The frontend owns the
body state (velocity, biases), the per-frame and per-keyframe
preintegrations, and the staged init over the keyframe chain; camera <-> body
extrinsics follow the reference's T_bc convention (x_b = R_bc x_c + t_bc).

Where things live: a frame gap is integrated on `device`
(imu/preintegration.py) and stays there for the prediction and the
per-frame VI solve; at a keyframe the accumulated interval is read back
once and the chain keeps host (CPU tensor) intervals, which the init and
the VI BAs stack into their problems. The reference pads a frame gap to
IMU_BATCH = 64 samples with a mask; padded samples leave the state
untouched, so this integrates the real samples only.

The staged init runs synchronously inside the tracker's keyframe path by
default (the per-frame entry points). The asynchronous mode
(run_pending_init, _bg_full_vi_ba: snapshot under map_lock, solve
unlocked, commit under the lock unless a reset or loss bumped the epoch
meanwhile, the applied similarity logged in align_log) is the one the
chunked frontend uses (tracking/chunked.py).
"""
from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from .. import resolve_device
from ..imu.preintegration import ImuBias, Preintegrated, integrate, merge, predict_state
from ..lie.se3 import SE3np
from ..optim.inertial import InertialChain, inertial_only_optimization
from ..utils.fetch import fetch, upload
from ..utils.timing import TimeStats

log = logging.getLogger(__name__)

# the per-stage bias priors (gyro, acc) of the init's full VI BA: InitializeIMU
# 1e2 / 1e10, VIBA1 1 / 1e5, VIBA2 0 / 0 (src/LocalMapping.cc:207-230, :1280)
_VIBA_PRIORS = {1: (1e2, 1e10), 2: (1.0, 1e5), 3: (0.0, 0.0)}


@dataclasses.dataclass
class ImuConfig:
    noise_gyro: float = 1.7e-4
    noise_acc: float = 2.0e-3
    walk_gyro: float = 1.9e-5
    walk_acc: float = 3.0e-3
    freq: float = 200.0
    R_bc: np.ndarray = None  # camera-to-body rotation (None: identity)
    t_bc: np.ndarray = None
    init_time: float = 2.0  # seconds of keyframes before the first init
    viba1_time: float = 5.0
    viba2_time: float = 15.0
    # monocular maps have a free scale; stereo / RGB-D-inertial maps are
    # metric, so their init must not rescale them (InitializeIMU's
    # bMonocular -> FixedScale, src/LocalMapping.cc:1173)
    mono: bool = True


def to_host(pre: Preintegrated) -> Preintegrated:
    """A Preintegrated as CPU tensors, with one readback."""
    h = fetch(pre)
    t = torch.from_numpy
    return Preintegrated(*(t(a) for a in h[:10]), ImuBias(*(t(a) for a in h.bias)),
                         *(t(a) for a in h[11:]))


def _bias_np(bias: ImuBias):
    return tuple(np.asarray(x, np.float32) for x in fetch(tuple(bias)))


class ImuFrontend:
    def __init__(self, cfg: ImuConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        if cfg.R_bc is None:
            cfg.R_bc = np.eye(3, dtype=np.float32)
        if cfg.t_bc is None:
            cfg.t_bc = np.zeros(3, np.float32)
        self.bias = ImuBias.zero(self.device)
        self.v_w = np.zeros(3, np.float32)  # body velocity in world
        self.initialized = False
        self.stage = 0  # 0 none, 1 init done, 2 VIBA1, 3 VIBA2
        self.preint_frame: Preintegrated | None = None  # since the last frame (device)
        self.preint_kf: Preintegrated | None = None  # since the last keyframe (device)
        # 15-D marginalization prior on the last frame's state (the prior
        # Marginalize builds after each PoseInertialOptimizationLastFrame),
        # anchored at the last solved body state and the current bias
        self.marg_prior: np.ndarray | None = None  # (15, 15)
        self._marg_pending: np.ndarray | None = None
        # keyframe-anchored prior (PoseInertialOptimizationLastKeyFrame,
        # src/Optimizer.cc:4491): the frame that became the keyframe carries
        # its solved 15-D posterior information, and the next frame anchors
        # on the keyframe's map state with it. (kf_idx, kf_frame_id, H)
        self.kf_prior: tuple | None = None
        self.kf_chain: list = []  # [(kf_idx, kf_frame_id, host Preintegrated from the prev kf)]
        self.first_kf_ts: float | None = None
        self.R_gw = np.eye(3, dtype=np.float32)
        # bad IMU (src/LocalMapping.cc:138-147): if the rig barely moves
        # before VIBA2 the init is unobservable and the active map is reset;
        # t_motion accumulates only while the rig moves (mTinit)
        self.bad_imu = False
        self.t_motion = 0.0
        # bumped whenever a solver re-estimates self.bias
        self.bias_epoch = 0
        # asynchronous staged init (the chunked frontend's mode)
        self.async_init = False
        self.map_lock = None
        self.abort_gba_fn = None  # stop a stale global BA before realigning
        self.align_log: list = []  # every applied world similarity (A = R_wg^T, s)
        self.last_alignment = None
        self._epoch = 0  # bumped on reset / loss: in-flight solves abort
        # periodic monocular scale refinement (LocalMapping::Run re-runs
        # ScaleRefinement as mTinit crosses 25 ... 75 s, src/LocalMapping.cc:232-244)
        self.refine_schedule = (25.0, 35.0, 45.0, 55.0, 65.0, 75.0)
        self.refine_idx = 0
        # staged-init events (System::SaveDebugData's traces)
        self.init_log: list = []
        # wall time of the init solves and the full VI BAs, by stage
        self.stats = TimeStats()
        self._pred_v = None

    # ----------------------------------------------------------- per frame
    def integrate_frame(self, acc, gyro, dts):
        """Preintegrate this frame's samples on the device."""
        n = len(dts)
        pre = integrate(
            upload(np.asarray(acc, np.float32).reshape(n, 3), self.device),
            upload(np.asarray(gyro, np.float32).reshape(n, 3), self.device),
            upload(np.asarray(dts, np.float32), self.device),
            torch.ones(n, dtype=torch.bool, device=self.device), self.bias,
            self.cfg.noise_gyro, self.cfg.noise_acc, self.cfg.walk_gyro, self.cfg.walk_acc,
            self.cfg.freq,
        )
        self.preint_frame = pre
        self.preint_kf = pre if self.preint_kf is None else merge(self.preint_kf, pre)
        return pre

    def _up(self, a):
        return upload(np.asarray(a, np.float32), self.device)

    def predict_pose(self, T_cw_last: SE3np):
        """IMU dead reckoning of the next camera pose (PredictStateIMU):
        T_bw = T_bc T_cw, the body state carried across the frame gap, then
        T_cw' = T_bc^-1 T_bw'."""
        if self.preint_frame is None:
            return None
        R_bc = self.cfg.R_bc.astype(np.float32)
        t_bc = self.cfg.t_bc.astype(np.float32)
        R_bw = R_bc @ T_cw_last.R
        t_bw = R_bc @ T_cw_last.t + t_bc
        R_new, v_new, p_new = fetch(predict_state(
            self._up(R_bw.T), self._up(self.v_w), self._up(-R_bw.T @ t_bw), self.preint_frame,
            self.bias))
        self._pred_v = v_new
        R_bw_new = R_new.T
        t_bw_new = -R_bw_new @ p_new
        return SE3np((R_bc.T @ R_bw_new).astype(np.float32),
                     (R_bc.T @ (t_bw_new - t_bc)).astype(np.float32))

    def commit_frame_velocity(self, T_cw_prev: SE3np, T_cw_cur: SE3np, dt: float):
        """The velocity after a frame: the VI solve's (or the prediction's)
        once initialized, else the finite difference of the camera centres.
        Also commits the marginal prior this frame's solve produced."""
        if dt <= 0:
            return
        self.marg_prior = self._marg_pending
        self._marg_pending = None
        if self.initialized and self._pred_v is not None:
            self.v_w = self._pred_v
        else:
            c_prev = T_cw_prev.inverse().t
            c_cur = T_cw_cur.inverse().t
            self.v_w = ((c_cur - c_prev) / dt).astype(np.float32)

    # -------------------------------------------------------- per keyframe
    def on_keyframe(self, kf_idx: int, ts: float, slam_map):
        # the frame becoming this keyframe carries its own solved posterior:
        # the keyframe-anchored prior of the next frame's solve (its state is
        # read from the map at solve time, so the mapper's VI refinement of
        # the keyframe is absorbed)
        H_kf = self._marg_pending if self._marg_pending is not None else self.marg_prior
        if H_kf is not None:
            self.kf_prior = (int(kf_idx), int(slam_map.kf_frame_id[kf_idx]), H_kf)
        # keyframe processing moves the map the frame-to-frame prior was
        # linearized against: drop it
        self.marg_prior = None
        self._marg_pending = None
        if self.first_kf_ts is None:
            self.first_kf_ts = ts
        if self.preint_kf is not None:
            self.kf_chain.append((kf_idx, int(slam_map.kf_frame_id[kf_idx]),
                                  to_host(self.preint_kf)))
        self.preint_kf = None
        slam_map.kf_vel[kf_idx] = self.v_w
        # bad-IMU gate over the last three keyframes (src/LocalMapping.cc:138-147)
        if len(self.kf_chain) >= 3 and self.stage < 3:
            ks = [c[0] for c in self.kf_chain[-3:]]
            if all(slam_map.kf_valid[x] for x in ks):
                cs = [-slam_map.kf_R[x].T @ slam_map.kf_t[x] for x in ks]
                dist = float(np.linalg.norm(cs[2] - cs[1]) + np.linalg.norm(cs[1] - cs[0]))
                dt_kf = float(slam_map.kf_ts[ks[2]] - slam_map.kf_ts[ks[1]])
                if dist > 0.05:
                    self.t_motion += max(dt_kf, 0.0)
                elif self.initialized and self.t_motion < 10.0 and dist < 0.02:
                    self.bad_imu = True

    def on_initial_keyframes(self, k0: int, k1: int, ts0: float, ts1: float, slam_map):
        """Register the monocular-init keyframe pair: the accumulated
        interval covers exactly the k0 -> k1 gap."""
        self.first_kf_ts = ts0
        self.kf_chain = [(k0, int(slam_map.kf_frame_id[k0]),
                          Preintegrated.identity(ImuBias(*(torch.from_numpy(b) for b in
                                                           _bias_np(self.bias)))))]
        if self.preint_kf is not None:
            self.kf_chain.append((k1, int(slam_map.kf_frame_id[k1]), to_host(self.preint_kf)))
        self.preint_kf = None
        slam_map.kf_vel[k0] = self.v_w
        slam_map.kf_vel[k1] = self.v_w

    def valid_chain(self, slam_map):
        """The surviving keyframe chain with the intervals MERGED across
        culled keyframes; a slot counts only while its frame id still
        matches (slots are reused). Returns (kfs, pres), len(pres) ==
        len(kfs), pres[0] a placeholder."""
        kfs = [k for k, _, _ in self.kf_chain]
        fids = [f for _, f, _ in self.kf_chain]
        pres = [p for _, _, p in self.kf_chain]
        keep = [i for i, (k, f) in enumerate(zip(kfs, fids))
                if slam_map.kf_valid[k] and int(slam_map.kf_frame_id[k]) == f]
        if not keep:
            return [], []
        kfs2, pres2 = [kfs[keep[0]]], [pres[keep[0]]]
        for prev, cur in zip(keep[:-1], keep[1:]):
            p = pres[prev + 1]
            for j in range(prev + 2, cur + 1):
                p = merge(p, pres[j])
            kfs2.append(kfs[cur])
            pres2.append(p)
        return kfs2, pres2

    def _init_due(self, slam_map):
        """None, "init" (stages 1-3) or "refine" (the periodic monocular
        scale refinement). The chain needs nMinKF = 10 keyframes first
        (InitializeIMU, src/LocalMapping.cc:1187 region)."""
        if self.first_kf_ts is None or len(self.kf_chain) < 10:
            return None
        elapsed = slam_map.kf_ts[self.kf_chain[-1][0]] - self.first_kf_ts
        if self.stage < 3:
            due = (self.cfg.init_time, self.cfg.viba1_time, self.cfg.viba2_time)[self.stage]
            return "init" if elapsed >= due else None
        if not self.cfg.mono or self.refine_idx >= len(self.refine_schedule):
            return None
        return "refine" if elapsed >= self.refine_schedule[self.refine_idx] else None

    def maybe_initialize(self, slam_map, tracker) -> bool:
        """The staged init on the keyframe chain, solved inline (the
        synchronous mode); a no-op in the asynchronous mode, whose worker
        calls run_pending_init instead."""
        if self.async_init:
            return False
        due = self._init_due(slam_map)
        if due is None:
            return False
        snap = self._snapshot_chain(slam_map)
        if snap is None:
            return False
        t0 = time.perf_counter()
        with self.stats.measure(f"init_solve_{due}_stage{self.stage}"):
            res = self._solve_inertial(snap, due)
        ok = self._commit_init(slam_map, tracker, due, snap, res, time.perf_counter() - t0)
        if ok and due == "init":
            # joint full VI BA over the chain (InitializeIMU's FullInertialBA
            # after ApplyScaledRotation, src/LocalMapping.cc:1280-1300; VIBA1 /
            # VIBA2 re-run it with weaker priors); the newest keyframe anchors
            # the gauge, so the tracker's current pose stays consistent
            self._full_vi_ba(slam_map, tracker, snap[0], snap[1][1:])
        return ok

    def run_pending_init(self, slam_map, tracker):
        """The asynchronous staged init, on the mapper worker after a
        keyframe: snapshot under the map lock, solve unlocked, commit under
        the lock unless the epoch moved on meanwhile."""
        lock = self.map_lock
        epoch = self._epoch
        with lock:
            if epoch != self._epoch:
                return False
            due = self._init_due(slam_map)
            if due is None:
                return False
            snap = self._snapshot_chain(slam_map)
        if snap is None:
            return False
        t0 = time.perf_counter()
        res = self._solve_inertial(snap, due)
        # a stale global BA would write pre-alignment poses over the
        # realigned map: stop it first, without the lock
        if self.abort_gba_fn is not None:
            self.abort_gba_fn()
        with lock:
            if epoch != self._epoch:
                return False
            ok = self._commit_init(slam_map, tracker, due, snap, res, time.perf_counter() - t0)
        if ok and due == "init":
            self._bg_full_vi_ba(slam_map, tracker, epoch)
        return ok

    def _snapshot_chain(self, slam_map):
        """(kfs, pres, R_wb, p_wb) of the surviving chain, or None."""
        kfs2, pres2 = self.valid_chain(slam_map)
        if len(kfs2) < 6:
            return None
        R_bc, t_bc = self.cfg.R_bc, self.cfg.t_bc
        R_wb, p_wb = [], []
        for k in kfs2:
            R_bw = R_bc @ slam_map.kf_R[k]
            t_bw = R_bc @ slam_map.kf_t[k] + t_bc
            R_wb.append(R_bw.T)
            p_wb.append(-R_bw.T @ t_bw)
        return (kfs2, pres2, np.stack(R_wb).astype(np.float32),
                np.stack(p_wb).astype(np.float32))

    def _solve_inertial(self, snap, kind):
        """The inertial-only MAP on the chain, padded to a power-of-two
        keyframe bucket (at least 8; padded edges: identity intervals with
        valid False, padded states copies of the last row), 80 damped
        Gauss-Newton iterations. Returns the result as numpy arrays."""
        kfs2, pres2, R_wb, p_wb = snap
        K0 = len(kfs2)
        Kb = 8
        while Kb < K0:
            Kb *= 2
        pres = list(pres2[1:])
        if Kb > K0:
            bias_host = ImuBias(*(torch.from_numpy(b) for b in _bias_np(self.bias)))
            pres = pres + [Preintegrated.identity(bias_host)] * (Kb - K0)
            R_wb = np.concatenate([R_wb, np.tile(R_wb[-1:], (Kb - K0, 1, 1))])
            p_wb = np.concatenate([p_wb, np.tile(p_wb[-1:], (Kb - K0, 1))])
        chain = InertialChain.from_preintegrated(pres, device=self.device)
        if Kb > K0:
            chain = chain._replace(valid=torch.arange(Kb - 1, device=self.device) < K0 - 1)
        # the scale is solved once for MONOCULAR maps and again by each
        # refinement; VIBA1 / VIBA2 and the metric stereo / RGB-D maps keep it
        fix_scale = (self.stage >= 1 or not self.cfg.mono) and kind != "refine"
        res = inertial_only_optimization(
            chain, self._up(R_wb), self._up(p_wb),
            torch.zeros((Kb, 3), dtype=torch.float32, device=self.device), fix_scale, 80)
        return fetch(res)

    def _commit_init(self, slam_map, tracker, kind, snap, res, t_solve) -> bool:
        """Check and apply one staged-init solve (the asynchronous mode holds
        the map lock)."""
        kfs2 = snap[0]
        scale = float(res.scale)
        fix_scale = (self.stage >= 1 or not self.cfg.mono) and kind != "refine"
        # sanity gates (InitializeIMU rejects scale < 1e-1 for mono,
        # src/LocalMapping.cc:1260 region); a gyro bias beyond ~0.1 rad/s is
        # unphysical for consumer IMUs
        if not np.isfinite(scale) or scale <= 1e-2 or scale > 1e3:
            return False
        if float(np.linalg.norm(res.bg)) > 0.1:
            return False
        R_wg = np.asarray(res.R_wg)
        if fix_scale:
            scale = 1.0
        tilt = float(np.arccos(np.clip((np.trace(R_wg) - 1) / 2, -1.0, 1.0)))
        self.init_log.append({"kind": kind, "stage": self.stage, "scale": scale,
                              "R_wg": R_wg.copy(), "t_solve": t_solve,
                              "ts": float(slam_map.kf_ts[kfs2[-1]])})
        if kind == "refine":
            self.refine_idx += 1
            # applied only when meaningfully different (|mScale - 1| > 0.002,
            # src/LocalMapping.cc:1451 region)
            if abs(scale - 1.0) <= 0.002 and tilt <= 2e-3:
                self.init_log[-1]["applied"] = False
                return False
        self.init_log[-1]["applied"] = True
        log.info("staged-init commit: kind=%s stage=%d scale=%.4f tilt=%.4f t_solve=%.2fs K=%d",
                 kind, self.stage, scale, tilt, t_solve, len(kfs2))
        # gravity alignment and scale of the whole map (Map::ApplyScaledRotation)
        _apply_scaled_rotation(slam_map, R_wg.T, scale)
        # world' : R_cw' = R_cw A^T, t' = s t, v' = s A v, A = R_wg^T
        A = R_wg.T.astype(np.float32)
        self.last_alignment = (A, float(scale))
        self.align_log.append((A, float(scale)))
        if kind == "init":
            # velocities come out in the pre-alignment frame at true scale:
            # rotate them and write back the surviving chain states
            v_new = np.asarray(res.v_w) @ R_wg
            for i, k in enumerate(kfs2):
                if not slam_map.kf_valid[k]:
                    continue
                slam_map.kf_vel[k] = v_new[i]
                slam_map.kf_bias[k, :3] = res.bg
                slam_map.kf_bias[k, 3:] = res.ba
            if self.stage == 0 or not self.initialized:
                self.v_w = v_new[len(kfs2) - 1].astype(np.float32)  # padded rows beyond
            else:
                # the live velocity has moved past the snapshot (asynchronous)
                self.v_w = (scale * (A @ self.v_w)).astype(np.float32)
            self.bias = ImuBias(self._up(res.bg), self._up(res.ba))
            self.bias_epoch += 1
            self.initialized = True
            self.stage += 1
            slam_map.imu_initialized = True
            slam_map.n_inertial_ba = self.stage
        else:
            self.v_w = (scale * (A @ self.v_w)).astype(np.float32)
        self.marg_prior = None  # the world frame and the bias changed under the prior
        self._marg_pending = None
        self.kf_prior = None  # its tangent frame rotated with the world
        # the tracker's pose state follows the map transform
        if tracker is not None and tracker.last is not None:
            T = tracker.last.T_cw
            tracker.last.T_cw = SE3np((T.R @ R_wg).astype(np.float32),
                                      (T.t * scale).astype(np.float32))
            tracker.velocity = None
        return True

    def _vi_ba_problem(self, slam_map, tracker, kfs, pres):
        from ..optim.vi_ba import build_vi_problem

        prior_g, prior_a = _VIBA_PRIORS.get(self.stage, (0.0, 0.0))
        fixed = np.zeros(len(kfs), bool)
        fixed[-1] = True  # gauge on the newest keyframe (tracker-consistent)
        return build_vi_problem(slam_map, tracker.cfg, kfs, pres, fixed, prior_g, prior_a,
                                self.cfg, obs_bucket=16384,
                                state_fixed=np.zeros(len(kfs), bool))

    def _full_vi_ba(self, slam_map, tracker, kfs, pres):
        """FullInertialBA over the chain after an init stage (poses,
        velocities, per-keyframe biases, points), 2 rounds x 10 iterations."""
        from ..optim.vi_ba import to_device, vi_bundle_adjust, write_back_vi

        if tracker is None:
            return
        with self.stats.measure(f"full_vi_ba_stage{self.stage}"):
            prob, kfs_np, mp_sel = self._vi_ba_problem(slam_map, tracker, kfs, pres)
            res = fetch(vi_bundle_adjust(to_device(prob, self.device), tracker.cam, 2, 10))
            write_back_vi(slam_map, res, kfs_np, mp_sel)
        K0 = len(kfs)
        self.v_w = res.v_w[K0 - 1].astype(np.float32)
        self.bias = ImuBias(self._up(res.bg[K0 - 1]), self._up(res.ba[K0 - 1]))
        self.bias_epoch += 1

    def _bg_full_vi_ba(self, slam_map, tracker, epoch):
        """The asynchronous FullInertialBA: snapshot under the lock, solve
        unlocked, commit with the propagation to keyframes created
        meanwhile (slam_map/commit.py)."""
        from ..optim.vi_ba import to_device, vi_bundle_adjust
        from ..slam_map.commit import commit_whole_map_solve

        lock = self.map_lock
        with lock:
            if epoch != self._epoch:
                return
            kfs2, pres2 = self.valid_chain(slam_map)
            if len(kfs2) < 6:
                return
            kfs = np.asarray(kfs2)
            kfs_fid = slam_map.kf_frame_id[kfs].copy()
            prob, _, mp_sel = self._vi_ba_problem(slam_map, tracker, kfs2, pres2[1:])
            pre_R = slam_map.kf_R[kfs].copy()
            pre_t = slam_map.kf_t[kfs].copy()
        res = fetch(vi_bundle_adjust(to_device(prob, self.device), tracker.cam, 2, 10))
        K0 = len(kfs2)
        with lock:
            if epoch != self._epoch:
                return
            alive = slam_map.kf_valid[kfs] & (slam_map.kf_frame_id[kfs] == kfs_fid)
            slam_map.kf_vel[kfs[alive]] = res.v_w[:K0][alive]
            slam_map.kf_bias[kfs[alive], :3] = res.bg[:K0][alive]
            slam_map.kf_bias[kfs[alive], 3:] = res.ba[:K0][alive]
            commit_whole_map_solve(slam_map, kfs, kfs_fid, np.asarray(mp_sel),
                                   res.T_cw.R[:K0], res.T_cw.t[:K0], res.points[:len(mp_sel)],
                                   pre_R, pre_t)
            # the bias varies slowly: adopt the newest solved one; the live
            # velocity and pose have moved on and stay with the frontend
            if alive[-1]:
                self.bias = ImuBias(self._up(res.bg[K0 - 1]), self._up(res.ba[K0 - 1]))
                self.bias_epoch += 1


def _apply_scaled_rotation(m, R_gw: np.ndarray, s: float):
    """world' = s R_gw world: gravity to -z and the monocular scale fixed,
    for every keyframe pose, velocity and point of every map
    (Map::ApplyScaledRotation). With x_c = R_cw w + t_cw and
    w = R_gw^T w' / s: T_cw' = SE3(R_cw R_gw^T, s t_cw)."""
    kfs = m.keyframe_indices(all_maps=True)
    m.kf_R[kfs] = np.einsum("kij,lj->kil", m.kf_R[kfs], R_gw)
    m.kf_t[kfs] = (s * m.kf_t[kfs]).astype(np.float32)
    m.kf_vel[kfs] = (s * m.kf_vel[kfs] @ R_gw.T).astype(np.float32)
    mps = m.point_indices(all_maps=True)
    m.mp_pos[mps] = (s * m.mp_pos[mps] @ R_gw.T).astype(np.float32)
