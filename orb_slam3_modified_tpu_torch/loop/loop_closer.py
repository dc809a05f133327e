"""Loop detection and correction, and the merge of a map into another.

Port of orb_slam3_modified_tpu/loop/loop_closer.py (LoopClosing,
src/LoopClosing.cc: NewDetectCommonRegions :324, DetectCommonRegionsFromBoW
:578, CorrectLoop :969, MergeLocal :1215, RunGlobalBundleAdjustment :2268).
Per keyframe:
1. BoW query for the top-3 candidates outside the covisible neighbourhood;
2. geometric verification: the two keyframes' observed points matched by
   descriptor (features/matcher.py::mutual_best_match at (F, F), on the card
   the fused entry of csrc/hamming.cu), Horn Sim3 RANSAC, then the
   bidirectional reprojection refinement (loop/sim3_solver.py);
3. temporal consistency: the hypothesis must survive `consistency_needed`
   consecutive keyframes (mnLoopNumCoincidences >= 3);
4. correction: a Sim3 essential graph (temporal, strong covisibility and
   loop edges; optim/pose_graph.py), points moved with their reference
   keyframe, the matched points welded, then a global BA. A candidate in
   another map merges the active map into it instead.

Host orchestration over the numpy map; every match, RANSAC, pose graph and
BA solve runs on `device` from uploaded inputs, and its result is read back
before it is committed.

Where the reference runs the post-loop global BA on a transient thread with
an abort flag, the port runs it inline: the closer's on_keyframe runs on the
mapper worker right after that keyframe's local mapping
(mapping/async_mapper.py), so the tracker's next retire, which waits for the
worker, sees the corrected map, and the result depends on the frames alone.

Inertial maps (the system sets `imu`, `vi_refine_fn` and fix_scale for the
inertial sensors): the Sim3 is scale-fixed and must not tilt gravity, an
initialized map corrects with translation and yaw only, the merge's weld is
refined by the joint VI window BA (MergeInertialBA), and the global BA is
the joint VI BA over the inertial chain (FullInertialBA).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..bow.kfdb import KeyFrameDatabase
from ..bow.vocabulary import Vocabulary
from ..cameras import Camera
from ..features.matcher import TH_LOW, mutual_best_match
from ..lie.sim3 import Sim3
from ..mapping.local_mapper import _pad_problem
from ..optim.ba import bundle_adjust, to_device
from ..optim.pose_graph import PoseGraphProblem, optimize_pose_graph
from ..slam_map.commit import commit_whole_map_solve
from ..slam_map.map_state import NO_POINT, MapState
from ..tracking.tracker import TrackerConfig, _build_ba_problem, _pad1, _write_back_ba
from ..utils.fetch import fetch, upload
from ..utils.timing import TimeStats
from .sim3_solver import optimize_sim3, solve_sim3_ransac

SIM3_CAP = 512  # point pairs per Sim3 problem (static shape)


@dataclasses.dataclass
class LoopCloserConfig:
    n_candidates: int = 3  # DetectNBestCandidates(,,3)
    min_matches: int = 20  # point pairs required before Sim3
    min_sim3_inliers: int = 20
    consistency_needed: int = 3  # consecutive-keyframe confirmations
    # map size before detection runs (the reference's 12 keyframes,
    # src/LoopClosing.cc:341-357, at this framework's stronger culling)
    min_map_kfs: int = 10
    # essential-graph strong-covisibility edges (minFeat = 100,
    # src/Optimizer.cc:1560 region)
    covis_weight_strong: int = 100
    gba_max_kfs: int = 200  # GBA only for maps below 200 keyframes
    fix_scale: bool = False  # the inertial sensors: the loop Sim3's scale is fixed


def _host_sim3(s, R, t) -> Sim3:
    """A Sim3 of float32 CPU tensors (the host's small similarity algebra)."""
    f = lambda a: torch.as_tensor(np.asarray(a, np.float32))  # noqa: E731
    return Sim3(f(s), f(R), f(t))


class LoopCloser:
    def __init__(self, cfg: LoopCloserConfig, tcfg: TrackerConfig, voc: Vocabulary,
                 slam_map: MapState, device="cuda"):
        self.cfg = cfg
        self.tcfg = tcfg
        self.voc = voc
        self.map = slam_map
        self.device = resolve_device(device)
        self.cam = Camera(tcfg.cam.kind, tcfg.cam.params.to(self.device), tcfg.cam.width,
                          tcfg.cam.height)
        self.kfdb = KeyFrameDatabase(voc, slam_map.kf_valid.shape[0])
        self.kf_words: dict[int, np.ndarray] = {}
        self.hypothesis: tuple | None = None  # (candidate keyframe, consecutive count)
        self.n_loops_closed = 0
        self.n_merges = 0
        self.n_queries = 0
        self.n_verifications = 0
        self.n_gba_runs = 0
        self.loops = []  # (current frame id, candidate frame id) of each closure / merge
        # one record per verification: the keyframe pair by frame id and the
        # counts each gate saw (None where an earlier gate stopped it)
        self.verify_log: list[dict] = []
        self.stats = TimeStats()  # per-stage wall time: words, query, verify, correct, merge, gba
        # frame id of the keyframe that last closed a loop: slots are reused,
        # so the cooldown compares frame ids (mnLastLoopKFid)
        self.last_loop_frame = -(10**9)
        # the inertial sensors: tracking/imu_frontend.py::ImuFrontend, and the
        # mapper's VI window BA (k) -> None for the weld after a merge
        self.imu = None
        self.vi_refine_fn = None
        slam_map.kf_removed_callbacks.append(self._on_kf_removed)

    def _on_kf_removed(self, k: int):
        """Keyframe slots are reused after culling: drop their cached state."""
        self.kf_words.pop(k, None)
        self.kfdb.erase(k)
        if self.hypothesis and self.hypothesis[0] == k:
            self.hypothesis = None

    # ------------------------------------------------------------------ API
    def on_keyframe(self, k: int) -> bool:
        """Process a new keyframe; True if a loop was corrected or maps merged."""
        m = self.map
        words = self._words_of(k)
        closed = False
        cur_fid = int(m.kf_frame_id[k])
        if m.n_keyframes() >= self.cfg.min_map_kfs and cur_fid - self.last_loop_frame > 20:
            cand = None
            if self.hypothesis is not None:
                # refine the standing hypothesis against the new keyframe before
                # a fresh query (DetectAndReffineSim3FromLastKF, src/LoopClosing.cc:535)
                hyp_kf = self.hypothesis[0]
                if m.kf_valid[hyp_kf]:
                    ver = self._verify(k, int(hyp_kf))
                    if ver is not None:
                        cand = (int(hyp_kf), *ver)
            if cand is None:
                cand = self._detect(k, words)
            if cand is not None:
                cand_kf, S_ck, n_pairs, mp_pairs = cand
                if self.hypothesis and self._near(self.hypothesis[0], cand_kf):
                    count = self.hypothesis[1] + 1
                else:
                    count = 1
                self.hypothesis = (cand_kf, count)
                if count >= self.cfg.consistency_needed:
                    self.loops.append((cur_fid, int(m.kf_frame_id[cand_kf])))
                    if m.kf_map[cand_kf] != m.kf_map[k]:
                        with self.stats.measure("merge"):
                            self._merge_maps(k, cand_kf, S_ck)
                        self.n_merges += 1
                    else:
                        with self.stats.measure("correct"):
                            self._correct_loop(k, cand_kf, S_ck, mp_pairs)
                        self.n_loops_closed += 1
                    self.hypothesis = None
                    self.last_loop_frame = cur_fid
                    closed = True
            else:
                self.hypothesis = None
        self.kfdb.add(k, words)
        return closed

    def _words_of(self, k: int):
        if k not in self.kf_words:
            with self.stats.measure("words"):
                m = self.map
                self.kf_words[k] = self.voc.transform_np(m.kf_desc[k][m.kf_feat_valid[k]])
        return self.kf_words[k]

    def _near(self, a: int, b: int) -> bool:
        """Same place for consecutive confirmations: equal or covisible."""
        return a == b or self.map.covisibility_weights(a)[b] > 0

    # ------------------------------------------------------------ detection
    def _detect(self, k: int, words):
        m = self.map
        # excluded: spConnectedKeyFrames, the weight >= 15 neighbours
        # (KeyFrame::GetConnectedKeyFrames); weaker links stay searchable
        exclude = {int(k)} | {int(x) for x in np.flatnonzero(m.covisibility_weights(k) >= 15)}
        with self.stats.measure("query"):
            self.n_queries += 1
            # covisibility groups only for the word-gated candidates
            cands = self.kfdb.query(
                words, exclude, self.cfg.n_candidates,
                lambda c: [int(x) for x in m.best_covisible(int(c), 10, min_weight=5)])
        for c in cands:
            ver = self._verify(k, int(c))
            if ver is not None:
                return (int(c), *ver)
        return None

    def _verify(self, k: int, c: int):
        """Geometric verification (DetectCommonRegionsFromBoW,
        src/LoopClosing.cc:578: SearchByBoW, Sim3Solver, then OptimizeSim3).
        Returns (S_ck, n_inliers, (current points, candidate points)) or
        None; S_ck (host Sim3) maps current-camera into candidate-camera
        coordinates."""
        m = self.map
        rec = {"kf": int(m.kf_frame_id[k]), "cand": int(m.kf_frame_id[c]), "matches": None,
               "ransac_inliers": None, "refined_inliers": None}
        self.verify_log.append(rec)
        with self.stats.measure("verify"):
            self.n_verifications += 1
            out = self._verify_inner(k, c, rec)
        rec["accepted"] = out is not None
        return out

    def _verify_inner(self, k: int, c: int, rec: dict):
        m = self.map
        dev = self.device
        cfg = self.cfg
        slots_k, mps_k = m.observations_of_kf(k)
        slots_c, mps_c = m.observations_of_kf(c)
        if len(mps_k) < cfg.min_matches or len(mps_c) < cfg.min_matches:
            return None
        F = m.kf_uv.shape[1]
        vk = np.zeros(F, bool)
        vk[: min(len(slots_k), F)] = True
        vc = np.zeros(F, bool)
        vc[: min(len(slots_c), F)] = True
        idx, ok, _ = mutual_best_match(
            upload(_pad1(m.kf_desc[k, slots_k], F).view(np.int32), dev), upload(vk, dev),
            upload(_pad1(m.kf_desc[c, slots_c], F).view(np.int32), dev), upload(vc, dev),
            max_dist=TH_LOW, ratio=0.75)
        idx_np, ok_np = fetch((idx, ok))
        ok_np[len(slots_k):] = False
        sel = np.flatnonzero(ok_np)
        rec["matches"] = len(sel)
        if len(sel) < cfg.min_matches:
            return None
        c_pos = np.clip(idx_np[sel], 0, len(slots_c) - 1)
        mp_k = mps_k[sel]
        mp_c = mps_c[c_pos]
        # the matched points in each keyframe's camera
        pk = m.mp_pos[mp_k] @ m.kf_R[k].T + m.kf_t[k]
        pc = m.mp_pos[mp_c] @ m.kf_R[c].T + m.kf_t[c]
        n = min(len(pk), SIM3_CAP)
        valid = upload(np.arange(SIM3_CAP) < n, dev)
        pc_d = upload(_pad1(pc, SIM3_CAP).astype(np.float32), dev)  # p1 = candidate frame
        pk_d = upload(_pad1(pk, SIM3_CAP).astype(np.float32), dev)  # p2 = current frame
        res = solve_sim3_ransac(pc_d, pk_d, valid, k, fix_scale=cfg.fix_scale,
                                min_inliers=cfg.min_sim3_inliers)
        success, n_ransac = fetch((res.success, res.n_inliers))
        rec["ransac_inliers"] = int(n_ransac)
        if not bool(success):
            return None
        # the closed form polished against both frames' pixels before it is
        # trusted (OptimizeSim3, src/Optimizer.cc:2115)
        inv_s2 = self.tcfg.inv_level_sigma2()
        slot_k_sel = slots_k[sel]
        slot_c_sel = slots_c[c_pos]
        S_ref, inl_ref, n_ref = optimize_sim3(
            res.S_12, self.cam, self.cam, pc_d, pk_d,
            upload(_pad1(m.kf_uv[c, slot_c_sel], SIM3_CAP), dev),
            upload(_pad1(m.kf_uv[k, slot_k_sel], SIM3_CAP), dev),
            upload(_pad1(inv_s2[m.kf_level[c, slot_c_sel]], SIM3_CAP, 1.0), dev),
            upload(_pad1(inv_s2[m.kf_level[k, slot_k_sel]], SIM3_CAP, 1.0), dev),
            valid & res.inliers, fix_scale=cfg.fix_scale)
        S, inl, n_inl = fetch((res.S_12, res.inliers, res.n_inliers))
        S_r, inl_r, n_r = fetch((S_ref, inl_ref, n_ref))
        rec["refined_inliers"] = int(n_r)
        if int(n_r) >= cfg.min_sim3_inliers:
            S, inl, n_inl = S_r, inl_r, n_r
        inl = inl[:n]
        pairs = (mp_k[:n][inl], mp_c[:n][inl])
        if cfg.fix_scale:
            # an inertial map is gravity-aligned: a valid correction is yaw
            # and translation only, so a hypothesis that tilts gravity by
            # more than 5 degrees is rejected (src/LoopClosing.cc:235-260)
            R_world = m.kf_R[c].T @ np.asarray(S.R) @ m.kf_R[k]
            if np.degrees(np.arccos(np.clip(R_world[2, 2], -1.0, 1.0))) > 5.0:
                return None
        return _host_sim3(S.s, S.R, S.t), int(n_inl), pairs

    # ----------------------------------------------------------- correction
    def _correct_loop(self, k: int, c: int, S_ck: Sim3, mp_pairs=None):
        """Essential-graph correction (CorrectLoop :969, OptimizeEssentialGraph
        src/Optimizer.cc:1501, SearchAndFuse: the matched loop points are
        welded so the global BA cannot relax the correction away)."""
        m = self.map
        kfs = m.keyframe_indices()
        fixed = kfs == int(c)  # anchor the old side
        self._run_essential_graph(kfs, fixed, m.kf_R[kfs].copy(), m.kf_t[kfs].copy(),
                                  extra_edge=(int(k), int(c), S_ck))
        # the closure's edge stays in every later essential graph
        # (mpCurrentKF->AddLoopEdge(mpLoopMatchedKF))
        m.add_loop_edge(int(k), int(c))
        if mp_pairs is not None:  # SearchAndFuse, src/LoopClosing.cc:2115
            counts = m.obs_count_per_point()
            for a, b in zip(*mp_pairs):
                a, b = int(a), int(b)
                if a == b or not (m.mp_valid[a] and m.mp_valid[b]):
                    continue
                if counts[b] >= counts[a]:
                    m.replace_point(a, b)
                else:
                    m.replace_point(b, a)
        if len(kfs) < self.cfg.gba_max_kfs:
            self._global_ba()

    def _run_essential_graph(self, kfs, fixed, snap_R, snap_t, extra_edge=None, iters: int = 25):
        """Essential-graph optimization over `kfs`, then the points moved with
        their reference keyframe.

        Edges (temporal, strong covisibility, historical loop / merge edges)
        are measured from the snapshot poses snap_R / snap_t: for a loop
        correction the current state (the loop edge is the inconsistency the
        solve spreads); after a merge the pre-weld state, so the fixed weld
        window's refinement is what propagates into both maps
        (OptimizeEssentialGraph's NonCorrectedSim3 / CorrectedSim3,
        src/Optimizer.cc:1501, from MergeLocal, src/LoopClosing.cc:1717).
        extra_edge: (i, j, S_ji host Sim3), the loop edge."""
        m = self.map
        dev = self.device
        kf_pos = {int(kf): i for i, kf in enumerate(kfs)}
        K = len(kfs)
        ei, ej, rel_s, rel_R, rel_t, wts = [], [], [], [], [], []

        def add_edge(i, j, s, R, t, w=1.0):
            ei.append(kf_pos[i])
            ej.append(kf_pos[j])
            rel_s.append(np.float32(s))
            rel_R.append(np.asarray(R, np.float32))
            rel_t.append(np.asarray(t, np.float32))
            wts.append(w)

        def add_snap_edge(i, j, w=1.0):
            # S_ji = T_j T_i^-1 at unit scale, from the snapshot
            pi, pj = kf_pos[i], kf_pos[j]
            R = snap_R[pj] @ snap_R[pi].T
            add_edge(i, j, 1.0, R, snap_t[pj] - R @ snap_t[pi], w)

        order = kfs[np.argsort(m.kf_frame_id[kfs])]
        for a, b in zip(order[:-1], order[1:]):  # temporal
            add_snap_edge(int(a), int(b))
        for kf in kfs:  # strong covisibility
            for other in np.flatnonzero(m.covisibility_weights(int(kf)) >= self.cfg.covis_weight_strong):
                if int(other) > int(kf) and int(other) in kf_pos:
                    add_snap_edge(int(kf), int(other))
        # every earlier closure (KeyFrame::AddLoopEdge, src/Optimizer.cc:1570 region)
        for a, b in m.valid_loop_edges():
            if a in kf_pos and b in kf_pos and a != b:
                add_snap_edge(int(a), int(b), w=3.0)
        if extra_edge is not None:
            # S_ck maps current-camera into candidate-camera coordinates, so
            # the measured Scw(c) = S_ck Scw(k): S_ji with i = k, j = c
            ke, ce, S_ck = extra_edge
            add_edge(int(ke), int(ce), S_ck.s.numpy(), S_ck.R.numpy(), S_ck.t.numpy(), w=3.0)

        S_old = Sim3(torch.ones(K, device=dev), upload(m.kf_R[kfs].astype(np.float32), dev),
                     upload(m.kf_t[kfs].astype(np.float32), dev))
        prob = PoseGraphProblem(
            S=S_old, fixed=upload(np.asarray(fixed, bool), dev),
            edge_i=upload(np.array(ei, np.int64), dev), edge_j=upload(np.array(ej, np.int64), dev),
            S_ji_meas=Sim3(upload(np.array(rel_s, np.float32), dev), upload(np.stack(rel_R), dev),
                           upload(np.stack(rel_t), dev)),
            edge_weight=upload(np.array(wts, np.float32), dev),
            edge_valid=torch.ones(len(ei), dtype=torch.bool, device=dev))
        # an initialized inertial map corrects with translation and yaw only
        # (OptimizeEssentialGraph4DoF, src/Optimizer.cc:5292)
        four_dof = bool(m.imu_initialized and m.n_inertial_ba >= 2)
        S_opt = optimize_pose_graph(prob, four_dof, iters)
        # poses: the Sim3 folded into SE3 ([R t/s]); points: p' = S_new^-1 S_old p
        # through their reference keyframe
        se3_new = S_opt.to_se3()
        mp_all = m.point_indices()
        ref_pos = upload(np.array([kf_pos.get(int(r), 0) for r in m.mp_first_kf[mp_all]],
                                  np.int64), dev)

        def take(S):
            return Sim3(S.s[ref_pos], S.R[ref_pos], S.t[ref_pos])

        p_new = take(S_opt).inverse().apply(take(S_old).apply(upload(m.mp_pos[mp_all], dev)))
        R_new, t_new, p_new = fetch((se3_new.R, se3_new.t, p_new))
        m.kf_R[kfs] = R_new
        m.kf_t[kfs] = t_new
        m.mp_pos[mp_all] = p_new

    def _merge_maps(self, k: int, c: int, S_ck: Sim3):
        """Weld the active map into the candidate's (MergeLocal,
        src/LoopClosing.cc:1215). The similarity from the active map's world
        to the candidate map's is S_dst_src = T_c^-1 S_ck T_k."""
        m = self.map
        T_k = _host_sim3(1.0, m.kf_R[k], m.kf_t[k])
        T_c = _host_sim3(1.0, m.kf_R[c], m.kf_t[c])
        S = (T_c.inverse() @ S_ck) @ T_k
        src, dst = int(m.kf_map[k]), int(m.kf_map[c])
        m.merge_map_into(src, dst, float(S.s), S.R.numpy(), S.t.numpy())
        # the weld stays as a merge edge (AddMergeEdge, src/LoopClosing.cc:1710)
        m.add_loop_edge(int(k), int(c))
        # snapshot before the weld refinement: the essential graph below
        # measures its edges here, so only the weld correction propagates
        kfs_all = m.keyframe_indices()
        snap_R = m.kf_R[kfs_all].copy()
        snap_t = m.kf_t[kfs_all].copy()
        window = list(dict.fromkeys(
            [int(k), int(c)] + [int(x) for x in m.best_covisible(int(c), 5, min_weight=5)]))
        # local BA around the junction, the old map's keyframe fixed. A
        # failure propagates (the async mapper surfaces it) rather than being
        # logged and skipped.
        obs = m.kf_obs[window]
        mp_sel = np.unique(obs[obs != NO_POINT])
        mp_sel = mp_sel[m.mp_valid[mp_sel]]
        if len(mp_sel) >= 20:
            kf_sel = np.array(window)
            fixed = np.zeros(len(kf_sel), bool)
            fixed[1] = True
            prob = _pad_problem(_build_ba_problem(m, self.tcfg, kf_sel, mp_sel, fixed), self.device)
            res = fetch(bundle_adjust(to_device(prob, self.device), self.cam, 2, 5))
            _write_back_ba(m, prob, res, kf_sel, mp_sel)
        if self.vi_refine_fn is not None and self.imu is not None and self.imu.initialized:
            # the joint VI window BA after the weld (MergeInertialBA,
            # src/Optimizer.cc:3948, from MergeLocal2 src/LoopClosing.cc:1783;
            # merge_map_into carried the velocities through the Sim3)
            self.vi_refine_fn(int(k))
        # the essential graph over the rest of the merged map, the refined
        # weld window fixed (MergeLocal, src/LoopClosing.cc:1717)
        fixed = np.isin(kfs_all, np.asarray(window, kfs_all.dtype))
        if fixed.any() and len(kfs_all) > len(window) + 1:
            self._run_essential_graph(kfs_all, fixed, snap_R, snap_t)

    def _global_ba(self):
        """GlobalBundleAdjustemnt after a loop (RunGlobalBundleAdjustment,
        src/LoopClosing.cc:2268-2500): 2 rounds x 5 LM iterations over the
        whole active map, the oldest keyframe fixed, the problem padded to
        power-of-two buckets (mapping/local_mapper.py::_pad_problem), then
        committed through slam_map/commit.py. An IMU-initialized map goes
        through the joint VI solver instead (_global_vi_ba), and falls back
        here only when its inertial chain is too short."""
        if self.imu is not None and self.imu.initialized and self.map.imu_initialized:
            if self._global_vi_ba():
                return True
        with self.stats.measure("gba"):
            m = self.map
            kfs = m.keyframe_indices()
            mps = m.point_indices()
            kfs_fid = m.kf_frame_id[kfs].copy()
            pre_R, pre_t = m.kf_R[kfs].copy(), m.kf_t[kfs].copy()
            fixed = np.zeros(len(kfs), bool)
            fixed[int(np.argmin(m.kf_frame_id[kfs]))] = True
            prob = to_device(_pad_problem(_build_ba_problem(m, self.tcfg, kfs, mps, fixed),
                                          self.device), self.device)
            for round_idx in range(2):
                # the Huber round, outliers reclassified, then the plain round
                res = bundle_adjust(prob, self.cam, 1, 5, round_idx == 0)
                prob = prob._replace(T_cw=res.T_cw, points=res.points,
                                     obs_valid=prob.obs_valid & res.obs_inlier)
            R, t, pts = fetch((res.T_cw.R, res.T_cw.t, res.points))
            commit_whole_map_solve(m, kfs, kfs_fid, mps, R[: len(kfs)], t[: len(kfs)],
                                   pts[: len(mps)], pre_R, pre_t)
            self.n_gba_runs += 1
        return True

    def _global_vi_ba(self) -> bool:
        """The joint visual-inertial global BA over the whole inertial chain
        (RunGlobalBundleAdjustment routes IMU-initialized maps to
        FullInertialBA(pActiveMap, 7, ...), src/LoopClosing.cc:2284-2287,
        src/Optimizer.cc:392-560): two rounds of 4 LM iterations, the
        oldest chain keyframe fixed, the chi2 outliers dropped between them.
        False (nothing done) when fewer than 4 chain keyframes survive."""
        from ..imu.preintegration import ImuBias
        from ..optim.vi_ba import build_vi_problem, to_device as vi_to_device, vi_bundle_adjust

        m = self.map
        kfs_chain, pres = self.imu.valid_chain(m)
        if len(kfs_chain) < 4:
            return False
        with self.stats.measure("gba"):
            kfs = np.asarray(kfs_chain)
            kfs_fid = m.kf_frame_id[kfs].copy()
            fixed = np.zeros(len(kfs), bool)
            fixed[0] = True  # gauge: the oldest chain keyframe
            prob, _, mp_sel = build_vi_problem(m, self.tcfg, list(kfs), pres[1:], fixed, 0.0, 0.0,
                                               self.imu.cfg, pt_bucket=16384, obs_bucket=8192,
                                               state_fixed=np.zeros(len(kfs), bool))
            pre_R, pre_t = m.kf_R[kfs].copy(), m.kf_t[kfs].copy()
            prob = vi_to_device(prob, self.device)
            for _ in range(2):
                res = vi_bundle_adjust(prob, self.cam, 1, 4)
                prob = prob._replace(T_cw=res.T_cw, points=res.points, v_w=res.v_w, bg=res.bg,
                                     ba=res.ba, obs_valid=prob.obs_valid & res.obs_inlier)
            res = fetch(res)
            K0 = len(kfs)
            alive = m.kf_valid[kfs] & (m.kf_frame_id[kfs] == kfs_fid)
            m.kf_vel[kfs[alive]] = res.v_w[:K0][alive]
            m.kf_bias[kfs[alive], :3] = res.bg[:K0][alive]
            m.kf_bias[kfs[alive], 3:] = res.ba[:K0][alive]
            commit_whole_map_solve(m, kfs, kfs_fid, np.asarray(mp_sel), res.T_cw.R[:K0],
                                   res.T_cw.t[:K0], res.points[:len(mp_sel)], pre_R, pre_t)
            # the frontend's state follows the newest chain keyframe
            if alive[-1]:
                self.imu.v_w = res.v_w[K0 - 1].astype(np.float32)
                self.imu.bias = ImuBias(upload(res.bg[K0 - 1], self.device),
                                        upload(res.ba[K0 - 1], self.device))
            self.n_gba_runs += 1
        return True
