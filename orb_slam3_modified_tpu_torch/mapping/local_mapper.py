"""Local mapping, monocular: map growth, fusion, local BA, culling.

Port of orb_slam3_modified_tpu/mapping/local_mapper.py (LocalMapping: Run
:64, ProcessNewKeyFrame :298, MapPointCulling :346, CreateNewMapPoints :388,
SearchInNeighbors :714, KeyFrameCulling :902 of src/LocalMapping.cc).

Each step snapshots what it needs from the numpy map under the map lock,
computes on `device` without the lock (the batched neighbour match,
triangulation, BA), reads its results back to the host, and commits them
to the map under the lock again; the tracker only ever sees the numpy map.
The mapper's batched matches take ONE Hamming-matrix launch for all
neighbours (features/matcher.py::batched_mutual_best_match).
Once the IMU is initialized (`mapper.imu`, set by the system for the
inertial sensors), the temporal-window visual-inertial BA (_vi_refine,
LocalInertialBA) takes the local BA's place.
"""
from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..cameras import Camera, project_np, unproject_np
from ..features.matcher import TH_LOW, batched_mutual_best_match, resolve_duplicate_targets
from ..geom import triangulate_dlt
from ..lie.se3 import SE3np
from ..optim.ba import BAProblem, bundle_adjust, to_device
from ..slam_map.map_state import NO_POINT, MapState
from ..tracking.tracker import TrackerConfig, _build_ba_problem, _pad1, _write_back_ba, host_camera
from ..utils.fetch import fetch, upload
from ..utils.timing import TimeStats

# Local-BA pad shapes on the card (see _pad_problem): keyframes / points /
# observations of the large bucket; the small bucket is half of each.
_BA_PAD_K = 32
_BA_PAD_P = 8192
_BA_PAD_O = 16384
NB = 8  # neighbours per batched match


@dataclasses.dataclass
class LocalMapperConfig:
    n_triangulation_neighbors: int = 10  # reference: nn=10 mono
    min_parallax_cos: float = 0.9998
    reproj_chi2: float = 5.991
    ba_window: int = 12  # covisible kfs in local BA
    cull_found_ratio: float = 0.25  # reference GetFoundRatio()<0.25f
    cull_min_obs: int = 3
    kf_cull_redundancy: float = 0.9  # reference: 90% rule


class LocalMapper:
    def __init__(self, cfg: LocalMapperConfig, tracker_cfg: TrackerConfig, slam_map: MapState,
                 device="cuda"):
        self.cfg = cfg
        self.tcfg = tracker_cfg
        self.map = slam_map
        self.device = resolve_device(device)
        cam = tracker_cfg.cam
        self.cam = Camera(cam.kind, cam.params.to(self.device), cam.width, cam.height)
        self.cam_np = host_camera(tracker_cfg.cam)
        self.stats = TimeStats()  # per-phase wall time
        self.recent_points: list = []  # (mp_idx array, birth_kf) for culling
        # set by AsyncLocalMapper: mutation phases take the map lock, device
        # work runs without it
        self.lock = contextlib.nullcontext()
        # tracking/imu_frontend.py::ImuFrontend for the inertial sensors
        self.imu = None

    def _up(self, arr, dtype=None):
        arr = np.asarray(arr)
        return upload(arr if dtype is None else arr.astype(dtype), self.device)

    def on_keyframe(self, k: int):
        """Process one keyframe: point culling, triangulation, fusion, local
        BA, keyframe culling. The reference skips the BA while keyframes
        queue up (src/LocalMapping.cc:148-155); no queue builds up here
        (mapping/async_mapper.py), so every keyframe gets its BA."""
        m = self.map
        if m.n_keyframes() < 2:
            return
        with self.stats.measure("mp_cull"), self.lock:
            _, mps = m.observations_of_kf(k)
            m.update_point_stats(mps, self.tcfg.scale_factors())
            self._cull_recent_points(k)
        with self.stats.measure("triangulate"):
            new_pts = self._create_new_points(k)
        if len(new_pts):
            self.recent_points.append((new_pts, k))
        with self.stats.measure("fuse"):
            self._fuse_neighbors(k)
        if m.n_keyframes() > 2:
            # once the IMU is initialized the temporal-window VI BA REPLACES
            # the visual local BA (LocalMapping::Run picks LocalInertialBA,
            # src/LocalMapping.cc:148-155)
            if self.imu is not None and self.imu.initialized:
                with self.stats.measure("vi_refine"):
                    self._vi_refine(k)
            else:
                with self.stats.measure("local_ba"):
                    self._local_ba(k)
        with self.stats.measure("kf_cull"), self.lock:
            self._cull_keyframes(k)

    def _vi_refine(self, k: int, window_size: int = 10):
        """Temporal-window joint visual-inertial BA (Optimizer::
        LocalInertialBA, src/Optimizer.cc:2383): the last `window_size`
        keyframes of the surviving chain (intervals merged across culled
        ones), poses, velocities, per-keyframe biases and their points
        together, the oldest keyframe's whole state pinned; then the chi2
        outliers dropped, as the visual local BA does."""
        from ..imu.preintegration import ImuBias
        from ..optim.vi_ba import build_vi_problem, to_device, vi_bundle_adjust, write_back_vi

        m = self.map
        imu = self.imu
        with self.lock:
            kfs_all, pres_all = imu.valid_chain(m)
            kfs = kfs_all[-window_size:]
            pres = pres_all[-window_size:][1:] if len(kfs_all) >= 2 else []
            if len(kfs) < 3:
                return
            fixed = np.zeros(len(kfs), bool)
            fixed[0] = True
            prob, kfs_np, mp_sel = build_vi_problem(m, self.tcfg, kfs, pres, fixed, 0.0, 0.0,
                                                    imu.cfg, obs_bucket=8192)
        res = fetch(vi_bundle_adjust(to_device(prob, self.device), self.cam, 2, 6))
        with self.lock:
            write_back_vi(m, res, kfs_np, mp_sel)
            self._drop_ba_outliers(m, prob, res, kfs_np, mp_sel)
        K = len(kfs)
        imu.v_w = res.v_w[K - 1].astype(np.float32)
        imu.bias = ImuBias(self._up(res.bg[K - 1], np.float32),
                           self._up(res.ba[K - 1], np.float32))
        imu.bias_epoch += 1

    # ------------------------------------------------------- triangulation
    def _create_new_points(self, k: int):
        """Epipolar-search triangulation against covisible keyframes
        (CreateNewMapPoints, src/LocalMapping.cc:388): one batched match
        against all neighbours, one batched triangulation, one readback."""
        m = self.map
        cfg = self.cfg
        cam_np = self.cam_np
        inv_s2 = self.tcfg.inv_level_sigma2()
        # ---- snapshot (map lock)
        with self.lock:
            neighbors = [int(x) for x in m.best_covisible(k, cfg.n_triangulation_neighbors,
                                                          min_weight=10)][:NB]
            if len(neighbors) == 0:
                return np.empty(0, np.int64)
            F = m.kf_uv.shape[1]
            free_k = m.kf_feat_valid[k] & (m.kf_obs[k] == NO_POINT)
            center_k = -m.kf_R[k].T @ m.kf_t[k]
            R_k_snap, t_k_snap = m.kf_R[k].copy(), m.kf_t[k].copy()
            r_k = unproject_np(cam_np, m.kf_uv[k]).astype(np.float32)  # (F, 3)
            r_n = np.zeros((NB, F, 3), np.float32)
            E_n = np.zeros((NB, 3, 3), np.float32)
            th_n = np.zeros((NB, F), np.float32)  # 0 threshold = masked out
            desc_n = np.zeros((NB, F, 8), np.uint32)
            valid_n = np.zeros((NB, F), bool)
            f2 = float(cam_np.params[0]) ** 2
            use = []
            for j, kn in enumerate(neighbors):
                center_n = -m.kf_R[kn].T @ m.kf_t[kn]
                if np.linalg.norm(center_k - center_n) < 0.01:
                    continue  # reference gate: tiny baseline
                # essential matrix cam_n <- cam_k: E = [t]x R of T_nk
                R_nk = m.kf_R[kn] @ R_k_snap.T
                t_nk = m.kf_t[kn] - R_nk @ t_k_snap
                E_n[j] = _hat(t_nk.astype(np.float32)) @ R_nk.astype(np.float32)
                r_n[j] = unproject_np(cam_np, m.kf_uv[kn]).astype(np.float32)
                th_n[j] = 3.84 / f2 / np.maximum(inv_s2[m.kf_level[kn]], 1e-9)
                desc_n[j] = m.kf_desc[kn]
                valid_n[j] = m.kf_feat_valid[kn] & (m.kf_obs[kn] == NO_POINT)
                use.append(j)
            desc_k_snap = m.kf_desc[k].copy()
        if not use:
            return np.empty(0, np.int64)

        # ---- device match (no lock), one readback
        idx_all, keep_all = fetch(_batched_neighbor_match(
            *(self._up(a) for a in (desc_k_snap.view(np.int32), free_k, r_k,
                                    desc_n.view(np.int32), valid_n, r_n, E_n, th_n))))

        # matched pairs of every neighbour, then ONE batched triangulation; a
        # feature is claimed by the first neighbour that matched it
        P1 = np.concatenate([R_k_snap, t_k_snap[:, None]], axis=1).astype(np.float32)
        sel_l, x1_l, x2_l, P2_l, nb_l = [], [], [], [], []
        for j in use:
            kn = neighbors[j]
            keep_np = keep_all[j] & free_k
            if not keep_np.any():
                continue
            sel = np.flatnonzero(keep_np)
            free_k[sel] = False
            r1 = r_k[sel]
            r2 = r_n[j][idx_all[j][sel]]
            sel_l.append(sel)
            x1_l.append(r1[:, :2] / r1[:, 2:3])
            x2_l.append(r2[:, :2] / r2[:, 2:3])
            P2 = np.concatenate([m.kf_R[kn], m.kf_t[kn][:, None]], axis=1).astype(np.float32)
            P2_l.append(np.broadcast_to(P2, (len(sel), 3, 4)))
            nb_l.append(np.full(len(sel), j, np.int32))
        if not sel_l:
            return np.empty(0, np.int64)
        sel_a = np.concatenate(sel_l)
        nb_a = np.concatenate(nb_l)
        n_pairs = len(sel_a)
        # one static bucket (the feature capacity bounds the pairs)
        pts = fetch(triangulate_dlt(
            self._up(np.broadcast_to(P1, (F, 3, 4))),
            self._up(_pad1(np.concatenate(P2_l), F)),
            self._up(_pad1(np.concatenate(x1_l).astype(np.float32), F)),
            self._up(_pad1(np.concatenate(x2_l).astype(np.float32), F)),
        ))[:n_pairs]
        # acceptance gates (cheirality, parallax, reprojection)
        idx_pair = np.concatenate([idx_all[int(n[0])][s] for n, s in zip(nb_l, sel_l)])
        kn_a = np.array([neighbors[j] for j in nb_a])
        R_n_a, t_n_a = m.kf_R[kn_a], m.kf_t[kn_a]
        center_n_a = -np.einsum("nij,ni->nj", R_n_a, t_n_a)
        pc1 = pts @ R_k_snap.T + t_k_snap
        pc2 = np.einsum("nij,nj->ni", R_n_a, pts) + t_n_a
        v1 = pts - center_k
        v2 = pts - center_n_a
        cosp = np.sum(v1 * v2, -1) / (np.linalg.norm(v1, axis=-1) * np.linalg.norm(v2, axis=-1)
                                      + 1e-12)
        uv1 = m.kf_uv[k][sel_a]
        uv2 = m.kf_uv[kn_a, idx_pair]
        e1 = np.sum((project_np(cam_np, pc1) - uv1) ** 2, -1) * inv_s2[m.kf_level[k][sel_a]]
        e2 = np.sum((project_np(cam_np, pc2) - uv2) ** 2, -1) * inv_s2[m.kf_level[kn_a, idx_pair]]
        good = ((pc1[:, 2] > 0) & (pc2[:, 2] > 0) & (cosp < cfg.min_parallax_cos)
                & (e1 < cfg.reproj_chi2) & (e2 < cfg.reproj_chi2) & np.isfinite(pts).all(axis=-1))
        created = []
        if good.any():
            gsel, g_idx, g_kn, g_pts = sel_a[good], idx_pair[good], kn_a[good], pts[good]
            with self.lock:
                # slots may have been claimed since the snapshot
                still = (m.kf_obs[k, gsel] == NO_POINT) & (m.kf_obs[g_kn, g_idx] == NO_POINT)
                gsel, g_idx, g_kn, g_pts = gsel[still], g_idx[still], g_kn[still], g_pts[still]
                if len(gsel):
                    try:
                        mp_idx = m.alloc_points(len(gsel))
                    except RuntimeError:
                        mp_idx = np.empty(0, np.int64)
                    n_ok = len(mp_idx)
                    if n_ok:
                        m.mp_pos[mp_idx] = g_pts[:n_ok]
                        m.mp_first_kf[mp_idx] = k
                        m.kf_obs[k, gsel[:n_ok]] = mp_idx
                        m.kf_obs[g_kn[:n_ok], g_idx[:n_ok]] = mp_idx
                        created.append(mp_idx)
        if not created:
            return np.empty(0, np.int64)
        out = np.concatenate(created)
        with self.lock:
            m.update_point_stats(out, self.tcfg.scale_factors())
        return out

    # -------------------------------------------------------------- fusion
    def _fuse_neighbors(self, k: int):
        """Project k's points into its neighbours and fuse duplicates
        (SearchInNeighbors src/LocalMapping.cc:714, Fuse src/ORBmatcher.cc:
        1148), first-order neighbours, one batched match."""
        m = self.map
        cam_np = self.cam_np
        with self.lock:
            neighbors = [int(x) for x in m.best_covisible(
                k, self.cfg.n_triangulation_neighbors, min_weight=10)][:NB]
            _, mps_k = m.observations_of_kf(k)
            if len(mps_k) == 0 or len(neighbors) == 0:
                return
            F = m.kf_uv.shape[1]
            n_c = min(len(mps_k), F)
            c_sel = np.arange(n_c)
            desc_p = _pad1(m.mp_desc[mps_k[:n_c]], F)
            uv_pred = np.zeros((NB, F, 2), np.float32)
            uv_n = np.zeros((NB, F, 2), np.float32)
            desc_n = np.zeros((NB, F, 8), np.uint32)
            valid_n = np.zeros((NB, F), bool)
            val_p_nb = np.zeros((NB, F), bool)
            for j, kn in enumerate(neighbors):
                pc = m.mp_pos[mps_k[:n_c]] @ m.kf_R[kn].T + m.kf_t[kn]
                uv = project_np(cam_np, pc)
                val_p_nb[j, :n_c] = ((pc[:, 2] > 0.05)
                                     & (uv[:, 0] >= 0) & (uv[:, 0] < cam_np.width)
                                     & (uv[:, 1] >= 0) & (uv[:, 1] < cam_np.height))
                uv_pred[j] = _pad1(np.nan_to_num(uv).astype(np.float32), F)
                uv_n[j] = m.kf_uv[kn]
                desc_n[j] = m.kf_desc[kn]
                valid_n[j] = m.kf_feat_valid[kn]
        idx_all, ok_all = fetch(_batched_fuse_match(
            *(self._up(a) for a in (desc_p.view(np.int32), val_p_nb, desc_n.view(np.int32),
                                    valid_n, uv_pred, uv_n))))
        with self.lock:
            self._commit_fuse(k, neighbors, mps_k, c_sel, n_c, idx_all, ok_all)

    def _commit_fuse(self, k, neighbors, mps_k, c_sel, n_c, idx_all, ok_all):
        m = self.map
        counts = m.obs_count_per_point()  # once, not per match
        for j, kn in enumerate(neighbors):
            ok_np = ok_all[j]
            ok_np[n_c:] = False
            idx_np = idx_all[j]
            for i in np.flatnonzero(ok_np):
                mp_src = int(mps_k[c_sel[i]])
                tgt_slot = int(idx_np[i])
                mp_tgt = int(m.kf_obs[kn, tgt_slot])
                if not m.mp_valid[mp_src]:
                    continue
                if mp_tgt == NO_POINT:
                    m.kf_obs[kn, tgt_slot] = mp_src
                elif mp_tgt != mp_src and m.mp_valid[mp_tgt]:
                    # keep the one with more observations
                    if counts[mp_tgt] >= counts[mp_src]:
                        m.replace_point(mp_src, mp_tgt)
                    else:
                        m.replace_point(mp_tgt, mp_src)

    # ------------------------------------------------------------ local BA
    def _local_ba(self, k: int):
        """LocalBundleAdjustment (src/Optimizer.cc:1116): the covisible window
        optimized, the frontier fixed, their points free."""
        m = self.map
        with self.stats.measure("ba_select"), self.lock:
            window = [k] + [int(x) for x in m.best_covisible(k, self.cfg.ba_window, min_weight=10)]
            window = list(dict.fromkeys(window))
            obs = m.kf_obs[window]
            mp_sel = np.unique(obs[obs != NO_POINT])
            mp_sel = mp_sel[m.mp_valid[mp_sel]]
            if len(mp_sel) < 20:
                return
            # frontier: keyframes observing these points outside the window,
            # capped at the pad shape (strongest covisibility first)
            observers = np.flatnonzero(m.point_observers(mp_sel))
            frontier = [int(x) for x in observers if int(x) not in window]
            max_frontier = _BA_PAD_K - len(window)
            if len(frontier) > max_frontier > 0:
                w = m.covisibility_weights(k)[frontier]
                frontier = [frontier[i] for i in np.argsort(-w)[:max_frontier]]
            kf_sel = np.array(window + frontier)
            fixed = np.zeros(len(kf_sel), bool)
            fixed[len(window):] = True
            if len(frontier) == 0:
                fixed[0] = True  # gauge anchor
            fixed[int(np.argmin(m.kf_frame_id[kf_sel]))] = True  # the oldest keyframe
            with self.stats.measure("ba_build"):
                prob = _build_ba_problem(m, self.tcfg, kf_sel, mp_sel, fixed)
        with self.stats.measure("ba_pad"):
            prob = _pad_problem(prob, self.device)
        with self.stats.measure("ba_solve"):
            res = fetch(bundle_adjust(to_device(prob, self.device), self.cam, 2, 5))
        with self.stats.measure("ba_write"), self.lock:
            _write_back_ba(m, prob, res, kf_sel, mp_sel)
            self._drop_ba_outliers(m, prob, res, kf_sel, mp_sel)

    def _drop_ba_outliers(self, m, prob, res, kf_sel, mp_sel):
        bad = (~np.asarray(res.obs_inlier)) & np.asarray(prob.obs_valid)
        obs_cam, obs_pt = np.asarray(prob.obs_cam), np.asarray(prob.obs_pt)
        for o in np.flatnonzero(bad):
            kk = int(kf_sel[obs_cam[o]])
            slot = np.flatnonzero(m.kf_obs[kk] == int(mp_sel[obs_pt[o]]))
            if len(slot):
                m.kf_obs[kk, slot[0]] = NO_POINT

    # ------------------------------------------------------------- culling
    def _cull_recent_points(self, k: int):
        """MapPointCulling (src/LocalMapping.cc:346)."""
        m = self.map
        keep = []
        counts = m.obs_count_per_point()
        for mp_idx, birth in self.recent_points:
            age = k - birth  # keyframe-count age proxy
            alive = m.mp_valid[mp_idx]
            ratio = m.mp_found[mp_idx] / np.maximum(m.mp_visible[mp_idx], 1)
            bad = alive & (ratio < self.cfg.cull_found_ratio)
            if age >= 2:
                bad |= alive & (counts[mp_idx] < self.cfg.cull_min_obs)
            if bad.any():
                m.remove_point(mp_idx[bad])
            if age < 3:
                keep.append((mp_idx[~bad & alive], birth))
        self.recent_points = keep

    def _cull_keyframes(self, k: int):
        """KeyFrameCulling (src/LocalMapping.cc:902): a covisible keyframe
        whose points are >= 90% seen by >= 3 other keyframes is removed."""
        m = self.map
        counts = m.obs_count_per_point()
        protected = m.loop_edge_keyframes()  # uncullable (mbNotErase)
        for kc in m.best_covisible(k, 10, min_weight=10):
            kc = int(kc)
            if kc == k or kc in protected:
                continue
            _, mps = m.observations_of_kf(kc)
            if len(mps) < 20:
                continue
            if (counts[mps] >= self.cfg.cull_min_obs + 1).mean() > self.cfg.kf_cull_redundancy:
                m.remove_keyframe(kc)


def _batched_neighbor_match(desc_k, free_k, r_k, desc_n, valid_n, r_n, E_n, th_n):
    """Match keyframe k's features against NB neighbours at once, epipolar
    gate included (SearchForTriangulation, src/ORBmatcher.cc:907 region).

    The (NB, F, F) epipolar masks are built on the device from unit-plane
    rays r_k (F, 3) / r_n (NB, F, 3), essential matrices E_n (NB, 3, 3) and
    per-target chi2 thresholds th_n (NB, F). Returns idx, keep (NB, F)."""
    l2 = torch.einsum("fj,nij->nfi", r_k, E_n)  # epiline of each k-feature, per neighbour
    d = l2 @ r_n.transpose(1, 2)  # (NB, F, F) algebraic point-line distance
    den = l2[..., 0] ** 2 + l2[..., 1] ** 2
    err = d * d / torch.clamp(den[..., None], min=1e-12)
    mask = err < th_n[:, None, :]
    idx, ok, dist = batched_mutual_best_match(desc_k, free_k, desc_n, valid_n, max_dist=TH_LOW,
                                              ratio=0.8, extra_mask=mask)
    return idx, resolve_duplicate_targets(idx, ok, dist, desc_k.shape[0])


def _batched_fuse_match(desc_p, val_p_nb, desc_n, valid_n, uv_pred, uv_n):
    """Fuse matching against NB neighbours at once: the 3 px radius masks
    from the projected candidates uv_pred (NB, F, 2) and the neighbours'
    keypoints uv_n (NB, F, 2). desc_p (F, 8) is shared; val_p_nb (NB, F) is
    each neighbour's candidate visibility. Returns idx, ok (NB, F)."""
    d = uv_pred[:, :, None, :] - uv_n[:, None, :, :]
    mask = torch.sum(d * d, dim=-1) < 9.0
    idx, ok, _ = batched_mutual_best_match(desc_p, val_p_nb, desc_n, valid_n, max_dist=TH_LOW,
                                           extra_mask=mask)
    return idx, ok


def _hat(v):
    return np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=np.float32)


def _pad_problem(prob: BAProblem, device) -> BAProblem:
    """Pad a numpy BA problem to a bucket shape, on the host.

    On the card, local BA takes exactly two fixed buckets (K 16 / 32, P 4096
    / 8192, O 8192 / 16384), so a later CUDA graph of the solve has two
    shapes to capture; larger problems grow by powers of two. On the CPU,
    power-of-two buckets keep small problems cheap. Padding does not change
    the result: padded cameras are fixed at the identity, padded points and
    observations are invalid."""
    def bucket(n, q):
        b = q
        while b < n:
            b *= 2
        return b

    K = prob.T_cw.t.shape[0]
    P = prob.points.shape[0]
    O = prob.obs_cam.shape[0]
    if torch.device(device).type == "cuda":
        if K <= 16 and P <= _BA_PAD_P // 2 and O <= _BA_PAD_O // 2:
            Kb, Pb, Ob = 16, _BA_PAD_P // 2, _BA_PAD_O // 2
        elif K <= _BA_PAD_K and P <= _BA_PAD_P and O <= _BA_PAD_O:
            Kb, Pb, Ob = _BA_PAD_K, _BA_PAD_P, _BA_PAD_O
        else:
            Kb = max(_BA_PAD_K, bucket(K, 16))
            Pb = max(_BA_PAD_P, bucket(P, 4096))
            Ob = max(_BA_PAD_O, bucket(O, 8192))
    else:
        Kb, Pb, Ob = bucket(K, 16), bucket(P, 4096), bucket(O, 8192)
    if (Kb, Pb, Ob) == (K, P, O):
        return prob

    def padn(a, n, fill=0.0):
        a = np.asarray(a)
        out = np.full((n, *a.shape[1:]), fill, a.dtype)
        out[: len(a)] = a
        return out

    R = padn(prob.T_cw.R, Kb)
    R[K:] = np.eye(3, dtype=R.dtype)
    return BAProblem(
        T_cw=SE3np(R, padn(prob.T_cw.t, Kb)),
        cam_fixed=padn(prob.cam_fixed, Kb, True),
        points=padn(prob.points, Pb),
        pt_valid=padn(prob.pt_valid, Pb, False),
        obs_cam=padn(prob.obs_cam, Ob),
        obs_pt=padn(prob.obs_pt, Ob),
        obs_uv=padn(prob.obs_uv, Ob),
        obs_inv_s2=padn(prob.obs_inv_s2, Ob, 1.0),
        obs_valid=padn(prob.obs_valid, Ob, False),
        obs_ur=None if prob.obs_ur is None else padn(prob.obs_ur, Ob, -1.0),
        bf=prob.bf,
    )
