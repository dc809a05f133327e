"""SoA map data model: keyframes, map points, observations.

Port of orb_slam3_modified_tpu/slam_map/map_state.py, kept as a copy: the
arena is numpy on the host, so the port's map is bit-identical to the
reference's. Descriptors stay (N, 8) uint32 here; they become (N, 8) int32
with the same bits only when they go to the card (convert.py).

Instead of the reference's pointer-graph map (include/KeyFrame.h,
include/MapPoint.h, include/Map.h) the map is a set of fixed-capacity numpy
arrays with validity masks, mutated only by the host orchestrator under the
map lock. Device solvers consume array views; results are written back
wholesale. Capacities are static; allocation is free-list style via the
validity masks. Covisibility (KeyFrame::UpdateConnections,
include/KeyFrame.h:224-250) is derived on demand from the observation table.
"""
from __future__ import annotations

import dataclasses

import numpy as np

NO_POINT = -1

# byte-popcount lookup for vectorized medoid descriptors
_POPCOUNT_LUT = np.unpackbits(
    np.arange(256, dtype=np.uint8)[:, None], axis=1
).sum(axis=1).astype(np.int32)


@dataclasses.dataclass
class MapState:
    """One map of the Atlas. All arrays are host numpy; F = features/KF cap."""

    # keyframes
    kf_valid: np.ndarray  # (K,) bool
    kf_R: np.ndarray  # (K, 3, 3) T_cw rotation
    kf_t: np.ndarray  # (K, 3) T_cw translation
    kf_ts: np.ndarray  # (K,) float64 timestamps
    kf_frame_id: np.ndarray  # (K,) int64 source frame id
    # per-keyframe features (copied from the Frame at creation)
    kf_uv: np.ndarray  # (K, F, 2) float32
    kf_desc: np.ndarray  # (K, F, 8) uint32
    kf_level: np.ndarray  # (K, F) int32
    kf_angle: np.ndarray  # (K, F) float32
    kf_feat_valid: np.ndarray  # (K, F) bool
    # observation table: which map point each feature slot observes
    kf_obs: np.ndarray  # (K, F) int32 -> mp index or NO_POINT
    # map points
    mp_valid: np.ndarray  # (M,) bool
    mp_pos: np.ndarray  # (M, 3) float32
    mp_desc: np.ndarray  # (M, 8) uint32 representative descriptor
    mp_normal: np.ndarray  # (M, 3) float32 mean viewing direction
    mp_min_dist: np.ndarray  # (M,) scale-invariance range
    mp_max_dist: np.ndarray  # (M,)
    mp_first_kf: np.ndarray  # (M,) int32 creating keyframe
    mp_found: np.ndarray  # (M,) int32 times matched by tracker
    mp_visible: np.ndarray  # (M,) int32 times predicted visible
    # inertial state per keyframe (reference: KeyFrame velocity/bias fields,
    # include/KeyFrame.h:148-191 serialize block)
    kf_vel: np.ndarray = None  # (K, 3) body velocity in world
    kf_bias: np.ndarray = None  # (K, 6) [bg, ba]
    # rectified-stereo right-image u per feature, <0 = mono (reference:
    # Frame::mvuRight carried onto the KeyFrame; feeds the EdgeStereo
    # (u,v,uR) residual in BA solves, include/G2oTypes.h:414)
    kf_ur: np.ndarray = None  # (K, F) float32
    # spanning tree: parent keyframe at creation (reference:
    # KeyFrame::mpParent, include/KeyFrame.h:233-239). -1 = root.
    kf_parent: np.ndarray = None  # (K,) int32
    # multi-map (Atlas) labels: which logical map each kf/point belongs to.
    # A single SoA arena holds every map (reference: Atlas holds Map*s,
    # include/Atlas.h:79); sharing the index space makes the keyframe
    # database global and map merge a relabel + Sim3 transform.
    kf_map: np.ndarray = None  # (K,) int32
    mp_map: np.ndarray = None  # (M,) int32
    active_map: int = 0
    n_maps: int = 1
    # bookkeeping
    next_kf: int = 0
    n_inertial_ba: int = 0  # 0 = none, 1 = VIBA1 done, 2 = VIBA2 done
    imu_initialized: bool = False
    kf_removed_callbacks: list = dataclasses.field(default_factory=list)
    # cull-time redirects for trajectory replay (reference: SetBadFlag
    # records mTcp = T_culled_parent; SaveTrajectory* walks the chain,
    # src/System.cc:648-663). Keyed by (slot, frame_id) because slots are
    # free-listed and reused. Value: (parent_slot, parent_frame_id, T_cp 4x4).
    culled_redirect: dict = dataclasses.field(default_factory=dict)
    # persistent loop/merge edges (reference: KeyFrame::AddLoopEdge /
    # AddMergeEdge — every later essential-graph build re-includes them,
    # src/Optimizer.cc:1570 region). Entries (kf_i, fid_i, kf_j, fid_j);
    # frame ids guard against free-listed slot reuse.
    loop_edges: list = dataclasses.field(default_factory=list)

    def add_loop_edge(self, ki: int, kj: int):
        self.loop_edges.append(
            (int(ki), int(self.kf_frame_id[ki]), int(kj), int(self.kf_frame_id[kj]))
        )

    def valid_loop_edges(self):
        """Surviving (kf_i, kf_j) pairs (both slots alive and un-reused)."""
        out = []
        for ki, fi, kj, fj in self.loop_edges:
            if (
                self.kf_valid[ki]
                and self.kf_valid[kj]
                and int(self.kf_frame_id[ki]) == fi
                and int(self.kf_frame_id[kj]) == fj
            ):
                out.append((ki, kj))
        return out

    def loop_edge_keyframes(self):
        """Keyframe slots pinned by a loop/merge edge. The reference makes
        these permanently uncullable (KeyFrame::AddLoopEdge sets
        mbNotErase, src/KeyFrame.cc:525-528) — culling one would silently
        drop the constraint from every future essential graph."""
        out = set()
        for a, b in self.valid_loop_edges():
            out.add(a)
            out.add(b)
        return out

    @staticmethod
    def create(max_kf: int = 512, max_mp: int = 32768, feat_cap: int = 1024):
        K, M, F = max_kf, max_mp, feat_cap
        return MapState(
            kf_map=np.zeros(K, np.int32),
            mp_map=np.zeros(M, np.int32),
            kf_parent=np.full(K, -1, np.int32),
            kf_vel=np.zeros((K, 3), np.float32),
            kf_bias=np.zeros((K, 6), np.float32),
            kf_valid=np.zeros(K, bool),
            kf_R=np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)),
            kf_t=np.zeros((K, 3), np.float32),
            kf_ts=np.zeros(K, np.float64),
            kf_frame_id=np.full(K, -1, np.int64),
            kf_uv=np.zeros((K, F, 2), np.float32),
            kf_desc=np.zeros((K, F, 8), np.uint32),
            kf_level=np.zeros((K, F), np.int32),
            kf_angle=np.zeros((K, F), np.float32),
            kf_feat_valid=np.zeros((K, F), bool),
            kf_obs=np.full((K, F), NO_POINT, np.int32),
            kf_ur=np.full((K, F), -1.0, np.float32),
            mp_valid=np.zeros(M, bool),
            mp_pos=np.zeros((M, 3), np.float32),
            mp_desc=np.zeros((M, 8), np.uint32),
            mp_normal=np.zeros((M, 3), np.float32),
            mp_min_dist=np.zeros(M, np.float32),
            mp_max_dist=np.full(M, np.inf, np.float32),
            mp_first_kf=np.full(M, -1, np.int32),
            mp_found=np.ones(M, np.int32),
            mp_visible=np.ones(M, np.int32),
        )

    # ---- allocation ----
    def alloc_keyframe(self) -> int:
        free = np.flatnonzero(~self.kf_valid)
        if len(free) == 0:
            raise RuntimeError("keyframe capacity exhausted")
        k = int(free[0])
        self.kf_valid[k] = True
        self.kf_map[k] = self.active_map
        return k

    def alloc_points(self, n: int) -> np.ndarray:
        free = np.flatnonzero(~self.mp_valid)
        if len(free) < n:
            raise RuntimeError("map point capacity exhausted")
        idx = free[:n]
        self.mp_valid[idx] = True
        self.mp_map[idx] = self.active_map
        return idx

    # ---- multi-map (Atlas) ----
    def _kf_active(self):
        return self.kf_valid & (self.kf_map == self.active_map)

    def _mp_active(self):
        return self.mp_valid & (self.mp_map == self.active_map)

    def create_new_map(self) -> int:
        """Start a fresh map and make it active (reference:
        Atlas::CreateNewMap via Tracking::CreateMapInAtlas,
        src/Tracking.cc:2665)."""
        self.n_maps += 1
        self.active_map = self.n_maps - 1
        return self.active_map

    def map_ids(self):
        ids = np.unique(self.kf_map[self.kf_valid])
        return ids.tolist()

    def merge_map_into(self, src_map: int, dst_map: int, s, R, t):
        """Relabel src map into dst, transforming src poses/points by the
        similarity (s, R, t): world_dst = s * R @ world_src + t.

        Reference: LoopClosing::MergeLocal (src/LoopClosing.cc:1215) welds
        the active map into the matched map.
        """
        kf_sel = self.kf_valid & (self.kf_map == src_map)
        mp_sel = self.mp_valid & (self.mp_map == src_map)
        # points: direct similarity transform
        self.mp_pos[mp_sel] = (
            s * self.mp_pos[mp_sel] @ R.T + t
        ).astype(np.float32)
        # keyframe poses: x_c = R_cw w + t_cw with w = R^T (w' - t) / s gives
        # the Sim3 camera (1/s, R_cw R^T, t_cw - (1/s) R_cw R^T t); projection
        # is scale-invariant, so the equivalent SE3 storage is
        # (R_cw R^T, s*t_cw - R_cw R^T t) — the reference's [R t/s] trick
        # (src/LoopClosing.cc:1062 region) applied at merge time.
        Rn = np.einsum("kij,lj->kil", self.kf_R[kf_sel], R)  # R_cw @ R^T
        self.kf_R[kf_sel] = Rn
        self.kf_t[kf_sel] = (
            s * self.kf_t[kf_sel] - np.einsum("kij,j->ki", Rn, t)
        ).astype(np.float32)
        # body velocities are world-frame vectors: v' = s R v (reference:
        # MergeLocal2 velocity transport, src/LoopClosing.cc:1783 region —
        # KeyFrame::SetVelocity with the Sim3-rotated, scaled velocity)
        if self.kf_vel is not None:
            self.kf_vel[kf_sel] = (
                s * self.kf_vel[kf_sel] @ np.asarray(R).T
            ).astype(np.float32)
        self.kf_map[kf_sel] = dst_map
        self.mp_map[mp_sel] = dst_map
        self.active_map = dst_map

    # ---- queries ----
    def keyframe_indices(self, all_maps: bool = False):
        return np.flatnonzero(self.kf_valid if all_maps else self._kf_active())

    def point_indices(self, all_maps: bool = False):
        return np.flatnonzero(self.mp_valid if all_maps else self._mp_active())

    def n_keyframes(self, all_maps: bool = False):
        return int((self.kf_valid if all_maps else self._kf_active()).sum())

    def n_points(self, all_maps: bool = False):
        return int((self.mp_valid if all_maps else self._mp_active()).sum())

    def observations_of_kf(self, k: int):
        """Feature slots of kf k that observe a point: (slots, mp_idx)."""
        obs = self.kf_obs[k]
        slots = np.flatnonzero(obs != NO_POINT)
        return slots, obs[slots]

    def covisibility_weights(self, k: int):
        """Shared-observation counts between kf k and every other kf.

        Reference: KeyFrame::UpdateConnections counts shared MapPoints.
        Returns (K,) int32 (0 for self/invalid). Uses the native C++ engine
        when available (native/), numpy otherwise.
        """
        from .. import native

        w = native.covis_weights(self.kf_obs, self.kf_valid, self.mp_valid.shape[0], k)
        if w is not None:
            return w
        mp = self.kf_obs[k]
        observed = np.zeros(self.mp_valid.shape[0] + 1, bool)
        observed[mp[mp != NO_POINT]] = True
        # for each kf, count its observations that hit `observed`
        hits = observed[np.where(self.kf_obs == NO_POINT, self.mp_valid.shape[0], self.kf_obs)]
        w = (hits & (self.kf_obs != NO_POINT)).sum(axis=1).astype(np.int32)
        w[k] = 0
        w[~self.kf_valid] = 0
        return w

    def best_covisible(self, k: int, n: int, min_weight: int = 15):
        """Top-n covisible keyframes (reference GetBestCovisibilityKeyFrames)."""
        w = self.covisibility_weights(k)
        order = np.argsort(-w)
        sel = order[: n]
        return sel[w[sel] >= min_weight]

    def point_observers(self, mp_idx: np.ndarray):
        """For a set of points, boolean (K,) of keyframes observing any."""
        from .. import native

        out = native.point_observers(
            self.kf_obs, self.kf_valid, self.mp_valid.shape[0], np.atleast_1d(mp_idx)
        )
        if out is not None:
            return out
        mask = np.zeros(self.mp_valid.shape[0] + 1, bool)
        mask[mp_idx] = True
        safe = np.where(self.kf_obs == NO_POINT, self.mp_valid.shape[0], self.kf_obs)
        return (mask[safe] & (self.kf_obs != NO_POINT)).any(axis=1) & self.kf_valid

    def obs_count_per_point(self):
        """(M,) number of keyframes observing each point."""
        from .. import native

        out = native.obs_counts(self.kf_obs, self.kf_valid, self.mp_valid.shape[0])
        if out is not None:
            return out.astype(np.int64)
        counts = np.zeros(self.mp_valid.shape[0], np.int64)
        flat = self.kf_obs[self.kf_valid].ravel()
        flat = flat[flat != NO_POINT]
        np.add.at(counts, flat, 1)
        return counts

    # ---- mutation helpers ----
    def add_observation(self, k: int, slot: int, mp: int):
        self.kf_obs[k, slot] = mp

    def remove_point(self, mp_idx):
        """Cull points: clear validity + all observations referencing them."""
        mp_idx = np.atleast_1d(mp_idx)
        self.mp_valid[mp_idx] = False
        kill = np.isin(self.kf_obs, mp_idx)
        self.kf_obs[kill] = NO_POINT

    def remove_keyframe(self, k: int):
        # spanning-tree maintenance (reference: KeyFrame::SetBadFlag records
        # mTcp = T_culled * T_parent^-1 for trajectory replay and re-parents
        # children, src/KeyFrame.cc SetBadFlag + src/System.cc:648-663)
        if self.kf_parent is not None:
            p = int(self.kf_parent[k])
            if p >= 0 and self.kf_valid[p]:
                T_k = np.eye(4)
                T_k[:3, :3] = self.kf_R[k]
                T_k[:3, 3] = self.kf_t[k]
                T_p = np.eye(4)
                T_p[:3, :3] = self.kf_R[p]
                T_p[:3, 3] = self.kf_t[p]
                self.culled_redirect[(int(k), int(self.kf_frame_id[k]))] = (
                    p,
                    int(self.kf_frame_id[p]),
                    T_k @ np.linalg.inv(T_p),
                )
            # children re-anchor to the culled keyframe's parent
            children = np.flatnonzero(self.kf_valid & (self.kf_parent == k))
            self.kf_parent[children] = p
        self.kf_valid[k] = False
        self.kf_obs[k] = NO_POINT
        self.kf_feat_valid[k] = False
        # slots are free-listed and reused: observers (keyframe database,
        # word caches) must drop their entries for this id
        for cb in self.kf_removed_callbacks:
            cb(int(k))

    def replace_point(self, old: int, new: int):
        """Fuse: redirect observations of `old` to `new` (reference
        MapPoint::Replace), dropping duplicates where a kf already sees new."""
        sees_new = (self.kf_obs == new).any(axis=1)
        is_old = self.kf_obs == old
        # kfs that already observe new: drop the old observation
        self.kf_obs[is_old & sees_new[:, None]] = NO_POINT
        self.kf_obs[is_old & ~sees_new[:, None]] = new
        self.mp_found[new] += self.mp_found[old]
        self.mp_visible[new] += self.mp_visible[old]
        self.mp_valid[old] = False

    def update_point_stats(self, mp_idx: np.ndarray, scale_factors: np.ndarray):
        """Recompute normal, distinctive descriptor, scale range for points.

        Reference: MapPoint::UpdateNormalAndDepth (include/MapPoint.h:148) and
        ComputeDistinctiveDescriptors (:144 — min-median-Hamming).

        Vectorized: the observation table is inverted ONCE (single arena
        scan + argsort) instead of a full (K, F) scan per point.
        """
        # sort + dedupe: callers pass feature-slot-order lists, but the
        # segment bounds below feed np.add.reduceat, which silently returns
        # wrong sums for non-monotonic offsets
        mp_idx = np.unique(np.atleast_1d(mp_idx))
        if len(mp_idx) == 0:
            return
        # invert obs table once: for each target point, its (kf, slot) list
        want = np.zeros(self.mp_valid.shape[0], bool)
        want[mp_idx] = True
        ks_all, slots_all = np.nonzero(
            (self.kf_obs != NO_POINT)
            & self.kf_valid[:, None]
            & want[np.clip(self.kf_obs, 0, None)]
        )
        mps_all = self.kf_obs[ks_all, slots_all]
        order = np.argsort(mps_all, kind="stable")
        mps_s = mps_all[order]
        ks_s = ks_all[order]
        slots_s = slots_all[order]
        bounds = np.searchsorted(mps_s, mp_idx)
        bounds_hi = np.searchsorted(mps_s, mp_idx, side="right")
        # fully vectorized over points (the per-point python loop cost
        # ~100 ms/keyframe under the map lock): groups are contiguous in
        # the sorted inversion, so segment ops cover normals/medoids/scale
        sizes = bounds_hi - bounds
        nz = sizes > 0
        if not nz.any():
            return
        m_nz = mp_idx[nz]
        lo, sz = bounds[nz], sizes[nz]
        hi = bounds_hi[nz]
        # --- normals: mean of unit (point - center) over observers
        centers_s = -np.einsum(
            "kji,kj->ki", self.kf_R[ks_s], self.kf_t[ks_s]
        )
        vec = self.mp_pos[mps_s] - centers_s
        norms = np.linalg.norm(vec, axis=-1, keepdims=True)
        unit = np.where(norms > 1e-9, vec / np.maximum(norms, 1e-12), 0.0)
        sums = np.add.reduceat(unit, lo, axis=0)
        snorm = np.linalg.norm(sums, axis=-1, keepdims=True)
        good_n = snorm[:, 0] > 1e-9
        self.mp_normal[m_nz[good_n]] = (
            sums[good_n] / snorm[good_n]
        ).astype(self.mp_normal.dtype)
        # --- distinctive descriptor: min-median-Hamming medoid (reference
        # ComputeDistinctiveDescriptors). Observer sets are padded to a
        # common width (capped at 32 — beyond that the medoid of a sample
        # is statistically the medoid) by repeating the last observer;
        # padded entries are masked out of the median.
        S = int(min(max(sz.max(), 1), 32))
        col = np.minimum(np.arange(S)[None, :], (sz - 1)[:, None])
        gather = lo[:, None] + col  # (N, S)
        descs = self.kf_desc[ks_s[gather], slots_s[gather]]  # (N, S, 8)
        byts = descs.view(np.uint8).reshape(len(m_nz), S, 32)
        x = byts[:, :, None, :] ^ byts[:, None, :, :]  # (N, S, S, 32)
        d = _POPCOUNT_LUT[x].sum(-1, dtype=np.int32)  # (N, S, S)
        col_valid = np.arange(S)[None, :] < np.minimum(sz, S)[:, None]
        d = np.where(col_valid[:, None, :], d, 1 << 20)
        d_sorted = np.sort(d, axis=2)
        n_eff = np.minimum(sz, S)
        a_i = ((n_eff - 1) // 2)[:, None, None]
        b_i = (n_eff // 2)[:, None, None]
        med = 0.5 * (
            np.take_along_axis(d_sorted, np.broadcast_to(a_i, (len(m_nz), S, 1)), 2)[..., 0]
            + np.take_along_axis(d_sorted, np.broadcast_to(b_i, (len(m_nz), S, 1)), 2)[..., 0]
        )
        med = np.where(col_valid, med, np.inf)
        best = np.argmin(med, axis=1)
        self.mp_desc[m_nz] = descs[np.arange(len(m_nz)), best]
        # --- scale-invariance range from the last (reference) observer
        k_ref, slot_ref = ks_s[hi - 1], slots_s[hi - 1]
        center_ref = -np.einsum(
            "kji,kj->ki", self.kf_R[k_ref], self.kf_t[k_ref]
        )
        dist = np.linalg.norm(self.mp_pos[m_nz] - center_ref, axis=-1)
        sf = scale_factors[self.kf_level[k_ref, slot_ref]]
        self.mp_max_dist[m_nz] = dist * sf
        self.mp_min_dist[m_nz] = (
            self.mp_max_dist[m_nz] / scale_factors[len(scale_factors) - 1]
        )

    def _observers_slots(self, m: int):
        ks, slots = np.where(self.kf_obs == m)
        keep = self.kf_valid[ks]
        return ks[keep], slots[keep]
