"""Commit a whole-map (or whole-chain) solve back into the map, with the
correction carried to keyframes and points created while it ran.

Port of orb_slam3_modified_tpu/slam_map/commit.py (host numpy). The staged
IMU init's full visual-inertial BA solves a snapshot of the keyframe chain
while the tracker may go on extending the map (the asynchronous init mode,
tracking/imu_frontend.py); keyframes born meanwhile are corrected through
the spanning-tree parent chain, T_new = (T_child T_parent_pre^-1)
T_parent_opt, and points born meanwhile through their first keyframe
(RunGlobalBundleAdjustment's post-GBA propagation,
src/LoopClosing.cc:2330-2500; InitializeIMU's queued keyframes,
src/LocalMapping.cc:1300-1360). The loop closer's global BA runs inline on
the mapper worker, so nothing is created during its solve and the
propagation finds nothing to carry there.

The caller holds the map lock.
"""
from __future__ import annotations

import numpy as np


def commit_whole_map_solve(m, kfs, kfs_fid, mps, R_opt, t_opt, pts_opt, pre_R, pre_t):
    """Write back solved keyframe poses and point positions and propagate
    the correction to keyframes / points created during the solve.

    kfs: (K,) keyframe slots in the solve; kfs_fid: their frame ids at
    snapshot time (slots are reused, so identity = slot AND frame id); mps:
    (P,) point slots; R_opt / t_opt / pts_opt: the solved states; pre_R /
    pre_t: the keyframe poses at snapshot time."""
    # keyframes culled or replaced during the solve keep their state
    alive = m.kf_valid[kfs] & (m.kf_frame_id[kfs] == kfs_fid)
    m.kf_R[kfs[alive]] = R_opt[alive]
    m.kf_t[kfs[alive]] = t_opt[alive]
    mp_alive = m.mp_valid[mps]
    m.mp_pos[mps[mp_alive]] = pts_opt[mp_alive]
    # keyframes created during the solve, through the parent chain
    in_solve = np.zeros(m.kf_valid.shape[0], bool)
    in_solve[kfs[alive]] = True
    pos_of = {int(k): i for i, k in enumerate(kfs)}
    corrected_R = {int(k): R_opt[pos_of[int(k)]] for k in kfs[alive]}
    corrected_t = {int(k): t_opt[pos_of[int(k)]] for k in kfs[alive]}
    pre_R_of = {int(k): pre_R[pos_of[int(k)]] for k in kfs[alive]}
    pre_t_of = {int(k): pre_t[pos_of[int(k)]] for k in kfs[alive]}
    for k in sorted(np.flatnonzero(m.kf_valid & ~in_solve), key=lambda x: int(m.kf_frame_id[x])):
        p = int(m.kf_parent[k])
        if p < 0 or p not in corrected_R:
            continue
        T_c = np.eye(4)
        T_c[:3, :3] = m.kf_R[k]
        T_c[:3, 3] = m.kf_t[k]
        T_pp = np.eye(4)
        T_pp[:3, :3] = pre_R_of[p]
        T_pp[:3, 3] = pre_t_of[p]
        T_po = np.eye(4)
        T_po[:3, :3] = corrected_R[p]
        T_po[:3, 3] = corrected_t[p]
        T_new = (T_c @ np.linalg.inv(T_pp)) @ T_po
        # a late keyframe becomes a corrected parent for its children
        pre_R_of[int(k)] = m.kf_R[k].copy()
        pre_t_of[int(k)] = m.kf_t[k].copy()
        corrected_R[int(k)] = T_new[:3, :3].astype(np.float32)
        corrected_t[int(k)] = T_new[:3, 3].astype(np.float32)
        m.kf_R[k] = T_new[:3, :3]
        m.kf_t[k] = T_new[:3, 3]
    # points created during the solve, through their first keyframe
    in_solve_pt = np.zeros(m.mp_valid.shape[0], bool)
    in_solve_pt[mps] = True
    for mp in np.flatnonzero(m.mp_valid & ~in_solve_pt):
        r = int(m.mp_first_kf[mp])
        if r not in corrected_R or r not in pre_R_of:
            continue
        p_cam = pre_R_of[r] @ m.mp_pos[mp] + pre_t_of[r]
        m.mp_pos[mp] = (corrected_R[r].T @ (p_cam - corrected_t[r])).astype(np.float32)
