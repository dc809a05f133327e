"""Commit a whole-map solve back into the map.

Port of the write-back half of orb_slam3_modified_tpu/slam_map/commit.py
(host numpy), used by the post-loop global BA (loop/loop_closer.py). The
reference also carries the correction through the spanning tree to
keyframes and points created while a snapshot was being solved
(src/LoopClosing.cc:2330-2500). In the port the global BA runs inline on
the mapper worker, so nothing is created during the solve; the propagation
comes with the first caller that solves a snapshot (the inertial solves,
ROADMAP item 10).

The caller holds the map lock.
"""
from __future__ import annotations


def commit_whole_map_solve(m, kfs, mps, R_opt, t_opt, pts_opt):
    """Write back solved keyframe poses and point positions.

    kfs: (K,) keyframe slots in the solve; mps: (P,) point slots in the
    solve; R_opt / t_opt / pts_opt: their solved states.
    """
    m.kf_R[kfs] = R_opt
    m.kf_t[kfs] = t_opt
    m.mp_pos[mps] = pts_opt
