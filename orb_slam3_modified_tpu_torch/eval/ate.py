"""Absolute trajectory error with Horn alignment + optimal scale.

Port of the reference evaluation methodology (reference:
evaluation/evaluate_ate_scale.py:50-75 — Horn 1987 closed-form alignment with
the optimal-scale variant, RMSE over aligned translations) so accuracy gates
match the reference's definition exactly.
"""
from __future__ import annotations

import numpy as np


def align_horn(model: np.ndarray, data: np.ndarray, with_scale: bool = True):
    """Align model (3, N) to data (3, N). Returns (R, t, s, trans_error)."""
    model_mean = model.mean(axis=1, keepdims=True)
    data_mean = data.mean(axis=1, keepdims=True)
    model_zc = model - model_mean
    data_zc = data - data_mean
    W = data_zc @ model_zc.T
    U, d, Vt = np.linalg.svd(W)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        dots = float(np.sum(data_zc * (R @ model_zc)))
        norms = float(np.sum(model_zc**2))
        s = dots / max(norms, 1e-12)
    else:
        s = 1.0
    t = data_mean - s * R @ model_mean
    aligned = s * R @ model + t
    err = np.linalg.norm(aligned - data, axis=0)
    return R, t, s, err


def ate_rmse(est_positions: np.ndarray, gt_positions: np.ndarray, with_scale=True):
    """est/gt: (N, 3) matched positions -> scale-aligned RMSE ATE (meters)."""
    _, _, s, err = align_horn(est_positions.T, gt_positions.T, with_scale)
    return float(np.sqrt(np.mean(err**2))), s


def associate_by_timestamp(ts_a, ts_b, max_dt=0.02):
    """Greedy timestamp matching (reference: evaluation/associate.py)."""
    pairs = []
    used_b = set()
    for i, ta in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - ta)))
        if abs(ts_b[j] - ta) <= max_dt and j not in used_b:
            pairs.append((i, j))
            used_b.add(j)
    return pairs



def largest_map_ate(slam_map, gt_centres: dict):
    """Scale-aligned ATE of the keyframes of the map that holds the most
    keyframes, against the true camera centres at their frame ids.
    gt_centres: {frame id: (3,) centre}. Returns (rmse, scale, n_keyframes,
    map id); reads only the numpy map."""
    m = slam_map
    kfs = m.keyframe_indices(all_maps=True)
    ids, counts = np.unique(m.kf_map[kfs], return_counts=True)
    mid = int(ids[np.argmax(counts)])
    kfs = kfs[m.kf_map[kfs] == mid]
    est = np.stack([-m.kf_R[k].T @ m.kf_t[k] for k in kfs])
    gt = np.stack([gt_centres[int(m.kf_frame_id[k])] for k in kfs])
    rmse, scale = ate_rmse(est.astype(np.float64), gt)
    return rmse, scale, len(kfs), mid
