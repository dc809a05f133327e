"""Feature association: brute-force mutual best match and duplicate resolution.

Port of the parts of orb_slam3_modified_tpu/features/matcher.py that the
tracking step runs: a full masked (N1, N2) Hamming matrix, a row argmin with
Lowe's ratio against the second best, a mutual (column argmin) check, and a
segment-min that keeps one source per target. torch.argmin returns the first
minimum, as jnp.argmin does, so indices agree exactly.

Thresholds follow ORB-SLAM3: TH_LOW=50, TH_HIGH=100 (src/ORBmatcher.cc:35-37).
"""
from __future__ import annotations

import torch

from ..ops.hamming import MAX_DIST, hamming_matrix

TH_LOW = 50
TH_HIGH = 100


def mutual_best_match(
    desc1, valid1, desc2, valid2, max_dist: int = TH_LOW, ratio: float = 1.0,
    extra_mask=None,
):
    """Best match with Lowe ratio + mutual-consistency checks.

    Returns (idx2 (N1,) int64, ok (N1,) bool, dist (N1,) int32). extra_mask:
    optional (N1, N2) bool of allowed pairs."""
    dm = hamming_matrix(desc1, desc2)
    allowed = valid1[:, None] & valid2[None, :]
    if extra_mask is not None:
        allowed = allowed & extra_mask
    dm = torch.where(allowed, dm, MAX_DIST)
    idx = torch.argmin(dm, dim=1)
    best = torch.gather(dm, 1, idx[:, None])[:, 0]
    second = torch.amin(dm.scatter(1, idx[:, None], MAX_DIST), dim=1)
    ok = (best <= max_dist) & (best < ratio * second)
    col_best = torch.argmin(dm, dim=0)  # (N2,)
    rows = torch.arange(dm.shape[0], device=dm.device)
    ok = ok & (col_best[idx] == rows)
    return idx, ok, best


def resolve_duplicate_targets(idx, ok, dist, n_targets: int):
    """Keep, per target, only its best claim (lowest source index on ties)."""
    big = torch.where(ok, dist, MAX_DIST)
    best_per_target = torch.full(
        (n_targets,), MAX_DIST, dtype=big.dtype, device=big.device
    ).scatter_reduce(0, idx, big, "amin", include_self=True)
    keep = ok & (big <= best_per_target[idx])
    n = idx.shape[0]
    src = torch.arange(n, dtype=torch.int32, device=idx.device)
    first_claim = torch.full(
        (n_targets,), n, dtype=torch.int32, device=idx.device
    ).scatter_reduce(0, idx, torch.where(keep, src, n), "amin", include_self=True)
    return keep & (first_claim[idx] == src)
