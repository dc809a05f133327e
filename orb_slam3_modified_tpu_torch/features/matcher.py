"""Feature association: brute-force mutual best match and duplicate resolution.

Port of the parts of orb_slam3_modified_tpu/features/matcher.py that the
tracking step runs: a masked (N1, N2) Hamming matrix, a row argmin with
Lowe's ratio against the second best, a mutual (column argmin) check, and a
segment-min that keeps one source per target. torch.argmin returns the first
minimum, as jnp.argmin does, so indices agree exactly.

On the card the match is one fused kernel (csrc/hamming.cu,
`mutual_best_match_launch`): the distances, the mask (valid flags and, for
`windowed_mutual_best_match`, the motion window of tracking/fused.py) and all
the reductions run in one pass, so the matrix never reaches device memory.
`mutual_best_match_plain` and `windowed_mutual_best_match_plain` are the
plain torch versions; the wrappers take them only for CPU tensors.

Thresholds follow ORB-SLAM3: TH_LOW=50, TH_HIGH=100 (src/ORBmatcher.cc:35-37).
"""
from __future__ import annotations

import ctypes

import torch

from .._cuda import CudaKernel
from ..ops.hamming import MAX_DIST, check_desc, hamming_matrix, hamming_matrix_plain

TH_LOW = 50
TH_HIGH = 100

MATCH_KERNEL = CudaKernel(
    "hamming.cu",
    "mutual_best_match_launch",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 5,
)
# blocks of the fused kernel (csrc/hamming.cu kMRows, kMCols, kMWarps): a block owns
# MATCH_ROWS rows x MATCH_COLS columns and leaves one row partial per column split; the
# launcher rejects a scratch whose split count differs from its own kMCols
MATCH_ROWS, MATCH_COLS, MATCH_THREADS = 32, 256, 256


def match_from_matrix(dm, valid1, valid2, max_dist, ratio, extra_mask=None):
    """The reductions of mutual_best_match on a distance matrix dm (N1, N2)."""
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


def mutual_best_match_plain(
    desc1, valid1, desc2, valid2, max_dist: int = TH_LOW, ratio: float = 1.0,
    extra_mask=None,
):
    """mutual_best_match in plain torch, on hamming_matrix_plain."""
    return match_from_matrix(
        hamming_matrix_plain(desc1, desc2), valid1, valid2, max_dist, ratio, extra_mask
    )


def window_mask(uv1, uv2, radius):
    """(N1, N2) bool: |uv1[i] - uv2[j]|^2 < radius[j]^2, as tracking/fused.py builds it."""
    d2 = uv1[:, None, :] - uv2[None, :, :]
    return torch.sum(d2 * d2, dim=-1) < (radius * radius)[None, :]


def windowed_mutual_best_match_plain(
    desc1, valid1, desc2, valid2, uv1, uv2, radius, max_dist: int = TH_LOW,
    ratio: float = 1.0,
):
    """windowed_mutual_best_match in plain torch: the window as a mask."""
    return mutual_best_match_plain(
        desc1, valid1, desc2, valid2, max_dist, ratio, extra_mask=window_mask(uv1, uv2, radius)
    )


def _on_cpu(*tensors):
    return all(t.device.type == "cpu" for t in tensors)


def _fused_match(desc1, valid1, desc2, valid2, window, max_dist, ratio):
    """Launch the fused kernel; window is None or (uv1, uv2, radius)."""
    dev = desc1.device
    tensors = (desc1, valid1, desc2, valid2) + (window or ())
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"mutual_best_match: tensors on {sorted({str(t.device) for t in tensors})}")
    check_desc(desc1, "desc1")
    check_desc(desc2, "desc2")
    n1, n2 = desc1.shape[0], desc2.shape[0]
    for name, v, n in (("valid1", valid1, n1), ("valid2", valid2, n2)):
        if v.dtype != torch.bool or v.shape != (n,) or not v.is_contiguous():
            raise ValueError(f"{name}: expected contiguous ({n},) bool")
    ptrs = [0, 0, 0]
    if window is not None:
        uv1, uv2, radius = window
        for k, (name, x, shape) in enumerate(
            (("uv1", uv1, (n1, 2)), ("uv2", uv2, (n2, 2)), ("radius", radius, (n2,)))
        ):
            if x.dtype != torch.float32 or tuple(x.shape) != shape or not x.is_contiguous():
                raise ValueError(f"{name}: expected contiguous {shape} float32")
            if x.data_ptr() % 8:
                raise ValueError(f"{name}: must be 8-byte aligned")
            ptrs[k] = x.data_ptr()
    idx = torch.empty((n1,), dtype=torch.int64, device=dev)
    ok = torch.empty((n1,), dtype=torch.bool, device=dev)
    dist = torch.empty((n1,), dtype=torch.int32, device=dev)
    if n1 == 0:
        return idx, ok, dist
    splits = -(-n2 // MATCH_COLS)
    if n2 == 0 or splits > 65535:  # grid.y holds the column splits
        raise ValueError(f"mutual_best_match: n2={n2} columns outside the kernel's range")
    part = torch.empty((3, splits, n1), dtype=torch.int32, device=dev)
    col_key = torch.empty((n2,), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        MATCH_KERNEL(
            desc1.data_ptr(), valid1.data_ptr(), ptrs[0], desc2.data_ptr(), valid2.data_ptr(),
            ptrs[1], ptrs[2], n1, n2, int(max_dist), float(ratio), part.data_ptr(), splits,
            col_key.data_ptr(), idx.data_ptr(), ok.data_ptr(), dist.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    return idx, ok, dist


def mutual_best_match(
    desc1, valid1, desc2, valid2, max_dist: int = TH_LOW, ratio: float = 1.0,
    extra_mask=None,
):
    """Best match with Lowe ratio + mutual-consistency checks.

    Returns (idx2 (N1,) int64, ok (N1,) bool, dist (N1,) int32). extra_mask:
    optional (N1, N2) bool of allowed pairs. On CUDA tensors without
    extra_mask this is the fused kernel; with one, the matrix kernel and the
    torch reductions."""
    if _on_cpu(desc1, valid1, desc2, valid2):
        return mutual_best_match_plain(desc1, valid1, desc2, valid2, max_dist, ratio, extra_mask)
    if extra_mask is None:
        return _fused_match(desc1, valid1, desc2, valid2, None, max_dist, ratio)
    return match_from_matrix(hamming_matrix(desc1, desc2), valid1, valid2, max_dist, ratio, extra_mask)


def windowed_mutual_best_match(
    desc1, valid1, desc2, valid2, uv1, uv2, radius, max_dist: int = TH_LOW,
    ratio: float = 1.0,
):
    """mutual_best_match restricted to pairs with |uv1[i] - uv2[j]| < radius[j].

    uv1 (N1, 2), uv2 (N2, 2), radius (N2,) float32. On CUDA tensors this is
    the fused kernel with the window; the window mask is never built."""
    if _on_cpu(desc1, valid1, desc2, valid2, uv1, uv2, radius):
        return windowed_mutual_best_match_plain(
            desc1, valid1, desc2, valid2, uv1, uv2, radius, max_dist, ratio
        )
    return _fused_match(desc1, valid1, desc2, valid2, (uv1, uv2, radius), max_dist, ratio)


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
