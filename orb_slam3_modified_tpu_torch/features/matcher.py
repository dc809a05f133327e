"""Feature association: brute-force mutual best match, the host half's
searches, and duplicate resolution.

Port of orb_slam3_modified_tpu/features/matcher.py: a masked (N1, N2)
Hamming matrix, a row argmin with Lowe's ratio against the second best, a
mutual (column argmin) check, a segment-min that keeps one source per
target, the 30-bin rotation-consistency filter, and the searches built on
them (initialization window search, search by projection, and the mapper's
batched neighbour matches). torch.argmin returns the first minimum, as
jnp.argmin does, so indices agree exactly; indices come back int64 (JAX:
int32).

On the card the unmasked and the windowed match are one fused kernel
(csrc/hamming.cu, `mutual_best_match_launch`): the distances, the mask and
all the reductions run in one pass, so the matrix never reaches device
memory. A match with an arbitrary extra_mask (search_for_initialization,
search_by_projection, the reference-keyframe match, the mapper) takes the
matrix entry of the same source (`hamming_matrix_launch`) and the torch
reductions of match_from_matrix; the batched forms take one matrix launch
for all neighbours. `mutual_best_match_plain` and
`windowed_mutual_best_match_plain` are the plain torch versions; every
wrapper takes a plain version only for CPU tensors.

Thresholds follow ORB-SLAM3: TH_LOW=50, TH_HIGH=100, HISTO_LENGTH=30
(src/ORBmatcher.cc:35-37).
"""
from __future__ import annotations

import ctypes
import math

import torch

from .._cuda import CudaKernel
from ..ops.hamming import MAX_DIST, N_WORDS, check_desc, hamming_matrix, hamming_matrix_plain

TH_LOW = 50
TH_HIGH = 100
HISTO_BINS = 30

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
    """The reductions of mutual_best_match on a distance matrix dm (..., N1, N2);
    leading axes are independent problems (valid1 (..., N1), valid2 (..., N2))."""
    allowed = valid1[..., :, None] & valid2[..., None, :]
    if extra_mask is not None:
        allowed = allowed & extra_mask
    dm = torch.where(allowed, dm, MAX_DIST)
    idx = torch.argmin(dm, dim=-1)
    best = torch.gather(dm, -1, idx[..., None])[..., 0]
    second = torch.amin(dm.scatter(-1, idx[..., None], MAX_DIST), dim=-1)
    ok = (best <= max_dist) & (best < ratio * second)
    col_best = torch.argmin(dm, dim=-2)  # (..., N2)
    rows = torch.arange(dm.shape[-2], device=dm.device)
    ok = ok & (torch.gather(col_best, -1, idx) == rows)
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


def batched_mutual_best_match(desc1, valid1, desc2, valid2, max_dist: int = TH_LOW,
                              ratio: float = 1.0, extra_mask=None):
    """mutual_best_match of one source set against NB target sets at once.

    desc1 (N1, 8), valid1 (N1,) or (NB, N1), desc2 (NB, N2, 8), valid2
    (NB, N2), extra_mask (NB, N1, N2). The distances of all NB sets are one
    (N1, NB*N2) hamming_matrix (one kernel launch on the card), viewed as
    (NB, N1, N2) for the per-set reductions. Returns (idx, ok, dist), each
    (NB, N1)."""
    nb, n2 = desc2.shape[0], desc2.shape[1]
    dm = hamming_matrix(desc1, desc2.reshape(nb * n2, N_WORDS).contiguous())
    dm = dm.view(desc1.shape[0], nb, n2).transpose(0, 1)
    return match_from_matrix(dm, valid1, valid2, max_dist, ratio, extra_mask)


def rotation_consistency_mask(angle1, angle2, matched_idx, match_valid):
    """Keep only matches whose angle difference falls in the 3 dominant
    histogram bins (reference: ComputeThreeMaxima + HISTO_LENGTH=30).

    angle1: (N1,) radians; angle2: (N2,); matched_idx: (N1,) index into 2."""
    two_pi = 2.0 * math.pi
    rot = torch.remainder(angle1 - angle2[matched_idx], two_pi)
    bins = torch.clamp((rot * (HISTO_BINS / two_pi)).to(torch.int32), 0, HISTO_BINS - 1).long()
    hist = torch.zeros(HISTO_BINS, dtype=torch.int32, device=rot.device).index_add_(
        0, bins, match_valid.to(torch.int32))
    # lax.top_k order: count descending, lowest bin first among equal counts
    top3, top3_idx = (x[:3] for x in torch.sort(hist, descending=True, stable=True))
    # reference rule: bins 2 and 3 only while they hold >= 0.1 of the top bin
    thresh = torch.where(torch.arange(3, device=rot.device) == 0, 0,
                         (0.1 * top3[0]).to(torch.int32))
    keep_bin = torch.zeros(HISTO_BINS, dtype=torch.bool, device=rot.device)
    keep_bin[top3_idx] = top3 >= thresh
    return match_valid & keep_bin[bins]


def search_for_initialization(uv1, angle1, desc1, valid1, uv2, angle2, desc2, valid2,
                              window: float = 100.0):
    """Monocular-init matching (reference: SearchForInitialization
    src/ORBmatcher.cc:648): window search around the frame-1 location, ratio
    0.9, rotation consistency."""
    d2 = uv1[:, None, :] - uv2[None, :, :]
    spatial = torch.sum(d2 * d2, dim=-1) < window * window
    idx, ok, dist = mutual_best_match(
        desc1, valid1, desc2, valid2, max_dist=TH_LOW, ratio=0.9, extra_mask=spatial
    )
    return idx, rotation_consistency_mask(angle1, angle2, idx, ok), dist


def search_by_projection(uv_pred, level_pred, pt_desc, pt_valid, f_uv, f_level, f_desc,
                         f_valid, radius_per_level, level_tol: int = 1,
                         max_dist: int = TH_HIGH, ratio: float = 1.0):
    """Project-and-match (reference: SearchByProjection src/ORBmatcher.cc:43
    for local map points, :1676 for last-frame tracking).

    uv_pred (P, 2) predicted pixel position per candidate point; level_pred
    (P,) predicted octave: the window radius is radius_per_level (L,) at it,
    and candidate keypoints must lie within level_tol octaves. Returns
    (idx (P,), ok (P,), dist (P,))."""
    d = uv_pred[:, None, :] - f_uv[None, :, :]
    lvl = torch.clamp(level_pred, 0, radius_per_level.shape[0] - 1).long()
    r = radius_per_level[lvl]
    spatial = torch.sum(d * d, dim=-1) < (r * r)[:, None]
    lvl_ok = torch.abs(f_level[None, :] - level_pred[:, None]) <= level_tol
    return mutual_best_match(pt_desc, pt_valid, f_desc, f_valid, max_dist=max_dist,
                             ratio=ratio, extra_mask=spatial & lvl_ok)


def resolve_duplicate_targets(idx, ok, dist, n_targets: int):
    """Keep, per target, only its best claim (lowest source index on ties).
    Leading axes of idx / ok / dist are independent problems."""
    big = torch.where(ok, dist, MAX_DIST)
    lead = idx.shape[:-1]
    best_per_target = torch.full(
        (*lead, n_targets), MAX_DIST, dtype=big.dtype, device=big.device
    ).scatter_reduce(-1, idx, big, "amin", include_self=True)
    keep = ok & (big <= torch.gather(best_per_target, -1, idx))
    n = idx.shape[-1]
    src = torch.arange(n, dtype=torch.int32, device=idx.device).expand(idx.shape)
    first_claim = torch.full(
        (*lead, n_targets), n, dtype=torch.int32, device=idx.device
    ).scatter_reduce(-1, idx, torch.where(keep, src, n), "amin", include_self=True)
    return keep & (torch.gather(first_claim, -1, idx) == src)
