"""Spatially-balanced keypoint selection.

Port of orb_slam3_modified_tpu/ops/select.py: per-cell top-k over a fixed
grid, then a global top-K per level. Batched over a leading axis.

lax.top_k breaks ties lowest index first, and FAST scores on uint8 frames are
integers, so ties are common; torch.topk promises no order among ties. The
port takes a stable descending sort and slices it, which keeps equal scores
in index order. Like lax.top_k, it refuses a k larger than the axis: a level
with fewer candidates than its budget would otherwise give Features whose
fields disagree in length.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def top_k_lastdim(x, k: int):
    if k > x.shape[-1]:
        raise ValueError(f"k argument to top_k must be no larger than size along axis; "
                         f"got k={k} with shape={list(x.shape)}")
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pad_to_multiple(resp, cell: int):
    h, w = resp.shape[-2:]
    ph = (-h) % cell
    pw = (-w) % cell
    if ph or pw:
        resp = F.pad(resp, (0, pw, 0, ph))
    return resp


def _cells(resp, cell):
    b, h, w = resp.shape
    gh, gw = h // cell, w // cell
    return (
        resp.reshape(b, gh, cell, gw, cell).permute(0, 1, 3, 2, 4).reshape(b, gh, gw, -1)
    )


def cell_topk(resp_hi, resp_lo, cell: int, k_per_cell: int = 4):
    """Per-cell best corners with the high -> low threshold fallback.

    resp_hi / resp_lo: (B, H, W). Returns (ys, xs, scores), each
    (B, n_cells * k_per_cell); score 0 marks an empty slot."""
    resp_hi = pad_to_multiple(resp_hi, cell)
    resp_lo = pad_to_multiple(resp_lo, cell)
    b, h, w = resp_hi.shape
    gh, gw = h // cell, w // cell
    hi = _cells(resp_hi, cell)
    lo = _cells(resp_lo, cell)
    cell_has_hi = torch.amax(hi, dim=-1) > 0.0
    use = torch.where(cell_has_hi[..., None], hi, lo)
    scores, idx = top_k_lastdim(use, k_per_cell)
    dy = idx // cell
    dx = idx % cell
    cy = torch.arange(gh, device=idx.device)[:, None, None] * cell
    cx = torch.arange(gw, device=idx.device)[None, :, None] * cell
    ys = (cy + dy).reshape(b, -1)
    xs = (cx + dx).reshape(b, -1)
    return ys, xs, scores.reshape(b, -1)


def global_topk(ys, xs, scores, k: int):
    """Keep the k best by score along the last axis; fixed-size (B, k)
    outputs plus a valid mask."""
    vals, idx = top_k_lastdim(scores, k)
    return ys.gather(-1, idx), xs.gather(-1, idx), vals, vals > 0.0
