"""Two-view reconstruction for monocular initialization.

Port of orb_slam3_modified_tpu/geom/two_view.py (TwoViewReconstruction,
src/TwoViewReconstruction.cc): 8-point essential and 4-point homography
hypotheses, model selection by score ratio, motion-hypothesis selection by
cheirality and parallax. As in the reference, all 200 hypotheses of each
model are estimated and scored as one batched computation on the inputs'
device, and the result stays there (no host read inside).

Random minimal sets: the reference draws them with jax.random.categorical
from a PRNG key; torch cannot reproduce those draws, so the port draws from
a torch.Generator (the tracker seeds it with the frame id, so a run is
repeatable). The draw is one function, `_sample_minimal_sets`, which a
parity test can replace with the reference's sets. The SVD factors' signs
differ between libraries; the decompositions enumerate every sign case and
cheirality selects among them, so the chosen (R, t) does not depend on them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..lie.se3 import SE3
from .triangulation import triangulate_dlt

NUM_HYP = 200  # reference: mMaxIterations = 200 (src/TwoViewReconstruction.cc:70)
TH_F_PX = 3.841  # chi2(1dof, 0.05) gate, reference CheckFundamental
TH_SCORE_PX = 5.991  # chi2(2dof) score cap, reference CheckFundamental/Homography
MIN_TRIANGULATED = 50  # reference: minTriangulated param of ReconstructF/H
MIN_PARALLAX_DEG = 1.0  # reference: minParallax = 1.0


class TwoViewResult(NamedTuple):
    success: torch.Tensor  # () bool
    T_21: SE3  # pose of cam2 w.r.t cam1 (world = cam1 frame)
    points: torch.Tensor  # (N, 3) triangulated points in cam1 frame
    valid: torch.Tensor  # (N,) bool triangulation validity
    n_good: torch.Tensor  # () int
    used_homography: torch.Tensor  # () bool


def _sample_minimal_sets(generator, mask, n_sets, set_size):
    """(n_sets, set_size) int64 indices drawn uniformly from the valid
    entries, with replacement (a duplicated index gives a degenerate
    hypothesis that scores low). With no valid entry every index may come."""
    w = mask.to(torch.float32)
    w = w + (~mask.any()).to(torch.float32)  # no host read for the empty case
    idx = torch.multinomial(w, n_sets * set_size, replacement=True, generator=generator)
    return idx.view(n_sets, set_size)


def _eigvec_min(AtA):
    return torch.linalg.eigh(AtA)[1][..., :, 0]


def _eight_point_E(x1, x2):
    """Batched 8-point: x1, x2 (..., 8, 2) unit-plane -> E (..., 3, 3)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    # x2^T E x1 = 0, rows [u2u1, u2v1, u2, v2u1, v2v1, v2, u1, v1, 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, one], dim=-1)
    e = _eigvec_min(A.transpose(-1, -2) @ A)
    E = e.reshape(*e.shape[:-1], 3, 3)
    # project to the essential manifold: singular values -> (1, 1, 0)
    U, _, Vt = torch.linalg.svd(E)
    S_proj = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return U @ (S_proj[:, None] * Vt)


def _four_point_H(x1, x2):
    """Batched DLT homography from 4 points: (..., 4, 2) -> (..., 3, 3)."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    zero = torch.zeros_like(u1)
    one = torch.ones_like(u1)
    r1 = torch.stack([u1, v1, one, zero, zero, zero, -u2 * u1, -u2 * v1, -u2], dim=-1)
    r2 = torch.stack([zero, zero, zero, u1, v1, one, -v2 * u1, -v2 * v1, -v2], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # (..., 8, 9)
    h = _eigvec_min(A.transpose(-1, -2) @ A)
    return h.reshape(*h.shape[:-1], 3, 3)


def _homogeneous(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _epipolar_errors(E, x1, x2):
    """Squared point-to-epiline distances both ways: (err12, err21), (H, N)
    each (CheckFundamental's two chi-squares)."""
    p1, p2 = _homogeneous(x1), _homogeneous(x2)
    l2 = torch.einsum("hij,nj->hni", E, p1)  # line in image 2
    l1 = torch.einsum("hji,nj->hni", E, p2)  # line in image 1
    num2 = torch.einsum("ni,hni->hn", p2, l2) ** 2
    num1 = torch.einsum("ni,hni->hn", p1, l1) ** 2
    den2 = l2[..., 0] ** 2 + l2[..., 1] ** 2
    den1 = l1[..., 0] ** 2 + l1[..., 1] ** 2
    return num1 / torch.clamp(den1, min=1e-12), num2 / torch.clamp(den2, min=1e-12)


def _homography_errors(H, x1, x2):
    """Squared symmetric transfer errors (err_in_1, err_in_2), (Hyp, N) each."""
    Hinv = torch.linalg.inv_ex(H)[0]
    p1, p2 = _homogeneous(x1), _homogeneous(x2)
    q2 = torch.einsum("hij,nj->hni", H, p1)
    q1 = torch.einsum("hij,nj->hni", Hinv, p2)
    q2 = q2[..., :2] / torch.where(torch.abs(q2[..., 2:]) < 1e-12, 1e-12, q2[..., 2:])
    q1 = q1[..., :2] / torch.where(torch.abs(q1[..., 2:]) < 1e-12, 1e-12, q1[..., 2:])
    return torch.sum((q1 - x1[None]) ** 2, dim=-1), torch.sum((q2 - x2[None]) ** 2, dim=-1)


def _decompose_E(E):
    """E -> 4 motion hypotheses (R, t), t unit-norm (reference: DecomposeE)."""
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.where(torch.linalg.det(U) < 0, -1.0, 1.0)
    Vt = Vt * torch.where(torch.linalg.det(Vt) < 0, -1.0, 1.0)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[..., 2]
    t = t / torch.clamp(torch.linalg.norm(t, dim=-1, keepdim=True), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _rot_y(c, s, s02, s20, d11, d22):
    """(3, 3) [[c, 0, s02*s], [0, d11, 0], [s20*s, 0, d22*c]] from 0-d tensors."""
    z = torch.zeros_like(c)
    return torch.stack([
        torch.stack([c, z, s02 * s]),
        torch.stack([z, z + d11, z]),
        torch.stack([s20 * s, z, d22 * c]),
    ])


def _decompose_H(H):
    """Faugeras SVD decomposition of a unit-plane homography into 8 (R, t)
    (reference: ReconstructH, src/TwoViewReconstruction.cc:594 region)."""
    U, S, Vt = torch.linalg.svd(H)
    d1, d2, d3 = S[..., 0], S[..., 1], S[..., 2]
    s = torch.linalg.det(U) * torch.linalg.det(Vt)
    d2s = torch.clamp(d2, min=1e-12)
    aux1 = torch.sqrt(torch.clamp(d1 * d1 - d2 * d2, min=0.0))
    aux3 = torch.sqrt(torch.clamp(d2 * d2 - d3 * d3, min=0.0))
    denom = torch.sqrt(torch.clamp(d1 * d1 - d3 * d3, min=1e-18))
    x1 = aux1 / denom
    x3 = aux3 / denom
    zero = torch.zeros_like(x1)
    Rs, ts = [], []
    # d' = +d2: rotation about y by theta, sin t = (d1 - d3) x1 x3 / d2
    sin_t = (d1 - d3) * x1 * x3 / d2s
    cos_t = (d1 * x3 * x3 + d3 * x1 * x1) / d2s
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            Rp = _rot_y(cos_t, e1 * e3 * sin_t, -1.0, 1.0, 1.0, 1.0)
            tp = torch.stack([e1 * x1, zero, -e3 * x3]) * (d1 - d3)
            Rs.append(s * U @ Rp @ Vt)
            ts.append(U @ tp)
    # d' = -d2: rotation about y by phi plus reflection
    sin_p = (d1 + d3) * x1 * x3 / d2s
    cos_p = (d3 * x1 * x1 - d1 * x3 * x3) / d2s
    for e1 in (1.0, -1.0):
        for e3 in (1.0, -1.0):
            Rp = _rot_y(cos_p, e1 * e3 * sin_p, 1.0, 1.0, -1.0, -1.0)
            tp = torch.stack([e1 * x1, zero, e3 * x3]) * (d1 + d3)
            Rs.append(s * U @ Rp @ Vt)
            ts.append(U @ tp)
    Rs = torch.stack(Rs)
    ts = torch.stack(ts)
    return Rs, ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True), min=1e-12)


def _check_motion_hypotheses(Rs, ts, x1, x2, mask, th_sq):
    """Triangulate every point under each (R, t); count the good ones
    (TwoViewReconstruction::CheckRT). Returns per hypothesis (n_good (Hyp,),
    points (Hyp, N, 3), good (Hyp, N), parallax_deg (Hyp,))."""
    n_hyp, n = Rs.shape[0], x1.shape[0]
    P1 = torch.cat([torch.eye(3, dtype=x1.dtype, device=x1.device),
                    torch.zeros((3, 1), dtype=x1.dtype, device=x1.device)], dim=-1)
    P1 = P1.expand(n_hyp, n, 3, 4)
    P2 = torch.cat([Rs, ts[..., None]], dim=-1)[:, None].expand(n_hyp, n, 3, 4)
    pts = triangulate_dlt(P1, P2, x1.expand(n_hyp, n, 2), x2.expand(n_hyp, n, 2))

    pc2 = torch.einsum("hij,hnj->hni", Rs, pts) + ts[:, None]
    z1, z2 = pts[..., 2], pc2[..., 2]
    c2 = -torch.einsum("hji,hj->hi", Rs, ts)  # camera-2 center in the cam1 frame
    r2 = pts - c2[:, None]
    cos_par = torch.sum(pts * r2, dim=-1) / (
        torch.linalg.norm(pts, dim=-1) * torch.linalg.norm(r2, dim=-1) + 1e-12
    )
    z1s = torch.where(torch.abs(z1) < 1e-9, 1e-9, z1)
    z2s = torch.where(torch.abs(z2) < 1e-9, 1e-9, z2)
    e1 = torch.sum((pts[..., :2] / z1s[..., None] - x1[None]) ** 2, dim=-1)
    e2 = torch.sum((pc2[..., :2] / z2s[..., None] - x2[None]) ** 2, dim=-1)
    finite = torch.isfinite(pts).all(dim=-1)
    good = (mask[None] & finite & (z1 > 0) & (z2 > 0) & (cos_par < 0.99998)
            & (e1 < th_sq) & (e2 < th_sq))
    n_good = torch.sum(good, dim=-1)
    # parallax statistic: the 50th-smallest cosine among the good points
    # (CheckRT sorts and indexes min(50, size) - 1)
    sorted_cos = torch.sort(torch.where(good, cos_par, 2.0), dim=-1).values
    idx = torch.clamp(n_good - 1, min=0, max=49)
    sel = torch.gather(sorted_cos, -1, idx[:, None])[:, 0]
    parallax_deg = torch.rad2deg(torch.arccos(torch.clamp(sel, -1.0, 1.0)))
    return n_good, pts, good, parallax_deg


def _select(n_good, pts, good, par, Rs, ts, n_inliers):
    best = torch.argmax(n_good)
    max_good = n_good[best]
    # "nsimilar" must be 1 (hypotheses within 0.7 of the best)
    nsimilar = torch.sum(n_good > 0.7 * max_good)
    min_good = torch.clamp((0.9 * n_inliers).to(torch.int32), min=MIN_TRIANGULATED)
    ok = (max_good >= min_good) & (nsimilar == 1) & (par[best] > MIN_PARALLAX_DEG)
    return ok, Rs[best], ts[best], pts[best], good[best], max_good


def reconstruct_two_views(x1, x2, mask, focal: float, generator: torch.Generator,
                          sigma: float = 1.0):
    """Monocular initializer on unit-plane correspondences.

    x1, x2: (N, 2) unit-plane coordinates in frames 1 / 2; mask: (N,) valid;
    focal: focal length in pixels (converts the pixel chi2 thresholds);
    generator: the torch.Generator on the inputs' device that draws the
    minimal sets. Flow of TwoViewReconstruction::Reconstruct
    (src/TwoViewReconstruction.cc:79)."""
    inv_f2 = (sigma / focal) ** 2
    th_f = TH_F_PX * inv_f2
    th_score = TH_SCORE_PX * inv_f2
    th_h = TH_SCORE_PX * inv_f2

    idx_E = _sample_minimal_sets(generator, mask, NUM_HYP, 8)
    idx_H = _sample_minimal_sets(generator, mask, NUM_HYP, 4)

    # ----- essential hypotheses -----
    E = _eight_point_E(x1[idx_E], x2[idx_E])  # (Hyp, 3, 3)
    eF1, eF2 = _epipolar_errors(E, x1, x2)
    inl_F = mask[None] & (eF1 < th_f) & (eF2 < th_f)
    score_F = torch.sum(
        torch.where(mask[None] & (eF1 < th_f), th_score - eF1, 0.0)
        + torch.where(mask[None] & (eF2 < th_f), th_score - eF2, 0.0), dim=-1)
    best_F = torch.argmax(score_F)
    SF, E_best, inliers_F = score_F[best_F], E[best_F], inl_F[best_F]

    # ----- homography hypotheses -----
    Hm = _four_point_H(x1[idx_H], x2[idx_H])
    eH1, eH2 = _homography_errors(Hm, x1, x2)
    inl_H = mask[None] & (eH1 < th_h) & (eH2 < th_h)
    score_H = torch.sum(
        torch.where(mask[None] & (eH1 < th_h), th_h - eH1, 0.0)
        + torch.where(mask[None] & (eH2 < th_h), th_h - eH2, 0.0), dim=-1)
    best_H = torch.argmax(score_H)
    SH, H_best, inliers_H = score_H[best_H], Hm[best_H], inl_H[best_H]

    # model selection at ratio 0.40 (the reference's reasoning: F's 1-D
    # residuals score better than H's 2-D ones even on planar scenes)
    use_H = SH / torch.clamp(SH + SF, min=1e-12) > 0.4

    # ----- motion hypotheses from both models, evaluated together -----
    Rs_E, ts_E = _decompose_E(E_best)
    Rs_H, ts_H = _decompose_H(H_best)
    th_sq = 4.0 * inv_f2 * sigma * sigma  # reference: 4*sigma2 in CheckRT
    nE, ptsE, goodE, parE = _check_motion_hypotheses(Rs_E, ts_E, x1, x2, mask & inliers_F, th_sq)
    nH, ptsH, goodH, parH = _check_motion_hypotheses(Rs_H, ts_H, x1, x2, mask & inliers_H, th_sq)
    okE, R_E, t_E, p_E, g_E, ngE = _select(nE, ptsE, goodE, parE, Rs_E, ts_E, inliers_F.sum())
    okH, R_H, t_H, p_H, g_H, ngH = _select(nH, ptsH, goodH, parH, Rs_H, ts_H, inliers_H.sum())

    return TwoViewResult(
        success=torch.where(use_H, okH, okE),
        T_21=SE3(torch.where(use_H, R_H, R_E), torch.where(use_H, t_H, t_E)),
        points=torch.where(use_H, p_H, p_E),
        valid=torch.where(use_H, g_H, g_E),
        n_good=torch.where(use_H, ngH, ngE),
        used_homography=use_H,
    )

