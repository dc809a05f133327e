"""AR overlay: dominant-plane detection and anchored object rendering.

Port of orb_slam3_modified_tpu/viz/ar.py (detect_plane, load_obj,
cube_model, render_overlay; :23-165), the fork's ViewAR module
(src/ViewAR.cc: DetectPlane :353 fits a plane to the tracked map points by
RANSAC; include/AR/RenderTree.h renders OBJ models). Host numpy: the plane
is a batched-hypothesis RANSAC, rendering draws shaded triangles into the
frame in painter's order (far faces first) with cv2, imported only there.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..cameras import Camera, project_np


class Plane(NamedTuple):
    normal: np.ndarray  # (3,) unit
    d: float  # plane: n.x + d = 0
    inliers: np.ndarray  # (N,) bool
    T_pw: np.ndarray  # (4, 4) plane-to-world (z up = normal)


def detect_plane(points: np.ndarray, n_hyp: int = 128, thresh: float = 0.02,
                 min_inlier_frac: float = 0.3, seed: int = 0):
    """RANSAC dominant plane from tracked map points (reference:
    ViewAR::DetectPlane uses 50 iterations over triples)."""
    n = len(points)
    if n < 16:
        return None
    rng = np.random.default_rng(seed)
    tri = rng.integers(0, n, (n_hyp, 3))
    p0, p1, p2 = points[tri[:, 0]], points[tri[:, 1]], points[tri[:, 2]]
    nrm = np.cross(p1 - p0, p2 - p0)
    norms = np.linalg.norm(nrm, axis=-1, keepdims=True)
    degenerate = norms[:, 0] < 1e-9  # collinear/duplicate triple
    nrm = nrm / np.maximum(norms, 1e-12)
    d = -np.sum(nrm * p0, axis=-1)
    dist = np.abs(points @ nrm.T + d[None, :])  # (N, H)
    # adaptive threshold relative to scene scale
    scale = np.median(np.linalg.norm(points - points.mean(0), axis=-1))
    th = max(thresh, 0.02 * scale)
    inl = dist < th
    counts = np.where(degenerate, 0, inl.sum(axis=0))
    best = int(np.argmax(counts))
    if counts[best] < min_inlier_frac * n * 0.5:
        return None
    normal = nrm[best]
    if normal[1] > 0:  # orient "up" consistently (y-down camera convention)
        normal = -normal
        dbest = -d[best]
    else:
        dbest = d[best]
    # refine with inlier SVD
    sel = points[inl[:, best]]
    c = sel.mean(0)
    _, _, Vt = np.linalg.svd(sel - c)
    normal_r = Vt[2]
    if normal_r @ normal < 0:
        normal_r = -normal_r
    dr = -normal_r @ c
    # plane frame: z = normal
    z = normal_r
    x = np.cross([0.0, 1.0, 0.0], z)
    if np.linalg.norm(x) < 1e-6:
        x = np.cross([1.0, 0.0, 0.0], z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    T = np.eye(4)
    T[:3, :3] = np.stack([x, y, z], axis=1)
    T[:3, 3] = c
    return Plane(normal_r, float(dr), inl[:, best], T)


def load_obj(path: str):
    """Minimal OBJ parser: vertices + triangular faces."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            p = line.split()
            if not p:
                continue
            if p[0] == "v":
                verts.append([float(x) for x in p[1:4]])
            elif p[0] == "f":
                idx = [int(t.split("/")[0]) - 1 for t in p[1:]]
                for i in range(1, len(idx) - 1):  # fan-triangulate
                    faces.append([idx[0], idx[i], idx[i + 1]])
    return np.array(verts, np.float32), np.array(faces, np.int32)


def cube_model(size: float = 0.1):
    s = size / 2
    v = np.array(
        [[x, y, z] for x in (-s, s) for y in (-s, s) for z in (0, size)],
        np.float32,
    )
    f = np.array(
        [[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
         [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
        np.int32,
    )
    return v, f


def render_overlay(
    image: np.ndarray,
    cam: Camera,
    T_cw: np.ndarray,
    plane: Plane,
    model=None,
    anchor_uv=None,
    color=(0, 255, 0),
):
    """Draw a model anchored to the plane into the image (RGB uint8 out).

    anchor_uv: optional pixel location whose plane intersection anchors the
    model (reference: ViewAR places cubes at clicked points)."""
    import cv2

    verts, faces = model if model is not None else cube_model(
        0.15 * max(abs(plane.d), 0.5)
    )
    T_anchor = plane.T_pw.copy()
    if anchor_uv is not None:
        # ray-plane intersection for the anchor
        from ..cameras import unproject_np

        T_wc = np.linalg.inv(
            np.vstack([np.hstack([T_cw[:3, :3], T_cw[:3, 3:4]]), [[0, 0, 0, 1]]])
        )
        ray_c = unproject_np(cam, np.asarray([anchor_uv], np.float32))[0]
        ray_w = T_wc[:3, :3] @ ray_c
        o = T_wc[:3, 3]
        denom = plane.normal @ ray_w
        if abs(denom) > 1e-9:
            t = -(plane.normal @ o + plane.d) / denom
            if t > 0:
                T_anchor[:3, 3] = o + t * ray_w
    vw = verts @ T_anchor[:3, :3].T + T_anchor[:3, 3]
    pc = vw @ T_cw[:3, :3].T + T_cw[:3, 3]
    uv = project_np(cam, pc)
    out = np.ascontiguousarray(
        np.stack([image] * 3, axis=-1).astype(np.uint8)
        if image.ndim == 2
        else image.astype(np.uint8)
    )
    # painter's algorithm: draw far faces first
    depth = pc[:, 2][faces].mean(axis=1)
    vis = (pc[:, 2][faces] > 0.05).all(axis=1)
    for fi in np.argsort(-depth):
        if not vis[fi]:
            continue
        tri = uv[faces[fi]].astype(np.int32)
        shade = 0.4 + 0.6 * (fi % 3) / 2.0
        col = tuple(int(c * shade) for c in color)
        cv2.fillConvexPoly(out, tri, col)
        cv2.polylines(out, [tri], True, (0, 0, 0), 1)
    return out
