"""Dense / semi-dense point clouds and semantic colouring.

Port of orb_slam3_modified_tpu/recon/cloud.py (sparse_cloud,
backproject_depth, voxel_filter, semantic_cloud, save_ply, load_colormap;
:22-120), the fork's CloudPoint module (src/CloudPoint.cc: voxel-filtered
accumulation, the mono_cloudpoint / mono_semantic mains, README.md:247-267)
and its semantic path (depth + segmentation maps colour the points). Host
numpy over the port's MapState and cameras; depth and segmentation are
plug-in callables (image -> map), such as models/depth.py's make_depth_fn
and make_seg_fn.
"""
from __future__ import annotations

import numpy as np

from ..cameras import Camera, unproject_np
from ..slam_map.map_state import MapState


def sparse_cloud(m: MapState, all_maps=False):
    """(N, 3) positions of live map points."""
    return m.mp_pos[m.point_indices(all_maps)]


def backproject_depth(
    cam: Camera, depth: np.ndarray, T_cw: np.ndarray, stride: int = 4,
    max_depth: float = 30.0,
):
    """Dense backprojection of a depth map into world points.

    Reference: mono_depth_seg/mono_semantic combine per-frame predicted depth
    with the SLAM pose the same way (README.md:247-267).
    """
    h, w = depth.shape
    ys, xs = np.mgrid[0:h:stride, 0:w:stride]
    d = depth[ys, xs]
    ok = (d > 0.05) & (d < max_depth)
    uv = np.stack([xs[ok], ys[ok]], axis=-1).astype(np.float32)
    rays = unproject_np(cam, uv)
    rays = rays / rays[:, 2:3]
    pc = rays * d[ok][:, None]
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    pw = (pc - t) @ R  # R^T (pc - t)
    return pw, uv


def voxel_filter(points: np.ndarray, voxel: float = 0.05, colors=None):
    """Voxel-grid downsample (reference uses PCL VoxelGrid)."""
    if len(points) == 0:
        return (points, colors) if colors is not None else points
    keys = np.floor(points / voxel).astype(np.int64)
    _, idx = np.unique(keys, axis=0, return_index=True)
    if colors is not None:
        return points[idx], colors[idx]
    return points[idx]


def semantic_cloud(
    cam: Camera,
    frames,  # iterable of (image, T_cw 4x4)
    depth_fn,  # image -> (H, W) metric depth
    seg_fn=None,  # image -> (H, W) class ids
    colormap=None,  # (C, 3) uint8 per-class colors
    stride: int = 4,
    voxel: float = 0.05,
):
    """Build a colored semantic cloud from posed frames.

    Reference flow: mono_semantic = SLAM pose + ZoeDepth depth + OneFormer
    segmentation -> colored cloud with color_map_cityescape.txt.
    """
    pts_all, col_all = [], []
    for image, T_cw in frames:
        depth = np.asarray(depth_fn(image))
        pw, uv = backproject_depth(cam, depth, T_cw, stride)
        if seg_fn is not None and colormap is not None:
            seg = np.asarray(seg_fn(image))
            cls = seg[uv[:, 1].astype(int), uv[:, 0].astype(int)]
            col = colormap[np.clip(cls, 0, len(colormap) - 1)]
        else:
            g = image[uv[:, 1].astype(int), uv[:, 0].astype(int)]
            col = np.stack([g, g, g], axis=-1).astype(np.uint8)
        pts_all.append(pw)
        col_all.append(col)
    pts = np.concatenate(pts_all)
    cols = np.concatenate(col_all)
    return voxel_filter(pts, voxel, cols)


def save_ply(path: str, points: np.ndarray, colors=None):
    """ASCII PLY export (the PCL-free equivalent of the reference's cloud
    output)."""
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            )
        f.write("end_header\n")
        for i in range(n):
            row = f"{points[i, 0]:.4f} {points[i, 1]:.4f} {points[i, 2]:.4f}"
            if colors is not None:
                row += f" {int(colors[i, 0])} {int(colors[i, 1])} {int(colors[i, 2])}"
            f.write(row + "\n")


def load_colormap(path: str):
    """Load a class-color table like the fork's color_map_cityescape.txt."""
    rows = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) >= 3:
                rows.append([int(x) for x in p[-3:]])
    return np.array(rows, np.uint8)
