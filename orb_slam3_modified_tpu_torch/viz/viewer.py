"""Offline map and trajectory plots.

Port of orb_slam3_modified_tpu/viz/viewer.py (keyframe_centers, plot_map,
draw_frame; :17-95), the headless counterpart of the Pangolin viewer
(src/Viewer.cc, src/MapDrawer.cc DrawMapPoints / DrawKeyFrames, :135
region): map points, keyframe centres, covisibility edges and the
trajectory, drawn to an image file with matplotlib (imported only there).
"""
from __future__ import annotations

import numpy as np

from ..slam_map.map_state import MapState


def keyframe_centers(m: MapState, all_maps=False):
    kfs = m.keyframe_indices(all_maps)
    R = m.kf_R[kfs]
    t = m.kf_t[kfs]
    return kfs, -np.einsum("kji,kj->ki", R, t)


def plot_map(
    m: MapState,
    trajectory=None,
    path: str = "map.png",
    show_covisibility: bool = True,
    title: str = "",
):
    """Render a top-down (x-z) + 3D view of the map to an image file."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(14, 7))
    ax3 = fig.add_subplot(1, 2, 1, projection="3d")
    ax2 = fig.add_subplot(1, 2, 2)

    mps = m.point_indices()
    pts = m.mp_pos[mps]
    kfs, centers = keyframe_centers(m)

    for ax, proj in ((ax3, None), (ax2, "xy")):
        if proj is None:
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], s=0.5, c="k", alpha=0.3)
            ax.scatter(centers[:, 0], centers[:, 1], centers[:, 2], s=12, c="b")
        else:
            ax.scatter(pts[:, 0], pts[:, 1], s=0.5, c="k", alpha=0.3)
            ax.scatter(centers[:, 0], centers[:, 1], s=12, c="b", label="keyframes")
    if show_covisibility and len(kfs) > 1:
        for i, k in enumerate(kfs):
            w = m.covisibility_weights(int(k))
            for j in np.flatnonzero(w >= 100):
                jj = np.where(kfs == j)[0]
                if len(jj) and jj[0] > i:
                    ax2.plot(
                        [centers[i, 0], centers[jj[0], 0]],
                        [centers[i, 1], centers[jj[0], 1]],
                        "g-", lw=0.4, alpha=0.5,
                    )
    if trajectory is not None and len(trajectory):
        traj = np.asarray(
            [np.linalg.inv(T)[:3, 3] for T in trajectory if T is not None]
        )
        if len(traj):
            ax2.plot(traj[:, 0], traj[:, 1], "r-", lw=1, label="trajectory")
    ax2.legend(loc="best")
    ax2.set_aspect("equal")
    fig.suptitle(title or f"{len(kfs)} keyframes, {len(mps)} points")
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path


def draw_frame(image, uv, valid, matched=None, path: str = "frame.png"):
    """Current-frame overlay (reference: FrameDrawer::DrawFrame)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 6))
    ax.imshow(np.asarray(image), cmap="gray")
    uv = np.asarray(uv)
    valid = np.asarray(valid)
    ax.scatter(uv[valid, 0], uv[valid, 1], s=6, facecolors="none", edgecolors="lime")
    if matched is not None:
        mm = np.asarray(matched) & valid
        ax.scatter(uv[mm, 0], uv[mm, 1], s=6, c="red")
    ax.set_axis_off()
    fig.savefig(path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return path
