"""Per-frame annotated overlay: the FrameDrawer.

Port of orb_slam3_modified_tpu/viz/frame_drawer.py (FrameDrawer,
write_overlay; :33-182), the reference's FrameDrawer (src/FrameDrawer.cc:
Update() snapshots the frame's keypoints and tracking state,
src/Tracking.cc:2138; DrawFrame() marks map-matched and unmatched keypoints
and adds a status bar with state / keyframe / map-point / match counts).
Headless: update() snapshots, render() returns an RGB uint8 image, save()
writes a PNG (cv2 where it can be imported, io/png.py otherwise). The
runner writes one with --viz-out DIR [--viz-every N], named by the frame id
the tracker assigned.
"""
from __future__ import annotations

import os

import numpy as np

_STATE_NAMES = {
    0: "NOT INITIALIZED",
    1: "OK",
    2: "RECENTLY LOST",
    3: "LOST",
}

_GREEN = np.array([0, 220, 0], np.uint8)  # tracked map point
_BLUE = np.array([80, 160, 255], np.uint8)  # extracted, not matched
_ORANGE = np.array([255, 170, 0], np.uint8)  # VO-mode temporal match


class FrameDrawer:
    """Snapshot-and-render frame overlay.

    update() is cheap (host copies of tiny arrays); render() draws markers
    with pure numpy (3x3 squares, reference-style) and the status bar with
    cv2.putText when OpenCV can be imported (without it the bar is a blank
    strip).
    """

    def __init__(self):
        self._snap = None
        self.n_drawn = 0

    # ------------------------------------------------------------- update
    def update(self, image, uv, valid, tracked, state: int,
               n_kfs: int, n_mps: int, vo_mode: bool = False,
               frame_id: int = -1):
        """Snapshot one frame (reference: FrameDrawer::Update).

        image: (H, W) grayscale uint8/float; uv (F, 2); valid (F,) extracted
        slots; tracked (F,) slots associated to a map point this frame
        (reference: mvbMap); vo_mode marks mbVO temporal tracking.
        """
        self._snap = dict(
            image=np.asarray(image),
            uv=np.asarray(uv),
            valid=np.asarray(valid, bool),
            tracked=np.asarray(tracked, bool),
            state=int(state),
            n_kfs=int(n_kfs),
            n_mps=int(n_mps),
            vo=bool(vo_mode),
            fid=int(frame_id),
        )

    def update_from_tracker(self, tracker, image=None):
        """Convenience: snapshot the tracker's last processed frame
        (FrameRecord); image defaults to a blank canvas when the caller did
        not retain the pixels (chunked mode keeps only in-flight images)."""
        from ..slam_map.map_state import NO_POINT

        rec = tracker.last
        if rec is None:
            return False
        f = rec.features
        uv = np.asarray(f.uv)
        valid = np.asarray(f.valid, bool)
        if image is None:
            h = int(tracker.cfg.cam.height)
            w = int(tracker.cfg.cam.width)
            image = np.zeros((h, w), np.uint8)
        self.update(
            image, uv, valid, np.asarray(rec.obs_mp) != NO_POINT,
            tracker.state, tracker.map.n_keyframes(), tracker.map.n_points(),
            vo_mode=getattr(tracker, "vo_mode", False),
            frame_id=rec.frame_id,
        )
        return True

    # ------------------------------------------------------------- render
    def render(self) -> np.ndarray:
        """(H + bar, W, 3) uint8 annotated frame (FrameDrawer::DrawFrame)."""
        if self._snap is None:
            raise RuntimeError("FrameDrawer.render before update")
        s = self._snap
        img = s["image"]
        if img.ndim == 2:
            rgb = np.repeat(
                np.clip(img, 0, 255).astype(np.uint8)[..., None], 3, axis=-1
            )
        else:
            rgb = np.clip(img, 0, 255).astype(np.uint8).copy()
        h, w = rgb.shape[:2]
        uv = s["uv"]
        valid = s["valid"]
        tracked = s["tracked"] & valid
        untracked = valid & ~tracked
        color = _ORANGE if s["vo"] else _GREEN
        self._mark(rgb, uv[untracked], _BLUE, w, h, hollow=True)
        self._mark(rgb, uv[tracked], color, w, h, hollow=False)
        bar = self._status_bar(w, s, int(tracked.sum()))
        self.n_drawn += 1
        return np.concatenate([rgb, bar], axis=0)

    @staticmethod
    def _mark(rgb, uv, color, w, h, hollow: bool):
        """Reference-style square markers, vectorized: a (2r+1)^2 stamp per
        keypoint via flat-index scatter (no per-point Python loop)."""
        if len(uv) == 0:
            return
        r = 2
        x = np.clip(np.round(uv[:, 0]).astype(int), r, w - 1 - r)
        y = np.clip(np.round(uv[:, 1]).astype(int), r, h - 1 - r)
        dy, dx = np.mgrid[-r: r + 1, -r: r + 1]
        if hollow:
            edge = (np.abs(dy) == r) | (np.abs(dx) == r)
            dy, dx = dy[edge], dx[edge]
        else:
            dy, dx = dy.ravel(), dx.ravel()
        yy = (y[:, None] + dy[None]).ravel()
        xx = (x[:, None] + dx[None]).ravel()
        rgb[yy, xx] = color

    @staticmethod
    def _status_bar(w, s, n_matches):
        bar_h = 22
        bar = np.zeros((bar_h, w, 3), np.uint8)
        state = _STATE_NAMES.get(s["state"], "?")
        if s["vo"] and s["state"] == 1:
            state = "OK (VO)"  # mbVO odometry, reference DrawTextInfo analog
        text = (
            f"{state} | frame {s['fid']} | KFs: {s['n_kfs']} "
            f"MPs: {s['n_mps']} matches: {n_matches}"
        )
        try:
            import cv2
        except ImportError:
            return bar  # blank strip without OpenCV; markers still drawn
        cv2.putText(bar, text, (6, 15), cv2.FONT_HERSHEY_SIMPLEX, 0.42, (255, 255, 255), 1,
                    cv2.LINE_AA)
        return bar

    def save(self, path: str) -> str:
        out = self.render()
        try:
            import cv2
        except ImportError:
            from ..io.png import write_png

            write_png(path, out)
        else:
            cv2.imwrite(path, out[..., ::-1])  # RGB -> BGR
        return path


def write_overlay(dirpath: str, tracker, image=None, drawer=None) -> str:
    """One-call helper for the runner: snapshot tracker state + save
    overlay PNG named by frame id."""
    d = drawer or FrameDrawer()
    if not d.update_from_tracker(tracker, image):
        return ""
    os.makedirs(dirpath, exist_ok=True)
    path = os.path.join(dirpath, f"frame_{d._snap['fid']:06d}.png")
    return d.save(path)
