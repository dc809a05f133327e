"""Radial-tangential distortion, keypoint undistortion, stereo rectification.

Port of orb_slam3_modified_tpu/cameras/rectify.py (Frame::UndistortKeyPoints,
src/Frame.cc:746; the Settings rectification maps, include/Settings.h:44-121,
src/Settings.cc precomputeRectificationMaps):

- `undistort_points`: cv::undistortPoints' fixed-point iteration, numpy,
  for keypoint sets and startup precompute;
- `make_keypoint_undistorter`: the same iteration on tensors, applied to the
  extracted keypoints on the device (descriptors stay on the raw image);
- `stereo_rectify` (Bouguet, cv::stereoRectify with CALIB_ZERO_DISPARITY)
  and `init_undistort_rectify_map`: numpy, once at startup;
- `remap_bilinear`: cv::remap(INTER_LINEAR, BORDER_CONSTANT 0) on tensors,
  a gather of four neighbours and a lerp, on the images' device.

Legacy EuRoC configs carry LEFT./RIGHT. K, D, R, P directly
(src/Tracking.cc:621): `build_rectification_legacy` takes them as they are.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _radtan(dist):
    d = [float(v) for v in np.asarray(dist).ravel()[:5]] + [0.0] * 5
    return d[0], d[1], d[2], d[3], d[4]


def _stack(xs, like):
    return torch.stack(xs, dim=-1) if isinstance(like, torch.Tensor) else np.stack(xs, axis=-1)


def radtan_distort_normalized(xy, dist):
    """(k1, k2, p1, p2[, k3]) applied to normalized coordinates xy (..., 2),
    numpy or torch."""
    k1, k2, p1, p2, k3 = _radtan(dist)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return _stack([xd, yd], xy)


def _undistort_normalized(xy_dist, dist, iters):
    """Fixed-point inversion of the radtan model (cv::undistortPoints' loop),
    numpy or torch."""
    k1, k2, p1, p2, k3 = _radtan(dist)
    x0, y0 = xy_dist[..., 0], xy_dist[..., 1]
    x, y = x0, y0
    for _ in range(iters):
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    return _stack([x, y], xy_dist)


def undistort_points(pts_px, K, dist, R=None, P=None, iters=40):
    """cv::undistortPoints: pixels (..., 2) under K (3, 3) with radtan `dist`
    -> normalized coordinates, rotated by R (3, 3) if given, re-projected by
    P (3, 3 or 3, 4) to pixels if given. Numpy, float64."""
    K = np.asarray(K, np.float64)
    pts = np.asarray(pts_px, np.float64)
    xn = (pts[..., 0] - K[0, 2]) / K[0, 0]
    yn = (pts[..., 1] - K[1, 2]) / K[1, 1]
    xy = _undistort_normalized(np.stack([xn, yn], -1), dist, iters)
    if R is not None:
        v = np.stack([xy[..., 0], xy[..., 1], np.ones_like(xy[..., 0])], -1)
        v = v @ np.asarray(R, np.float64).T
        xy = v[..., :2] / v[..., 2:3]
    if P is not None:
        P = np.asarray(P, np.float64)
        out = np.empty_like(xy)
        out[..., 0] = P[0, 0] * xy[..., 0] + P[0, 2]
        out[..., 1] = P[1, 1] * xy[..., 1] + P[1, 2]
        return out
    return xy


def make_keypoint_undistorter(K, dist, iters=8):
    """Keypoint undistortion on the keypoints' device: pixels -> undistorted
    pixels under the same K, as Frame::UndistortKeyPoints. Returns a
    function of (..., 2) float32 uv tensors; padded (invalid) slots pass
    through harmlessly, the iteration is total."""
    K = np.asarray(K, np.float64)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    d = tuple(float(v) for v in np.asarray(dist).ravel()[:5])

    def undistort(uv):
        xn = (uv[..., 0] - cx) / fx
        yn = (uv[..., 1] - cy) / fy
        xy = _undistort_normalized(torch.stack([xn, yn], -1), d, iters)
        return torch.stack([xy[..., 0] * fx + cx, xy[..., 1] * fy + cy], -1).to(uv.dtype)

    return undistort


def _rodrigues_vec(R):
    """Rotation matrix -> rotation vector."""
    R = np.asarray(R, np.float64)
    theta = np.arccos(np.clip((np.trace(R) - 1.0) * 0.5, -1.0, 1.0))
    if theta < 1e-12:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * (theta / (2.0 * np.sin(theta)))


def _rodrigues_mat(w):
    """Rotation vector -> matrix."""
    w = np.asarray(w, np.float64)
    theta = np.linalg.norm(w)
    if theta < 1e-12:
        return np.eye(3)
    k = w / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def stereo_rectify(K1, D1, K2, D2, image_size, R, t):
    """Bouguet rectification (cv::stereoRectify, CALIB_ZERO_DISPARITY,
    alpha < 0). R, t map camera-1 points to camera 2 (x2 = R x1 + t).
    Returns (R1, R2, P1, P2, Q): the rectifying rotations, the new 3x4
    projections sharing one focal length and principal point, and the
    disparity-to-depth matrix."""
    K1 = np.asarray(K1, np.float64)
    K2 = np.asarray(K2, np.float64)
    t = np.asarray(t, np.float64).ravel()
    nx, ny = int(image_size[0]), int(image_size[1])
    # split the relative rotation evenly between the two cameras
    r_r = _rodrigues_mat(-0.5 * _rodrigues_vec(R))
    t_half = r_r @ t
    idx = 0 if abs(t_half[0]) > abs(t_half[1]) else 1
    c = t_half[idx]
    nt = np.linalg.norm(t_half)
    uu = np.zeros(3)
    uu[idx] = 1.0 if c > 0 else -1.0
    # the rotation that puts the halved baseline on the image x (or y) axis
    ww = np.cross(t_half, uu)
    nw = np.linalg.norm(ww)
    if nw > 0:
        ww *= np.arccos(np.clip(abs(c) / nt, -1.0, 1.0)) / nw
    wR = _rodrigues_mat(ww)
    R1 = wR @ r_r.T
    R2 = wR @ r_r
    t_new = R2 @ t
    # the new focal length: the mean of the cross-axis focals
    fc_new = 0.5 * (K1[idx ^ 1, idx ^ 1] + K2[idx ^ 1, idx ^ 1])
    # the new principal point: the image corners undistorted and rectified,
    # averaged per camera, then shared between the two
    cc_new = np.zeros((2, 2))
    corners = np.array([[0, 0], [nx - 1, 0], [0, ny - 1], [nx - 1, ny - 1]], np.float64)
    for k, (K, D, Rk) in enumerate(((K1, D1, R1), (K2, D2, R2))):
        xy = undistort_points(corners, K, D if D is not None else np.zeros(5), R=Rk)
        cc_new[k, 0] = (nx - 1) / 2.0 - fc_new * np.mean(xy[:, 0])
        cc_new[k, 1] = (ny - 1) / 2.0 - fc_new * np.mean(xy[:, 1])
    cc = cc_new.mean(axis=0)
    P1 = np.array([[fc_new, 0, cc[0], 0], [0, fc_new, cc[1], 0], [0, 0, 1, 0]])
    P2 = P1.copy()
    P2[idx, 3] = t_new[idx] * fc_new
    Q = np.array([[1, 0, 0, -cc[0]], [0, 1, 0, -cc[1]], [0, 0, 0, fc_new],
                  [0, 0, -1.0 / t_new[idx], 0]])
    return R1, R2, P1, P2, Q


def init_undistort_rectify_map(K, D, R, P, image_size):
    """cv::initUndistortRectifyMap for the radtan model: every rectified
    pixel unprojected by P, rotated back by R^-1, distorted and projected by
    K. Returns the source-pixel maps (map_x, map_y), (H, W) float32 numpy."""
    K = np.asarray(K, np.float64)
    P = np.asarray(P, np.float64)
    nx, ny = int(image_size[0]), int(image_size[1])
    u, v = np.meshgrid(np.arange(nx, dtype=np.float64), np.arange(ny, dtype=np.float64))
    x = (u - P[0, 2]) / P[0, 0]
    y = (v - P[1, 2]) / P[1, 1]
    rays = np.stack([x, y, np.ones_like(x)], axis=-1) @ np.linalg.inv(np.asarray(R, np.float64)).T
    xy = radtan_distort_normalized(np.stack([rays[..., 0] / rays[..., 2],
                                             rays[..., 1] / rays[..., 2]], -1),
                                   D if D is not None else np.zeros(5))
    map_x = (xy[..., 0] * K[0, 0] + K[0, 2]).astype(np.float32)
    map_y = (xy[..., 1] * K[1, 1] + K[1, 2]).astype(np.float32)
    return map_x, map_y


def remap_bilinear(img, map_x, map_y):
    """cv::remap(INTER_LINEAR, BORDER_CONSTANT 0) on tensors: img (H, W)
    (any real dtype) sampled at the source coordinates map_x, map_y
    (Ho, Wo); returns (Ho, Wo) float32 on img's device."""
    img = img.to(torch.float32)
    H, W = img.shape
    x0 = torch.floor(map_x)
    y0 = torch.floor(map_y)
    fx = map_x - x0
    fy = map_y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    flat = img.reshape(-1)

    def at(yy, xx):
        inb = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        val = flat[torch.clamp(yy, 0, H - 1) * W + torch.clamp(xx, 0, W - 1)]
        return torch.where(inb, val, 0.0)

    top = at(y0i, x0i) * (1 - fx) + at(y0i, x0i + 1) * fx
    bot = at(y0i + 1, x0i) * (1 - fx) + at(y0i + 1, x0i + 1) * fx
    return top * (1 - fy) + bot * fy


@dataclasses.dataclass
class StereoRectification:
    """Per-camera rectification maps and the rectified camera, built once
    (from the legacy LEFT./RIGHT. K/D/R/P blocks or from Camera1/Camera2 +
    Stereo.T_c1_c2); `remap` rectifies a pair on the images' device."""

    map_lx: np.ndarray
    map_ly: np.ndarray
    map_rx: np.ndarray
    map_ry: np.ndarray
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float  # baseline * fx of the rectified pair
    # the four maps on each device remap has run on, uploaded once
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    def remap(self, img_left: torch.Tensor, img_right: torch.Tensor):
        dev = img_left.device
        if dev not in self._on_device:
            self._on_device[dev] = [torch.as_tensor(m_).to(dev) for m_ in
                                    (self.map_lx, self.map_ly, self.map_rx, self.map_ry)]
        lx, ly, rx, ry = self._on_device[dev]
        return remap_bilinear(img_left, lx, ly), remap_bilinear(img_right, rx, ry)


def build_rectification(K1, D1, K2, D2, image_size, R, t) -> StereoRectification:
    """stereoRectify + both maps (precomputeRectificationMaps)."""
    R1, R2, P1, P2, _ = stereo_rectify(K1, D1, K2, D2, image_size, R, t)
    mlx, mly = init_undistort_rectify_map(K1, D1, R1, P1, image_size)
    mrx, mry = init_undistort_rectify_map(K2, D2, R2, P2, image_size)
    return StereoRectification(mlx, mly, mrx, mry, fx=float(P1[0, 0]), fy=float(P1[1, 1]),
                               cx=float(P1[0, 2]), cy=float(P1[1, 2]), bf=float(abs(P2[0, 3])))


def build_rectification_legacy(Kl, Dl, Rl, Pl, Kr, Dr, Rr, Pr, image_size) -> StereoRectification:
    """The legacy EuRoC config: LEFT./RIGHT. K, D, R, P given directly
    (src/Tracking.cc:621)."""
    mlx, mly = init_undistort_rectify_map(Kl, Dl, Rl, Pl, image_size)
    mrx, mry = init_undistort_rectify_map(Kr, Dr, Rr, Pr, image_size)
    Pl = np.asarray(Pl, np.float64)
    Pr = np.asarray(Pr, np.float64)
    return StereoRectification(mlx, mly, mrx, mry, fx=float(Pl[0, 0]), fy=float(Pl[1, 1]),
                               cx=float(Pl[0, 2]), cy=float(Pl[1, 2]), bf=float(abs(Pr[0, 3])))
