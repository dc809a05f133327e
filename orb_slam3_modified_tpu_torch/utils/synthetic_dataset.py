"""Rendered synthetic frames: a textured plane under a known trajectory.

Numpy port of camera_rays, render_textured_scene,
render_textured_scene_with_depth, orbit_state and write_euroc_sequence
(:137-290) from orb_slam3_modified_tpu/utils/synthetic_dataset.py, with
in-memory renderings of write_euroc_sequence's cam0, cam1 (the right image
of a rectified pair), depth and IMU streams beside it.

write_euroc_sequence writes its PNGs through io/png.py. Its CSVs, IMU
samples and ground truth equal the reference's; its images may differ by
rounding, since make_texture upsamples with torch's bicubic and the
reference with cv2.resize(INTER_CUBIC): the two textures differ by at most
7.6e-5 grey levels (seeds 0-2), and a 30-frame stereo sequence's images
differ in 8.0e-6 (512x384) and 8.3e-6 (752x480) of their pixels, by 1 grey
level each; tests/test_torch_io.py holds at most 1e-4 of them, by at most 1.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from ..cameras import unproject, unproject_np
from ..lie.se3 import SE3
from ..tracking.fused import MapCache


def make_texture(seed: int = 0, small: int = 96, size: int = 1024) -> np.ndarray:
    """(size, size) float32 texture: seeded uniform noise at small x small,
    upsampled bicubically (the scene bench.py renders, without cv2)."""
    rng = np.random.default_rng(seed)
    tex = torch.from_numpy(rng.uniform(0, 255, (small, small)).astype(np.float32))
    up = F.interpolate(tex[None, None], size=(size, size), mode="bicubic", align_corners=False)
    return up[0, 0].numpy()


def seed_map_cache(cam, feats, T_cw, plane_z: float, cap: int) -> MapCache:
    """A map cache from keyframes of a rendered plane: each valid feature of
    feats (K, N) is back-projected through its keyframe's true pose T_cw (K)
    onto the plane z = plane_z; the first `cap` points are kept, the rest of
    the cache is invalid padding. Built on the features' device."""
    dev = feats.uv.device
    R = T_cw.R.to(dev)
    t = T_cw.t.to(dev)
    rays = unproject(cam, feats.uv)  # (K, N, 3) camera frame, z = 1
    d = torch.matmul(rays, R)  # world directions: R^T ray
    c = -torch.matmul(R.transpose(-1, -2), t[..., None])[..., 0]  # (K, 3)
    s = (plane_z - c[:, None, 2]) / d[..., 2]
    pos = c[:, None, :] + s[..., None] * d
    keep = (feats.valid & (s > 0)).reshape(-1)
    pos = pos.reshape(-1, 3)[keep][:cap]
    desc = feats.desc.reshape(-1, feats.desc.shape[-1])[keep][:cap]
    n = pos.shape[0]
    cache = MapCache(
        pos=torch.zeros((cap, 3), dtype=torch.float32, device=dev),
        desc=torch.zeros((cap, desc.shape[-1]), dtype=torch.int32, device=dev),
        valid=torch.zeros(cap, dtype=torch.bool, device=dev),
        mp_id=torch.full((cap,), -1, dtype=torch.int32, device=dev),
    )
    cache.pos[:n] = pos
    cache.desc[:n] = desc
    cache.valid[:n] = True
    cache.mp_id[:n] = torch.arange(n, dtype=torch.int32, device=dev)
    return cache


def camera_rays(cam):
    """(H*W, 3) unit-plane rays for every pixel (constant per camera)."""
    ys, xs = np.mgrid[0 : cam.height, 0 : cam.width]
    uv = np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.float32)
    return unproject_np(cam, uv)


def render_textured_scene(
    T_cw: np.ndarray,  # (4, 4) world->cam
    cam,
    texture: np.ndarray,  # (TH, TW) float32 texture on the z=plane_z plane
    plane_z: float = 6.0,
    plane_half: float = 12.0,
    rays_c: np.ndarray = None,  # optional precomputed camera_rays(cam)
):
    """Render a textured plane by inverse warping (plane z=plane_z in world;
    texture mapped over [-half, half]^2; background 20)."""
    h, w = cam.height, cam.width
    if rays_c is None:
        rays_c = camera_rays(cam)
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    c = -R.T @ t  # camera center
    d = rays_c @ R  # (N, 3) world dirs
    denom = d[:, 2]
    denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
    s = (plane_z - c[2]) / denom
    pw = c[None] + s[:, None] * d
    valid = (s > 0.1) & (np.abs(pw[:, 0]) < plane_half) & (np.abs(pw[:, 1]) < plane_half)
    th, tw = texture.shape
    pw = np.nan_to_num(pw)  # invalid rays are masked by `valid` below
    tx = ((pw[:, 0] + plane_half) / (2 * plane_half) * (tw - 1)).astype(np.int32)
    ty = ((pw[:, 1] + plane_half) / (2 * plane_half) * (th - 1)).astype(np.int32)
    tx = np.clip(tx, 0, tw - 1)
    ty = np.clip(ty, 0, th - 1)
    img = np.where(valid, texture[ty, tx], 20.0)
    return img.reshape(h, w).astype(np.float32)


def render_textured_scene_with_depth(T_cw, cam, texture, plane_z: float = 6.0,
                                     plane_half: float = 12.0, rays_c=None):
    """render_textured_scene plus the exact per-pixel camera depth (z in the
    camera frame, 0 where the ray misses the plane) and the surface mask:
    (img (H, W) float32, depth (H, W) float32, valid (H, W) bool)."""
    h, w = cam.height, cam.width
    if rays_c is None:
        rays_c = camera_rays(cam)
    R = T_cw[:3, :3]
    t = T_cw[:3, 3]
    c = -R.T @ t
    d = rays_c @ R
    denom = d[:, 2]
    denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
    s = (plane_z - c[2]) / denom
    pw = c[None] + s[:, None] * d
    valid = (s > 0.1) & (np.abs(pw[:, 0]) < plane_half) & (np.abs(pw[:, 1]) < plane_half)
    th, tw = texture.shape
    pw = np.nan_to_num(pw)
    tx = ((pw[:, 0] + plane_half) / (2 * plane_half) * (tw - 1)).astype(np.int32)
    ty = ((pw[:, 1] + plane_half) / (2 * plane_half) * (th - 1)).astype(np.int32)
    tx = np.clip(tx, 0, tw - 1)
    ty = np.clip(ty, 0, th - 1)
    img = np.where(valid, texture[ty, tx], 20.0)
    depth = np.where(valid, s, 0.0)  # the rays have z = 1, so the depth is s
    return (img.reshape(h, w).astype(np.float32), depth.reshape(h, w).astype(np.float32),
            valid.reshape(h, w))


def _matrices(T_cw):
    """(4, 4) float64 world -> camera matrices of the poses T_cw (SE3 of CPU tensors)."""
    for R, t in zip(T_cw.R.numpy(), T_cw.t.numpy()):
        T = np.eye(4)
        T[:3, :3] = R
        T[:3, 3] = t
        yield T


def _u8(img):
    return np.clip(img, 0, 255).astype(np.uint8)


def render_sequence(cam, T_cw, texture, plane_z: float = 2.0, plane_half: float = 10.0):
    """(F, H, W) uint8 frames of the textured plane seen from the poses T_cw
    (SE3 of F CPU tensors), as bench.py renders its headline scene."""
    rays = camera_rays(cam)
    return np.stack([_u8(render_textured_scene(T, cam, texture, plane_z, plane_half, rays))
                     for T in _matrices(T_cw)])


def render_stereo_sequence(cam, T_cw, texture, baseline: float, plane_z: float = 2.0,
                           plane_half: float = 10.0):
    """A rectified pair per pose: (left, right) (F, H, W) uint8, the right
    camera displaced by +baseline along the left camera's x axis
    (p_right = p_left - baseline * e_x), as write_euroc_sequence renders cam1."""
    rays = camera_rays(cam)
    T_rl = np.eye(4)
    T_rl[0, 3] = -baseline
    left, right = [], []
    for T in _matrices(T_cw):
        left.append(_u8(render_textured_scene(T, cam, texture, plane_z, plane_half, rays)))
        right.append(_u8(render_textured_scene(T_rl @ T, cam, texture, plane_z, plane_half, rays)))
    return np.stack(left), np.stack(right)


def render_rgbd_sequence(cam, T_cw, texture, plane_z: float = 2.0, plane_half: float = 10.0):
    """(frames (F, H, W) uint8, depth (F, H, W) float32 metric camera depth,
    0 where no surface) for the poses T_cw."""
    rays = camera_rays(cam)
    frames, depths = [], []
    for T in _matrices(T_cw):
        img, depth, _ = render_textured_scene_with_depth(T, cam, texture, plane_z, plane_half,
                                                         rays)
        frames.append(_u8(img))
        depths.append(depth)
    return np.stack(frames), np.stack(depths)


def orbit_state(t: float, period: float, radius: float, sweep: float,
                height: float = 0.4, ring: bool = False, ring_z: float = -4.0):
    """Analytic camera state at time t, looking at the origin (plane z = +2
    beyond it).

    - arc (default): the camera on an arc in the x-z plane (as
      utils/synthetic.py::orbit_trajectory);
    - ring: the camera on a horizontal circle at z = ring_z, bobbing
      vertically, so the plane stays at a near-constant distance over a full
      revolution: a loop-closure sequence.

    Returns (R_cw (3, 3), p_w (3,), v_w (3,), a_w (3,)): camera-from-world
    rotation, camera centre, velocity and acceleration (world frame)."""
    a = sweep * t / period
    da = sweep / period
    sa, ca = np.sin(a), np.cos(a)
    if ring:
        s3, c3 = np.sin(3 * a), np.cos(3 * a)
        p = np.array([radius * sa, radius * ca, ring_z + height * (1 - c3)])
        v = np.array([radius * ca, -radius * sa, 3 * height * s3]) * da
        acc = np.array([-radius * sa, -radius * ca, 9 * height * c3]) * da**2
    else:
        p = np.array([radius * sa, height * np.sin(3 * a), -radius * ca])
        v = np.array([radius * ca, 3 * height * np.cos(3 * a), radius * sa]) * da
        acc = np.array([-radius * sa, -9 * height * np.sin(3 * a), radius * ca]) * da**2
    fwd = -p / np.linalg.norm(p)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    R_wc = np.stack([right, up2, fwd], axis=1)
    return R_wc.T, p, v, acc


def ring_trajectory(n_frames: int, fps: float = 20.0, radius: float = 4.0, height: float = 0.4,
                    revolutions: float = 1.0):
    """bench.py's ring scene (render_ring_sequence): `revolutions` full
    revolutions (bench.py: one) of orbit_state(ring=True) in n_frames frames
    at fps; SE3 (F,) of float32 CPU tensors."""
    period = n_frames / fps
    Rs, ts = [], []
    for i in range(n_frames):
        R_cw, p, _, _ = orbit_state(i / fps, period, radius, 2 * np.pi * revolutions,
                                    height=height, ring=True)
        Rs.append(R_cw)
        ts.append(-R_cw @ p)
    return SE3(torch.from_numpy(np.stack(Rs).astype(np.float32)),
               torch.from_numpy(np.stack(ts).astype(np.float32)))


def orbit_poses(n_frames: int, fps: float = 20.0, radius: float = 3.0, sweep: float = np.pi / 4,
                height: float = 0.4, ring: bool = False):
    """The camera poses of write_euroc_sequence's frames: frame i at t = i /
    fps on orbit_state(period = n_frames / fps); SE3 (F,) of float32 CPU
    tensors."""
    period = n_frames / fps
    Rs, ts = [], []
    for i in range(n_frames):
        R_cw, p, _, _ = orbit_state(i / fps, period, radius, sweep, height, ring)
        Rs.append(R_cw)
        ts.append(-R_cw @ p)
    return SE3(torch.from_numpy(np.stack(Rs).astype(np.float32)),
               torch.from_numpy(np.stack(ts).astype(np.float32)))


def imu_stream(n_frames: int, fps: float = 20.0, seed: int = 0, radius: float = 3.0,
               sweep: float = np.pi / 4, height: float = 0.4, imu_rate: float = 200.0,
               ring: bool = False, T_bc=None, gyro_noise_std: float = 0.0,
               acc_noise_std: float = 0.0, gyro_bias=(0.0, 0.0, 0.0), acc_bias=(0.0, 0.0, 0.0)):
    """The body-frame IMU stream that write_euroc_sequence(with_imu=True)
    writes to mav0/imu0/data.csv, in memory: (ts (S,) float64 seconds, gyro
    (S, 3), acc (S, 3)) float64, from the same finite differences of the
    orbit (gravity -9.81 z), the rig extrinsics T_bc (x_b = R_bc x_c + t_bc,
    lever arm included; None = identity), white noise and constant biases.
    The CSV stores nanosecond timestamps and 9 decimals; these are the
    unrounded values."""
    period = n_frames / fps
    g_w = np.array([0.0, 0.0, -9.81])
    R_bc = np.eye(3) if T_bc is None else np.asarray(T_bc, np.float64)[:3, :3]
    t_bc = np.zeros(3) if T_bc is None else np.asarray(T_bc, np.float64)[:3, 3]
    t_cb = -R_bc.T @ t_bc  # body origin in the camera frame
    b_g = np.asarray(gyro_bias, np.float64)
    b_a = np.asarray(acc_bias, np.float64)
    noise_rng = np.random.default_rng(seed + 7919)
    dt_fd = 1e-4  # finite-difference step (rotation rate, lever arm)

    def body_pos(tau):
        R_cw, p_c, _, _ = orbit_state(tau, period, radius, sweep, height, ring)
        return p_c + R_cw.T @ t_cb, R_cw

    n_samples = int((n_frames - 1) / fps * imu_rate) + 1
    ts = np.empty(n_samples)
    gyro = np.empty((n_samples, 3))
    acc = np.empty((n_samples, 3))
    for j in range(n_samples):
        tau = j / imu_rate
        p_b, R_cw = body_pos(tau)
        p_bp, _ = body_pos(tau + dt_fd)
        p_bm, _ = body_pos(tau - dt_fd)
        a_b_w = (p_bp - 2 * p_b + p_bm) / (dt_fd * dt_fd)
        R_cw2, _, _, _ = orbit_state(tau + dt_fd, period, radius, sweep, height, ring)
        dR = R_cw @ R_cw2.T
        w_c = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) / (
            2.0 * dt_fd)
        f_b = R_bc @ R_cw @ (a_b_w - g_w)  # specific force in the body frame
        ts[j] = tau
        gyro[j] = R_bc @ w_c + b_g + noise_rng.normal(0.0, gyro_noise_std, 3)
        acc[j] = f_b + b_a + noise_rng.normal(0.0, acc_noise_std, 3)
    return ts, gyro, acc


def imu_between(ts, gyro, acc, t0, t1):
    """The samples of an imu_stream in (t0, t1] as the tracker takes them:
    (acc (N, 3), gyro (N, 3), dts (N,)) float32, dts measured from the
    previous sample (from t0 for the first), as the EuRoC reader and
    bench.py's imu_tuple hand them over. t0 None (the first frame): every
    sample up to t1, the first with dt 0."""
    if t0 is None:
        sel = ts <= t1 + 1e-9
        t0 = ts[sel][0] if sel.any() else t1
    else:
        sel = (ts > t0 + 1e-9) & (ts <= t1 + 1e-9)
    tss = ts[sel]
    dts = np.maximum(np.diff(np.concatenate([[t0], tss])), 0.0)
    return (acc[sel].astype(np.float32), gyro[sel].astype(np.float32), dts.astype(np.float32))


def write_euroc_images(cam_dir: str, t_ns, images) -> None:
    """One EuRoC camera stream: cam_dir/data/<t_ns>.png (io/png.py) for each
    image (uint8 grey or uint16 depth) and cam_dir/data.csv."""
    from ..io.png import write_png

    os.makedirs(os.path.join(cam_dir, "data"), exist_ok=True)
    lines = ["#timestamp [ns],filename"]
    for t, img in zip(t_ns, images):
        write_png(os.path.join(cam_dir, "data", f"{t}.png"), img)
        lines.append(f"{t},{t}.png")
    with open(os.path.join(cam_dir, "data.csv"), "w") as f:
        f.write("\n".join(lines) + "\n")


def write_euroc_sequence(
    out_dir: str,
    cam,
    n_frames: int = 30,
    fps: float = 20.0,
    seed: int = 0,
    radius: float = 3.0,
    sweep: float = np.pi / 4,
    height: float = 0.4,
    stereo_baseline: float = 0.0,
    with_imu: bool = False,
    imu_rate: float = 200.0,
    closed_loop: bool = False,
    T_bc: np.ndarray = None,  # (4,4) camera->body extrinsics; None = identity
    gyro_noise_std: float = 0.0,  # rad/s per-sample white noise
    acc_noise_std: float = 0.0,  # m/s^2 per-sample white noise
    gyro_bias=(0.0, 0.0, 0.0),  # constant true bias (rad/s)
    acc_bias=(0.0, 0.0, 0.0),  # constant true bias (m/s^2)
    with_depth: bool = False,  # write mav0/depth0/data/<ns>.png (uint16 mm)
    texture: np.ndarray = None,  # (TH, TW) float32 override scene texture
):
    """Render an orbit over a textured plane into EuRoC layout
    (mav0/cam0/data.csv + data/*.png; mav0/cam1 with stereo_baseline > 0,
    the right camera displaced by +baseline along the left camera's x axis;
    mav0/depth0 with uint16 millimetre depth maps; mav0/imu0/data.csv, gyro
    then acc columns, from imu_stream): the surface the example mains read
    (mono_inertial_euroc.cc LoadImages / LoadIMU). closed_loop=True sweeps
    a full revolution of the ring. Returns the ground-truth T_cw (4, 4) of
    cam0's frames."""
    ring = closed_loop
    if closed_loop:
        sweep = 2 * np.pi
    if texture is None:
        texture = make_texture(seed, 96, 1024)
    period = n_frames / fps  # full sweep duration; frame i at i/fps
    rays = camera_rays(cam)
    T_rl = np.eye(4)
    T_rl[0, 3] = -stereo_baseline  # p_right = p_left - b*ex
    t_ns, gts, left, right, depths = [], [], [], [], []
    for i in range(n_frames):
        R_cw, p, _, _ = orbit_state(i / fps, period, radius, sweep, height, ring)
        T = np.eye(4)
        T[:3, :3] = R_cw
        T[:3, 3] = -R_cw @ p
        t_ns.append(int(round(i / fps * 1e9)))
        gts.append(T)
        if with_depth:
            img, depth, _ = render_textured_scene_with_depth(T, cam, texture, plane_z=2.0,
                                                             plane_half=10.0, rays_c=rays)
            depths.append(np.clip(depth * 1000.0, 0, 65535).astype(np.uint16))
        else:
            img = render_textured_scene(T, cam, texture, plane_z=2.0, plane_half=10.0,
                                        rays_c=rays)
        left.append(img.astype(np.uint8))  # as the reference casts: no clip
        if stereo_baseline > 0:
            right.append(render_textured_scene(T_rl @ T, cam, texture, plane_z=2.0,
                                               plane_half=10.0, rays_c=rays).astype(np.uint8))
    mav = os.path.join(out_dir, "mav0")
    write_euroc_images(os.path.join(mav, "cam0"), t_ns, left)
    if stereo_baseline > 0:
        write_euroc_images(os.path.join(mav, "cam1"), t_ns, right)
    if with_depth:
        write_euroc_images(os.path.join(mav, "depth0"), t_ns, depths)
    if with_imu:
        ts, gyro, acc = imu_stream(n_frames, fps, seed, radius, sweep, height, imu_rate, ring,
                                   T_bc, gyro_noise_std, acc_noise_std, gyro_bias, acc_bias)
        rows = ["#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z"]
        for tau, w, a in zip(ts, gyro, acc):
            rows.append(f"{int(round(tau * 1e9))},{w[0]:.9f},{w[1]:.9f},{w[2]:.9f},"
                        f"{a[0]:.9f},{a[1]:.9f},{a[2]:.9f}")
        os.makedirs(os.path.join(mav, "imu0"), exist_ok=True)
        with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
            f.write("\n".join(rows) + "\n")
    return gts
