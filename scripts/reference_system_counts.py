"""The JAX reference on the frames of chip_smoke.py's main-path phases.

Renders the scene exactly as chip_smoke.py does (the port's
utils/synthetic_dataset.py: seeded texture upsampled by torch, 752x480
uint8), then drives the JAX package's SlamSystem(..., use_loop_closing=True)
.make_chunked_frontend(chunk, lag=1) over the frames: the first 64 as
warm-up, the async mapper drained, then the rest. Scenes:

- system: bench.py's headline scene, the 400-frame quarter orbit, chunk 16;
- loop: bench.py's ring scene (run_hard_scene), one full revolution in 400
  frames over a 2048^2 texture from a 128^2 draw, chunk 8;
- stereo: the headline scene as a rectified pair (the right camera
  displaced by the EuRoC baseline, configs/euroc_stereo.yaml's
  Stereo.T_c1_c2 x), sensor STEREO, bf = baseline * fx, min_depth 0.3,
  chunk 16;
- rgbd: the headline scene with the renderer's float32 metric depth map,
  sensor RGBD, depth_scale 1, the same bf as a virtual baseline,
  th_far_points 0, chunk 16.

Three inertial scenes run frame by frame through the per-frame entry
points (no chunked frontend), loop closing on, the staged IMU init
synchronous:

- mono_inertial: tests/test_e2e_inertial.py's course at full width (a
  752x480 EuRoC camera on a 1.5 m circle at 0.8 rad/s under a ceiling of
  5000 points, 1024 features a frame, the noise-free 200 Hz IMU), 400
  frames, 160 warm-up, the frames made by chip_smoke.py's ceiling_course;
  SlamSystem(sensor=IMU_MONOCULAR).track_features(..., imu_samples=).
  --draws k ... runs it once per draw set: the two-view initializer's key
  jax.random.fold_in(PRNGKey(frame id), k), k = 0 the reference's own;
- mono_inertial_image: bench.py's VI scene (main_vi("vi")): a 512x384
  pinhole (330, 330, 256, 192), write_euroc_sequence's quarter orbit
  (radius 4 m, sweep pi/2 over 400 frames, height 0.4) at 20 frames/s cut
  to its first 200 frames, 1024 features, and the noise-free 200 Hz IMU
  stream of write_euroc_sequence(with_imu=True) with identity extrinsics
  (the port's utils/synthetic_dataset.py::imu_stream);
  SlamSystem(sensor=IMU_MONOCULAR).track_monocular_inertial, 80 warm-up
  frames;
- stereo_inertial: the stereo scene's 752x480 pair (0.110074 m baseline)
  on the same orbit law (radius 4 m, sweep pi/2 over 400 frames), cut to
  its first 200 frames, with its IMU stream; track_stereo(...,
  imu_samples=), 64 warm-up frames.

Two inertial scenes run through the chunked frontend as bench.py's
main_vi does (`bench.py:205-300`): bench.py's VI scene (the 512x384
camera, the 400-frame quarter orbit and its IMU stream, as in
mono_inertial_image but uncut), 1024 features,
SlamSystem(...).make_chunked_frontend(chunk=8, lag=1), async mapper,
loop closing on, 160 warm-up frames, the mapper drained, then timed:

- vi: IMU_MONOCULAR;
- si: IMU_STEREO, the right camera 0.11 m along x (bench.py's baseline),
  bf = 0.11 fx.

--frames cuts them (their warm-up stays 160, or 2/5 of a shorter run); it
cuts the per-frame inertial scenes too (the warm-up 2/5 of the cut).
Their lines also count the frames the VI chunk step stepped (the frames of
chunks dispatched after the IMU came up) and the retired order.

Their lines add the IMU's stage, the frame the IMU was first initialized
at, and the scale-aligned ATE (and its scale) of the frames tracked from
then on ("post-init") and of those among them after the warm-up
("timed").

Three scenes run tests/test_e2e_cli.py's chunked inertial cases through the
reference's CLI as the tests do (run.py --chunked --chunk-size 8
--sync-mapping --no-loop, 512 features over 4 levels, the 512x384 camera,
write_euroc_sequence's frames and IMU) and print the tests' gate numbers
(the IMU's stage, the tracked tail, its scale-aligned ATE and scale):
cli_mono_inertial_sync and cli_stereo_inertial_sync (loop_sequence: 192
frames of a closed ring of radius 3 m, 0.11 m baseline) and
cli_rgbd_inertial (its depth ring, the first 120 frames).

Prints one JSON line per scene with the tracked / timed frames, keyframes,
map points, maps, the closer's counts (loops, merges, global BAs),
relocalization attempts and successes, and the scale-aligned ATE of the
whole trajectory and of the keyframes of the largest map, for comparison with the port's
counts on the card. No time is printed: this runs on the CPU.

    JAX_PLATFORMS=cpu python scripts/reference_system_counts.py \
        [system|loop|stereo|rgbd|mono_inertial|mono_inertial_image|stereo_inertial|vi|si
         |cli_mono_inertial_sync|cli_stereo_inertial_sync|cli_rgbd_inertial ...] \
        [--frames N] [--draws k ...]
"""
import argparse
import json
import sys

sys.path.insert(0, ".")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

N_WARM = 64
SCENES = {"system": 16, "loop": 8, "stereo": 16, "rgbd": 16}  # scene -> chunk
VI_SCENES = {"mono_inertial": (400, 160), "mono_inertial_image": (200, 80),
             "stereo_inertial": (200, 64)}  # frames, warm-up
CLI_SCENES = ("cli_mono_inertial_sync", "cli_stereo_inertial_sync", "cli_rgbd_inertial")
CHUNKED_VI = {"vi": 160, "si": 160}  # bench.py's main_vi scenes -> warm-up frames
VI_CAM = (330.0, 330.0, 256.0, 192.0, 512, 384)  # bench.py's main_vi camera
VI_BASELINE_M = 0.11  # bench.py's main_vi stereo baseline
FX = 458.654
BASELINE_M = 0.110074137800478  # configs/euroc_stereo.yaml, Stereo.T_c1_c2 x
BF = BASELINE_M * FX
MIN_DEPTH = 0.3


def scene_frames(scene, n_frames=400):
    """(frames (F, 480, 752) uint8, the right images (stereo) or depth maps
    (rgbd) or None, SE3 of the true poses) as chip_smoke.py renders them."""
    from orb_slam3_modified_tpu_torch.cameras import Camera as TCamera
    from orb_slam3_modified_tpu_torch.utils.synthetic import orbit_trajectory
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import (
        make_texture, render_rgbd_sequence, render_sequence, render_stereo_sequence,
        ring_trajectory,
    )

    tcam = TCamera.pinhole(FX, 457.296, 367.215, 248.375, width=752, height=480, device="cpu")
    if scene == "loop":
        T_all = ring_trajectory(n_frames)
        tex = make_texture(0, 128, 2048)
    else:
        T_all = orbit_trajectory(n_frames, radius=4.0, sweep=np.pi / 2)
        tex = make_texture(0, 96, 1024)
    extra = None
    with np.errstate(invalid="ignore"):  # rays parallel to the plane
        if scene == "stereo":
            frames, extra = render_stereo_sequence(tcam, T_all, tex, BASELINE_M, plane_z=2.0,
                                                   plane_half=10.0)
        elif scene == "rgbd":
            frames, extra = render_rgbd_sequence(tcam, T_all, tex, plane_z=2.0, plane_half=10.0)
        else:
            frames = render_sequence(tcam, T_all, tex, plane_z=2.0, plane_half=10.0)
    return frames, extra, T_all


def vi_scene(scene, n=None):
    """(frames, right images or None, SE3 of the true poses, imu_stream
    (ts, gyro, acc), camera (fx, fy, cx, cy, w, h)) of an inertial image
    scene, as chip_smoke.py renders it (its first n frames)."""
    from orb_slam3_modified_tpu_torch.cameras import Camera as TCamera
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import (
        imu_stream, make_texture, orbit_poses, render_sequence, render_stereo_sequence,
    )

    n = n or VI_SCENES[scene][0]
    orbit = dict(fps=20.0, radius=4.0, sweep=np.pi / 2)
    # the orbit law of 400 frames, cut to the scene's first n
    T_all = orbit_poses(400, **orbit)
    T_all = SE3(T_all.R[:n], T_all.t[:n])
    imu = imu_stream(400, **orbit)
    tex = make_texture(0, 96, 1024)
    bench_cam = scene in ("mono_inertial_image", "vi", "si")
    intr = VI_CAM if bench_cam else (FX, 457.296, 367.215, 248.375, 752, 480)
    tcam = TCamera.pinhole(*intr[:4], width=intr[4], height=intr[5], device="cpu")
    with np.errstate(invalid="ignore"):  # rays parallel to the plane
        if scene in ("stereo_inertial", "si"):
            frames, right = render_stereo_sequence(
                tcam, T_all, tex, VI_BASELINE_M if scene == "si" else BASELINE_M, plane_z=2.0,
                plane_half=10.0)
        else:
            frames, right = render_sequence(tcam, T_all, tex, plane_z=2.0, plane_half=10.0), None
    return frames, right, T_all, imu, intr


def run_vi(scene, draws=0, n_frames=None):
    from unittest import mock

    import jax.numpy as jnp

    import orb_slam3_modified_tpu  # noqa: F401  (precision config)
    from orb_slam3_modified_tpu.cameras import Camera
    from orb_slam3_modified_tpu.eval.ate import ate_rmse
    from orb_slam3_modified_tpu.features.extractor import ExtractorConfig, Features
    from orb_slam3_modified_tpu.system.slam_system import (
        IMU_MONOCULAR, IMU_STEREO, SlamSystem, SystemConfig,
    )
    from orb_slam3_modified_tpu.tracking import tracker as tracker_mod
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import imu_between

    n, n_warm = VI_SCENES[scene]
    if n_frames is not None and n_frames != n:  # a cut: 2/5 of it warm-up
        n, n_warm = n_frames, 2 * n_frames // 5
    course = scene == "mono_inertial"
    if course:
        from chip_smoke import ceiling_course
        from orb_slam3_modified_tpu_torch.cameras import Camera as TCamera

        intr = (FX, 457.296, 367.215, 248.375, 752, 480)
        frames = ceiling_course(TCamera.pinhole(*intr[:4], width=intr[4], height=intr[5],
                                                device="cpu"), n, 1024)
        gt = {f: frames[f][1] for f in range(n)}
        right = None
    else:
        frames, right, T_all, (its, igyro, iacc), intr = vi_scene(scene, n)
        R, t = T_all.R.numpy(), T_all.t.numpy()
        gt = {f: -R[f].T @ t[f] for f in range(n)}
    stereo = right is not None
    two_views = tracker_mod.reconstruct_two_views
    stack = mock.patch.object(  # draw set k: the key folded with k (k = 0: unchanged)
        tracker_mod, "reconstruct_two_views",
        lambda x0, x1, ok, focal, key, *a, **kw: two_views(
            x0, x1, ok, focal, jax.random.fold_in(key, draws) if draws else key, *a, **kw))
    stack.start()
    slam = SlamSystem(SystemConfig(
        cam=Camera.pinhole(*intr[:4], width=intr[4], height=intr[5]),
        sensor=IMU_STEREO if stereo else IMU_MONOCULAR, feat_cap=1024,
        extractor=ExtractorConfig(n_features=1024), use_loop_closing=True,
        bf=BASELINE_M * intr[0] if stereo else 0.0, min_depth=MIN_DEPTH))
    poses, init_frame, prev = [], None, None
    for i in range(n):
        ts = i / 20.0
        if course:
            feats, _, samples = frames[i]
            T = slam.track_features(Features(*(jnp.asarray(x) for x in feats)), ts,
                                    imu_samples=samples)
        else:
            samples = imu_between(its, igyro, iacc, prev, ts)
            img = frames[i].astype(np.float32)
            if stereo:
                T = slam.track_stereo(img, right[i].astype(np.float32), ts, imu_samples=samples)
            else:
                T = slam.track_monocular_inertial(img, ts, samples)
        prev = ts
        poses.append(T)
        if init_frame is None and slam.tracker.imu.initialized:
            init_frame = i
    slam.shutdown()
    stack.stop()
    imu = slam.tracker.imu
    traj = [(fid, T) for _, fid, T in slam.tracker.absolute_trajectory()
            if init_frame is not None and fid >= init_frame]

    def fit(frames_poses):
        if len(frames_poses) < 3:
            return None, None
        return ate_rmse(np.array([np.linalg.inv(T)[:3, 3] for _, T in frames_poses]),
                        np.array([gt[f] for f, _ in frames_poses]))

    post = fit(traj)
    timed = fit([(f, T) for f, T in traj if f >= n_warm])
    c = slam.closer
    m = slam.map
    print(json.dumps({
        "package": "orb_slam3_modified_tpu (JAX reference, CPU)", "scene": scene,
        "draws": draws, "entry": "track_stereo(imu_samples=)" if stereo
        else "track_features(imu_samples=)" if course else "track_monocular_inertial",
        "frames": n, "warm": n_warm, "tracked": sum(T is not None for T in poses),
        "tracked_timed": sum(T is not None for T in poses[n_warm:]), "timed": n - n_warm,
        "keyframes": m.n_keyframes(), "map_points": m.n_points(), "maps_created": m.n_maps,
        "imu_initialized": bool(imu.initialized), "imu_stage": int(imu.stage),
        "init_frame": init_frame, "post_init_frames": len(traj),
        "post_init_ate_m": post[0], "post_init_scale": None if post[1] is None else float(post[1]),
        "timed_ate_m": timed[0], "timed_scale": None if timed[1] is None else float(timed[1]),
        "init_events": [{k: e[k] for k in ("kind", "stage", "scale", "ts", "applied")}
                        for e in imu.init_log],
        "loops_closed": c.n_loops_closed, "merges": c.n_merges, "gba_runs": c.n_gba_runs,
    }), flush=True)


def run_chunked_vi(scene, n_frames=400):
    """bench.py's main_vi (see the module docstring) on the JAX package."""
    import orb_slam3_modified_tpu  # noqa: F401  (precision config)
    from orb_slam3_modified_tpu.cameras import Camera
    from orb_slam3_modified_tpu.eval.ate import ate_rmse
    from orb_slam3_modified_tpu.features.extractor import ExtractorConfig
    from orb_slam3_modified_tpu.system.slam_system import (
        IMU_MONOCULAR, IMU_STEREO, SlamSystem, SystemConfig,
    )
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import imu_between

    stereo = scene == "si"
    n_warm = CHUNKED_VI[scene] if n_frames >= 400 else 2 * n_frames // 5
    frames, right, T_all, (its, igyro, iacc), intr = vi_scene(scene, n_frames)
    slam = SlamSystem(SystemConfig(
        cam=Camera.pinhole(*intr[:4], width=intr[4], height=intr[5]),
        sensor=IMU_STEREO if stereo else IMU_MONOCULAR, feat_cap=1024,
        extractor=ExtractorConfig(n_features=1024), use_loop_closing=True,
        bf=VI_BASELINE_M * intr[0] if stereo else 0.0))
    fe = slam.make_chunked_frontend(chunk=8, lag=1, stereo=stereo)
    vi_frames = []  # frames of chunks the VI chunk step ran

    def retire(p, _inner=fe._retire_chunk):
        if p.vi:
            vi_frames.extend(p.fids[:p.n_valid])
        return _inner(p)

    fe._retire_chunk = retire
    imu = slam.tracker.imu
    retired, prev, init_frame = [], None, None
    for i in range(n_frames):
        ts = i / 20.0
        samples = imu_between(its, igyro, iacc, prev, ts)
        prev = ts
        retired += fe.track_image(frames[i], ts, img_right=right[i] if stereo else None,
                                  imu_samples=samples)
        if init_frame is None and imu.initialized:
            init_frame = i
        if i + 1 == n_warm:
            slam.async_mapper.flush()
    retired += fe.flush()
    slam.shutdown()
    R, t = T_all.R.numpy(), T_all.t.numpy()
    gt = {f: -R[f].T @ t[f] for f in range(n_frames)}
    traj = [(fid, T) for _, fid, T in slam.tracker.absolute_trajectory()]

    def fit(frames_poses):
        if len(frames_poses) < 3:
            return None, None
        rmse, s = ate_rmse(np.array([np.linalg.inv(T)[:3, 3] for _, T in frames_poses]),
                           np.array([gt[f] for f, _ in frames_poses]))
        return rmse, float(s)

    post = [(f, T) for f, T in traj if init_frame is not None and f >= init_frame]
    m = slam.map
    c = slam.closer
    print(json.dumps({
        "package": "orb_slam3_modified_tpu (JAX reference, CPU)", "scene": scene,
        "entry": "make_chunked_frontend(chunk=8, lag=1)", "frames": n_frames, "warm": n_warm,
        "retired_in_order": [r[0] for r in retired] == list(range(n_frames)),
        "tracked": sum(r[2] is not None for r in retired),
        "tracked_timed": sum(r[2] is not None for r in retired if r[0] >= n_warm),
        "timed": n_frames - n_warm, "vi_frames": len(vi_frames),
        "vi_frames_timed": sum(f >= n_warm for f in vi_frames),
        "keyframes": m.n_keyframes(), "map_points": m.n_points(), "maps_created": m.n_maps,
        "imu_initialized": bool(imu.initialized), "imu_stage": int(imu.stage),
        "imu_stage_reached": max([e["stage"] + 1 for e in imu.init_log
                                  if e["applied"] and e["kind"] == "init"], default=0),
        "init_frame": init_frame, "ate_m": fit(traj)[0],
        "ate_scale": fit(traj)[1], "post_init_ate_m": fit(post)[0],
        "post_init_scale": fit(post)[1],
        "timed_ate_m": fit([(f, T) for f, T in traj if f >= n_warm])[0],
        "timed_scale": fit([(f, T) for f, T in traj if f >= n_warm])[1],
        "init_events": [{k: e[k] for k in ("kind", "stage", "scale", "ts", "applied")}
                        for e in imu.init_log],
        "loops_closed": c.n_loops_closed, "merges": c.n_merges, "gba_runs": c.n_gba_runs,
    }), flush=True)


def run_cli(scene):
    """One of tests/test_e2e_cli.py's chunked inertial cases (module docstring)."""
    import os
    import tempfile

    import orb_slam3_modified_tpu  # noqa: F401  (precision config)
    from orb_slam3_modified_tpu.cameras import Camera
    from orb_slam3_modified_tpu.eval.ate import ate_rmse
    from orb_slam3_modified_tpu.run import main as run_main
    from orb_slam3_modified_tpu.utils.synthetic_dataset import write_euroc_sequence

    cam = Camera.pinhole(330.0, 330.0, 256.0, 192.0, width=512, height=384)
    sensor = {"cli_mono_inertial_sync": "mono-imu", "cli_stereo_inertial_sync": "stereo-imu",
              "cli_rgbd_inertial": "rgbd-imu"}[scene]
    root = tempfile.mkdtemp()
    rgbd = sensor == "rgbd-imu"
    gts = write_euroc_sequence(root, cam, n_frames=192, fps=20.0, radius=3.0, closed_loop=True,
                               stereo_baseline=0.0 if rgbd else 0.11, with_imu=True,
                               with_depth=rgbd)
    cfg = os.path.join(root, "cfg.yaml")
    extra = [] if sensor == "mono-imu" else [f"Camera.bf: {0.11 * cam.fx}"]
    if rgbd:
        extra += ["IMU.NoiseGyro: 1.7e-4", "IMU.NoiseAcc: 2.0e-3", "IMU.GyroWalk: 1.9e-05",
                  "IMU.AccWalk: 3.0e-03", "IMU.Frequency: 200.0"]
    with open(cfg, "w") as f:
        f.write("\n".join(["%YAML:1.0", "---", f"Camera.fx: {cam.fx}", f"Camera.fy: {cam.fy}",
                           f"Camera.cx: {cam.cx}", f"Camera.cy: {cam.cy}",
                           f"Camera.width: {cam.width}", f"Camera.height: {cam.height}",
                           "Camera.fps: 20.0", "ORBextractor.nFeatures: 512",
                           "ORBextractor.nLevels: 4", "\n".join(extra)]) + "\n")
    out = os.path.join(root, "traj.txt")
    args = ["--dataset", "euroc", "--path", root, "--config", cfg, "--sensor", sensor,
            "--out", out, "--no-loop", "--chunked", "--chunk-size", "8", "--sync-mapping"]
    if rgbd:
        args += ["--max-frames", "120"]
    slam = run_main(args)
    rows = np.atleast_2d(np.loadtxt(out))
    fids = np.round(rows[:, 0] * 20.0).astype(int)
    tail = fids >= (50 if rgbd else 96)
    gt = np.array([-gts[i][:3, :3].T @ gts[i][:3, 3] for i in fids[tail]])
    rmse, s = ate_rmse(rows[tail, 1:4], gt, with_scale=True)
    imu = slam.tracker.imu
    print(json.dumps({
        "package": "orb_slam3_modified_tpu (JAX reference, CPU)", "scene": scene,
        "entry": "run.py " + " ".join(args[6:]), "imu_initialized": bool(imu.initialized),
        "imu_stage": int(imu.stage), "tracked": int(len(fids)), "tail": int(tail.sum()),
        "tail_ate_m": float(rmse), "tail_scale": float(s),
        "init_events": [{k: e[k] for k in ("kind", "stage", "scale", "ts", "applied")}
                        for e in imu.init_log],
        "keyframes": slam.map.n_keyframes(), "map_points": slam.map.n_points(),
    }), flush=True)


def run(scene, n_frames=400):
    import orb_slam3_modified_tpu  # noqa: F401  (precision config)
    from orb_slam3_modified_tpu.cameras import Camera
    from orb_slam3_modified_tpu.eval.ate import ate_rmse
    from orb_slam3_modified_tpu.features.extractor import ExtractorConfig
    from orb_slam3_modified_tpu.system.slam_system import (
        MONOCULAR, RGBD, STEREO, SlamSystem, SystemConfig,
    )
    from orb_slam3_modified_tpu_torch.eval.ate import largest_map_ate

    frames, extra, T_all = scene_frames(scene, n_frames)
    sensor = {"stereo": STEREO, "rgbd": RGBD}.get(scene, MONOCULAR)
    slam = SlamSystem(SystemConfig(cam=Camera.pinhole(FX, 457.296, 367.215, 248.375,
                                                      width=752, height=480),
                                   sensor=sensor, feat_cap=1024,
                                   extractor=ExtractorConfig(n_features=1024),
                                   use_loop_closing=True,
                                   bf=BF if sensor != MONOCULAR else 0.0, min_depth=MIN_DEPTH,
                                   depth_scale=1.0, th_far_points=0.0))
    reloc = {"attempts": 0, "successes": 0}
    inner = slam.tracker.relocalize_fn

    def counted(feats, fid):
        reloc["attempts"] += 1
        res = inner(feats, fid)
        reloc["successes"] += res is not None
        return res

    slam.tracker.relocalize_fn = counted
    # close points made from depth at keyframe insertion (stereo / RGB-D);
    # the mapper worker waits on the map lock the retire holds meanwhile
    spawned = {"points": 0, "keyframes": 0}
    spawn = slam.tracker._spawn_depth_points

    def counted_spawn(k, rec):
        n0 = int(slam.map.mp_valid.sum())
        spawn(k, rec)
        spawned["points"] += int(slam.map.mp_valid.sum()) - n0
        spawned["keyframes"] += 1

    slam.tracker._spawn_depth_points = counted_spawn
    closer_calls = {"queries": 0, "verifications": 0}
    for name, key in (("_detect", "queries"), ("_verify", "verifications")):
        def wrapped(*a, _f=getattr(slam.closer, name), _k=key):
            closer_calls[_k] += 1
            return _f(*a)

        setattr(slam.closer, name, wrapped)
    fe = slam.make_chunked_frontend(chunk=SCENES[scene], lag=1, stereo=scene == "stereo",
                                    rgbd=scene == "rgbd")
    kw = {"stereo": "img_right", "rgbd": "depth_img"}.get(scene)
    retired = []
    for i in range(n_frames):
        retired += fe.track_image(frames[i], ts=i / 20.0, **({kw: extra[i]} if kw else {}))
        if i + 1 == N_WARM:
            slam.async_mapper.flush()
    retired += fe.flush()
    slam.shutdown()
    R, t = T_all.R.numpy(), T_all.t.numpy()
    gt = {f: -R[f].T @ t[f] for f in range(n_frames)}
    traj = slam.tracker.absolute_trajectory()
    est = np.array([np.linalg.inv(T)[:3, 3] for _, _, T in traj])
    rmse, scale = ate_rmse(est, np.array([gt[fid] for _, fid, _ in traj]))
    lm_rmse, lm_scale, lm_kfs, _ = largest_map_ate(slam.map, gt)
    c = slam.closer
    m = slam.map
    print(json.dumps({
        "package": "orb_slam3_modified_tpu (JAX reference, CPU)", "scene": scene,
        "frames": n_frames, "chunk": SCENES[scene],
        "retired_in_order": [r[0] for r in retired] == list(range(n_frames)),
        "tracked": sum(r[2] is not None for r in retired),
        "tracked_timed": sum(r[2] is not None for r in retired if r[0] >= N_WARM),
        "timed": n_frames - N_WARM, "keyframes": m.n_keyframes(),
        "keyframes_all_maps": m.n_keyframes(all_maps=True), "map_points": m.n_points(),
        "maps_created": m.n_maps, "maps_alive": len(m.map_ids()),
        "closer_queries": closer_calls["queries"],
        "closer_verifications": closer_calls["verifications"],
        "loops_closed": c.n_loops_closed, "merges": c.n_merges, "gba_runs": c.n_gba_runs,
        "gba_aborted": c.n_gba_aborted, "reloc_attempts": reloc["attempts"],
        "reloc_successes": reloc["successes"], "ate_m": rmse, "ate_scale": scale,
        "largest_map_kf_ate_m": lm_rmse, "largest_map_kf_scale": lm_scale,
        "largest_map_keyframes": lm_kfs, "close_points_spawned": spawned["points"],
        "keyframes_spawning": spawned["keyframes"],
    }), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scenes", nargs="*", default=list(SCENES),
                    choices=list(SCENES) + list(VI_SCENES) + list(CHUNKED_VI)
                    + list(CLI_SCENES))
    ap.add_argument("--frames", type=int, default=None,
                    help="cut a scene to its first N frames (default: the scene's own)")
    ap.add_argument("--draws", type=int, nargs="*", default=[0],
                    help="the inertial scenes' two-view draw sets (fold_in offsets)")
    a = ap.parse_args()
    for scene in a.scenes:
        if scene in CLI_SCENES:
            run_cli(scene)
        elif scene in CHUNKED_VI:
            run_chunked_vi(scene, a.frames or 400)
        elif scene in VI_SCENES:
            for k in a.draws:
                run_vi(scene, k, a.frames)
        else:
            run(scene, a.frames or 400)


if __name__ == "__main__":
    main()
