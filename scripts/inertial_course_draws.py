"""How the monocular-inertial course's metric scale depends on the
two-view initializer's random minimal sets, in both packages.

The course is tests/test_e2e_inertial.py's (a 752x480 camera looking up at
a ceiling of 5000 feature points 2-6 m above a 1.5 m circle at 0.8 rad/s,
600 features a frame, 0.4 px noise, the 200 Hz IMU, 140 frames), the
Tracker + LocalMapper + ImuFrontend of each package on the CPU. The
two-view initializer draws its minimal sets from a key made from the frame
id; a run with draw offset k draws from another key per frame:

- port: the torch.Generator seeded with frame id + k * 1000003 (k = 0: the
  port's own draws); `port-jax` takes the reference's jax.random draws, as
  tests/test_torch_inertial_system.py does;
- reference: jax.random.fold_in(PRNGKey(frame id), k) (k = 0: the
  reference's own draws).

Prints one JSON line per run: tracked frames, the frame the IMU
initialized at, its stage, keyframes, and the scale-aligned ATE and its
scale s over the last 60 tracked frames (the course's gates: |s - 1| <
0.1, ATE < 0.05 m).

`port-system` runs chip_smoke.py's mono_inertial instead: the course at
full width (1024 features, 400 frames, 160 warm-up) through the port's
SlamSystem(sensor=IMU_MONOCULAR).track_features(imu_samples=), loop
closing on, on the CPU, and prints the ATE and s of the frames tracked
from the IMU init on and of the timed ones among them
(scripts/reference_system_counts.py mono_inertial --draws runs the
reference's side).

    JAX_PLATFORMS=cpu python scripts/inertial_course_draws.py \\
        port|port-jax|reference|port-system [offset ...]
"""
import json
import sys
import time
from unittest import mock

sys.path.insert(0, ".")
sys.path.insert(0, "tests")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def run_port(offset, jax_draws):
    import test_torch_inertial_system as course
    from orb_slam3_modified_tpu_torch.eval.ate import ate_rmse
    from orb_slam3_modified_tpu_torch.tracking import tracker as tmod

    orig = tmod.reconstruct_two_views

    def reseeded(x0, x1, ok, focal, gen, *a, **kw):
        g = type(gen)(device=gen.device).manual_seed(gen.initial_seed() + offset * 1000003)
        return orig(x0, x1, ok, focal, g, *a, **kw)

    with mock.patch.object(tmod, "reconstruct_two_views", reseeded):
        tracker, imu, m, returned, gt, _ = course.run_course(
            draws=course._reference_draws if jax_draws else None)
    frames = sorted(returned)
    pos = np.array([np.linalg.inv(returned[i])[:3, 3] for i in frames])
    gts = np.array([gt[i] for i in frames])
    ate, s = ate_rmse(pos[-60:], gts[-60:], with_scale=True)
    return len(frames), imu, m, ate, s


def run_reference(offset):
    import test_e2e_inertial as course
    from orb_slam3_modified_tpu.eval.ate import ate_rmse
    from orb_slam3_modified_tpu.tracking import tracker as tmod

    orig = tmod.reconstruct_two_views

    def reseeded(x0, x1, ok, focal, key, *a, **kw):
        return orig(x0, x1, ok, focal, jax.random.fold_in(key, offset), *a, **kw)

    with mock.patch.object(tmod, "reconstruct_two_views", reseeded):
        tracker, imu, m, est, gt = course.vi_run.__wrapped__()
    pos = np.array([np.linalg.inv(T)[:3, 3] for T in est])
    ate, s = ate_rmse(pos[-60:], gt[-60:], with_scale=True)
    return len(est), imu, m, ate, s


def run_port_system(offset):
    import torch

    from chip_smoke import N_FEATURES, VI_FRAMES, ceiling_course
    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.eval.ate import ate_rmse
    from orb_slam3_modified_tpu_torch.system.slam_system import (
        IMU_MONOCULAR, SlamSystem, SystemConfig,
    )
    from orb_slam3_modified_tpu_torch.tracking import tracker as tmod

    torch.set_num_threads(4)
    n, n_warm = VI_FRAMES["mono_inertial"]
    cam = Camera.pinhole(458.654, 457.296, 367.215, 248.375, width=752, height=480,
                         device="cpu")
    frames = ceiling_course(cam, n, N_FEATURES)
    slam = SlamSystem(SystemConfig(cam=cam, sensor=IMU_MONOCULAR, feat_cap=N_FEATURES,
                                   use_loop_closing=True, device="cpu"))
    orig = tmod.reconstruct_two_views

    def reseeded(x0, x1, ok, focal, gen, *a, **kw):
        g = type(gen)(device=gen.device).manual_seed(gen.initial_seed() + offset * 1000003)
        return orig(x0, x1, ok, focal, g, *a, **kw)

    t0 = time.perf_counter()
    init_frame, tracked = None, []
    with mock.patch.object(tmod, "reconstruct_two_views", reseeded):
        for i, (feats, _, samples) in enumerate(frames):
            tracked.append(slam.track_features(feats, i / 20.0, imu_samples=samples) is not None)
            if init_frame is None and slam.tracker.imu.initialized:
                init_frame = i
    slam.shutdown()
    traj = [(f, T) for _, f, T in slam.tracker.absolute_trajectory()
            if init_frame is not None and f >= init_frame]

    def fit(fp):
        if len(fp) < 3:
            return None, None
        a, s_ = ate_rmse(np.array([np.linalg.inv(T)[:3, 3] for _, T in fp]),
                         np.array([frames[f][1] for f, _ in fp]))
        return float(a), float(s_)

    imu = slam.tracker.imu
    post, timed = fit(traj), fit([x for x in traj if x[0] >= n_warm])
    print(json.dumps({
        "package": "port-system", "draw_offset": offset, "tracked": sum(tracked),
        "tracked_timed": sum(tracked[n_warm:]), "imu_stage": int(imu.stage),
        "init_frame": init_frame, "keyframes": slam.map.n_keyframes(),
        "init_scales": [e["scale"] for e in imu.init_log if e["applied"]],
        "post_init_ate_m": post[0], "post_init_scale": post[1], "timed_ate_m": timed[0],
        "timed_scale": timed[1], "host_s": time.perf_counter() - t0,
    }), flush=True)


def main():
    package = sys.argv[1]
    for offset in [int(a) for a in sys.argv[2:]] or [0]:
        if package == "port-system":
            run_port_system(offset)
            continue
        t0 = time.perf_counter()
        if package == "reference":
            tracked, imu, m, ate, s = run_reference(offset)
        else:
            tracked, imu, m, ate, s = run_port(offset, package == "port-jax")
        init = [e for e in imu.init_log if e["kind"] == "init" and e["applied"]]
        print(json.dumps({
            "package": package, "draw_offset": offset, "tracked": tracked,
            "imu_initialized": bool(imu.initialized), "imu_stage": int(imu.stage),
            "init_ts": init[0]["ts"] if init else None, "keyframes": m.n_keyframes(),
            "ate_last60_m": float(ate), "scale_last60": float(s),
            "abs_s_minus_1": abs(float(s) - 1.0), "host_s": time.perf_counter() - t0,
        }), flush=True)


if __name__ == "__main__":
    main()
