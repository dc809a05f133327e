"""The JAX reference on the frames of chip_smoke.py's `system` phase.

Renders bench.py's headline scene exactly as chip_smoke.py does (the port's
utils/synthetic_dataset.py: seeded texture upsampled by torch, the 400-frame
quarter orbit, 752x480 uint8), then drives the JAX package's
SlamSystem(..., use_loop_closing=False).make_chunked_frontend(chunk=16,
lag=1) over them: the first 64 frames as warm-up, the async mapper drained,
then the rest. Prints one JSON line with the tracked / timed frames,
keyframes, map points and the scale-aligned ATE, for comparison with the
port's counts on the card. No time is printed: this runs on the CPU.

    JAX_PLATFORMS=cpu python scripts/reference_system_counts.py [n_frames]
"""
import json
import sys

sys.path.insert(0, ".")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

N_WARM = 64


def main(n_frames=400):
    import orb_slam3_modified_tpu  # noqa: F401  (precision config)
    from orb_slam3_modified_tpu.cameras import Camera
    from orb_slam3_modified_tpu.eval.ate import ate_rmse
    from orb_slam3_modified_tpu.features.extractor import ExtractorConfig
    from orb_slam3_modified_tpu.system.slam_system import SlamSystem, SystemConfig
    from orb_slam3_modified_tpu_torch.cameras import Camera as TCamera
    from orb_slam3_modified_tpu_torch.utils.synthetic import orbit_trajectory
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import make_texture, render_sequence

    intr = (458.654, 457.296, 367.215, 248.375)
    tcam = TCamera.pinhole(*intr, width=752, height=480, device="cpu")
    T_all = orbit_trajectory(400, radius=4.0, sweep=np.pi / 2)
    frames = render_sequence(tcam, T_all, make_texture(0, 96, 1024), plane_z=2.0, plane_half=10.0)
    slam = SlamSystem(SystemConfig(cam=Camera.pinhole(*intr, width=752, height=480),
                                   feat_cap=1024, extractor=ExtractorConfig(n_features=1024),
                                   use_loop_closing=False))
    fe = slam.make_chunked_frontend(chunk=16, lag=1)
    retired = []
    for i in range(n_frames):
        retired += fe.track_image(frames[i], ts=i / 20.0)
        if i + 1 == N_WARM:
            slam.async_mapper.flush()
    retired += fe.flush()
    slam.shutdown()
    traj = slam.tracker.absolute_trajectory()
    est = np.array([np.linalg.inv(T)[:3, 3] for _, _, T in traj])
    R, t = T_all.R.numpy(), T_all.t.numpy()
    gt = np.array([-R[fid].T @ t[fid] for _, fid, _ in traj])
    rmse, scale = ate_rmse(est, gt)
    print(json.dumps({
        "package": "orb_slam3_modified_tpu (JAX reference, CPU)", "frames": n_frames,
        "retired_in_order": [r[0] for r in retired] == list(range(n_frames)),
        "tracked": sum(r[2] is not None for r in retired),
        "tracked_timed": sum(r[2] is not None for r in retired if r[0] >= N_WARM),
        "timed": n_frames - N_WARM, "keyframes": slam.map.n_keyframes(),
        "map_points": slam.map.n_points(), "ate_m": rmse, "ate_scale": scale,
    }), flush=True)


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:]))
