"""The chunked visual-inertial frontend as a whole on the port:
SlamSystem(sensor=IMU_*).make_chunked_frontend(chunk=8, lag=1,
async_mapping=False) in memory, on the scenes and with the gates of
tests/test_e2e_cli.py's chunked inertial cases (which run the reference's
CLI: --chunked --chunk-size 8 --sync-mapping --no-loop, 512 features over 4
levels, the 512x384 camera, the default IMU noise).

- test_mono_inertial_chunked_sync: loop_sequence (write_euroc_sequence: 192
  frames of a closed ring of radius 3 m, the ideal 200 Hz IMU, the frames
  and IMU read back through the reference's EurocDataset, as the CLI reads
  them): stage >= 2, >= 80 tracked frames in the second half, their
  scale-aligned ATE < 0.30 m and |s - 1| < 0.15.
- test_rgbd_inertial_chunked: the depth ring, its first 120 frames: the
  IMU initialized, >= 40 tracked frames from frame 50 on, ATE < 0.5 m,
  |s - 1| < 0.25.
- test_stereo_inertial_chunked_sync: loop_sequence's pair (0.11 m
  baseline). The reference fails its own test there (ROADMAP, Queue 3), so
  the port is held to the reference's measured output on the same frames
  (REF_STEREO_CHUNKED_SYNC, scripts/reference_system_counts.py
  cli_stereo_inertial_sync): its stage, no fewer tracked tail frames, and
  a tail ATE no worse.
"""
import fcntl
import os

import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.cameras import Camera as JCamera
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.eval.ate import ate_rmse

torch.set_num_threads(2)
JCAM = JCamera.pinhole(330.0, 330.0, 256.0, 192.0, width=512, height=384)
N_FRAMES, FPS, BASELINE_M = 192, 20.0, 0.11
# the reference's CLI on loop_sequence's pair (sync mapping: one run is every
# run): its own test fails on the scale (0.2 < s < 4.0)
REF_STEREO_CHUNKED_SYNC = {"imu_stage": 2, "tail": 95, "tail_ate_m": 1.7111199514730944,
                           "tail_scale": 0.17154352819891644}


def _imu_tuple(samples, prev_ts):
    """run.py's imu_tuple: (acc, gyro, dts) of a frame's EuRoC samples."""
    if not samples:
        return None
    acc = np.stack([s.acc for s in samples]).astype(np.float32)
    gyro = np.stack([s.gyro for s in samples]).astype(np.float32)
    tss = np.array([s.ts for s in samples])
    t0 = prev_ts if prev_ts is not None else tss[0]
    return acc, gyro, np.maximum(np.diff(np.concatenate([[t0], tss])), 0.0).astype(np.float32)


def _sequence(root, write=True, **kw):
    """(frames read back through the reference's EurocDataset, the true
    camera centres) of write_euroc_sequence's ring; write=False reads a
    sequence written before."""
    from orb_slam3_modified_tpu.io.datasets import EurocDataset
    from orb_slam3_modified_tpu.utils.synthetic_dataset import orbit_state, write_euroc_sequence

    if write:
        write_euroc_sequence(root, JCAM, n_frames=N_FRAMES, fps=FPS, radius=3.0,
                             closed_loop=True, with_imu=True, **kw)
    frames = list(EurocDataset(root, stereo=kw.get("stereo_baseline", 0) > 0, with_imu=True,
                               with_depth=kw.get("with_depth", False)))
    # the centres write_euroc_sequence returns its T_cw of (closed_loop: the ring)
    centres = [orbit_state(i / FPS, N_FRAMES / FPS, 3.0, 2 * np.pi, 0.4, True)[1]
               for i in range(N_FRAMES)]
    return frames, np.array(centres)


@pytest.fixture(scope="module")
def loop_sequence(tmp_path_factory):
    """tests/test_e2e_cli.py's loop_sequence: cam0 + cam1 + the ideal IMU,
    written once per pytest run (under pytest-xdist the workers share the
    run's base directory, and a lock lets the first one write it)."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    root = base / "vi_chunked_loop"
    with open(str(root) + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        done = root / "written"
        if not done.exists():
            frames = _sequence(str(root), stereo_baseline=BASELINE_M)
            done.touch()
            return frames
    return _sequence(str(root), stereo_baseline=BASELINE_M, write=False)


def _run(sensor, frames, n_max=None):
    """The port's SlamSystem through the chunked frontend as run.py drives
    the reference's: (slam, retired, {frame id: camera centre})."""
    from orb_slam3_modified_tpu_torch.features.extractor import ExtractorConfig
    from orb_slam3_modified_tpu_torch.system import slam_system as ss

    stereo, rgbd = sensor == ss.IMU_STEREO, sensor == ss.IMU_RGBD
    slam = ss.SlamSystem(ss.SystemConfig(
        cam=convert.camera(JCAM, device="cpu"), sensor=sensor, feat_cap=512,
        extractor=ExtractorConfig(n_features=512, n_levels=4), use_loop_closing=False,
        bf=BASELINE_M * JCAM.fx if stereo or rgbd else 0.0, device="cpu"))
    fe = slam.make_chunked_frontend(chunk=8, lag=1, async_mapping=False, stereo=stereo, rgbd=rgbd)
    retired, prev = [], None
    for fr in frames[:n_max]:
        samples = _imu_tuple(fr.imu, prev)
        if fr.imu:
            prev = fr.imu[-1].ts
        kw = ({"img_right": np.asarray(fr.image_right, np.uint8)} if stereo
              else {"depth_img": np.asarray(fr.depth, np.float32)} if rgbd else {})
        retired += fe.track_image(np.asarray(fr.image, np.uint8), fr.ts, imu_samples=samples,
                                  **kw)
    retired += fe.flush()
    slam.shutdown()
    centres = {f: np.linalg.inv(T)[:3, 3] for _, f, T in slam.tracker.absolute_trajectory()}
    return slam, retired, centres


def _tail_fit(centres, gt, first):
    fids = np.array(sorted(f for f in centres if f >= first))
    rmse, s = ate_rmse(np.array([centres[f] for f in fids]), gt[fids])
    return len(fids), float(rmse), float(s)


def test_mono_inertial_chunked_sync(loop_sequence):
    from orb_slam3_modified_tpu_torch.system.slam_system import IMU_MONOCULAR

    frames, gt = loop_sequence
    slam, retired, centres = _run(IMU_MONOCULAR, frames)
    assert [r[0] for r in retired] == list(range(N_FRAMES))
    imu = slam.tracker.imu
    assert imu.initialized, "IMU never initialized"
    assert imu.stage >= 2, f"staged init stalled at {imu.stage}"
    n_tail, rmse, s = _tail_fit(centres, gt, N_FRAMES // 2)
    assert n_tail >= 80, f"tracked tail too short ({n_tail})"
    assert rmse < 0.30, f"sync-chunked mono-inertial ATE {rmse:.3f} m"
    assert abs(s - 1.0) < 0.15, f"metric scale off: {s:.3f}"


def test_stereo_inertial_chunked_sync(loop_sequence):
    from orb_slam3_modified_tpu_torch.system.slam_system import IMU_STEREO

    frames, gt = loop_sequence
    slam, retired, centres = _run(IMU_STEREO, frames)
    ref = REF_STEREO_CHUNKED_SYNC
    assert [r[0] for r in retired] == list(range(N_FRAMES))
    imu = slam.tracker.imu
    assert imu.initialized and imu.stage >= ref["imu_stage"], imu.stage
    assert all(e["scale"] == 1.0 for e in imu.init_log if e["applied"])  # metric: no rescale
    n_tail, rmse, s = _tail_fit(centres, gt, N_FRAMES // 2)
    assert n_tail >= ref["tail"], n_tail
    assert rmse <= ref["tail_ate_m"], (rmse, s)


def test_rgbd_inertial_chunked(tmp_path):
    from orb_slam3_modified_tpu_torch.system.slam_system import IMU_RGBD

    frames, gt = _sequence(str(tmp_path), with_depth=True)
    slam, retired, centres = _run(IMU_RGBD, frames, n_max=120)
    assert [r[0] for r in retired] == list(range(120))
    imu = slam.tracker.imu
    assert imu.initialized, "IMU never initialized"
    assert not imu.cfg.mono, "RGB-D-inertial must not re-solve scale"
    n_tail, rmse, s = _tail_fit(centres, gt, 50)
    assert n_tail >= 40, f"tracked tail too short ({n_tail})"
    assert rmse < 0.5, f"chunked rgbd-inertial ATE {rmse:.3f} m"
    assert abs(s - 1.0) < 0.25, f"metric scale off: {s:.3f}"
