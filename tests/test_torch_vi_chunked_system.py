"""The chunked visual-inertial frontend as a whole on the port, through the
port's runner: run.main([... "--chunked", "--chunk-size", "8",
"--sync-mapping", "--no-loop", "--device", "cpu"]) on the scenes and with
the gates of tests/test_e2e_cli.py's chunked inertial cases (which run the
reference's runner with the same flags: 512 features over 4 levels, the
512x384 camera, the default IMU noise), each sequence written by the
reference's write_euroc_sequence and read back by the port's EurocDataset,
the config a settings file of the reference's format.

- test_mono_inertial_chunked_sync: loop_sequence (192 frames of a closed
  ring of radius 3 m, the ideal 200 Hz IMU): stage >= 2, >= 80 tracked
  frames in the second half, their scale-aligned ATE < 0.30 m and
  |s - 1| < 0.15. The same run writes every output the runner has:
  --kf-out (the keyframe TUM file), --atlas-out (loads back equal to the
  map), --debug-out (one line per init event), --viz-out --viz-every 16
  (overlays named by retired frame ids) and --semantic-out (a PLY through
  the depth net); then --atlas-in resumes from that atlas for 8 frames,
  async mapper and loop closing on, with every holder of the map holding
  the loaded one.
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
import glob
import os

import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.cameras import Camera as JCamera
from orb_slam3_modified_tpu_torch.eval.ate import ate_rmse

torch.set_num_threads(2)
JCAM = JCamera.pinhole(330.0, 330.0, 256.0, 192.0, width=512, height=384)
N_FRAMES, FPS, BASELINE_M = 192, 20.0, 0.11
# the reference's CLI on loop_sequence's pair (sync mapping: one run is every
# run): its own test fails on the scale (0.2 < s < 4.0)
REF_STEREO_CHUNKED_SYNC = {"imu_stage": 2, "tail": 95, "tail_ate_m": 1.7111199514730944,
                           "tail_scale": 0.17154352819891644}


def _sequence(root, write=True, **kw):
    """(root, the true camera centres) of write_euroc_sequence's ring;
    write=False takes a sequence written before."""
    from orb_slam3_modified_tpu.utils.synthetic_dataset import orbit_state, write_euroc_sequence

    if write:
        write_euroc_sequence(root, JCAM, n_frames=N_FRAMES, fps=FPS, radius=3.0,
                             closed_loop=True, with_imu=True, **kw)
    # the centres of the T_cw write_euroc_sequence returns (closed_loop: the ring)
    centres = [orbit_state(i / FPS, N_FRAMES / FPS, 3.0, 2 * np.pi, 0.4, True)[1]
               for i in range(N_FRAMES)]
    return root, np.array(centres)


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
            seq = _sequence(str(root), stereo_baseline=BASELINE_M)
            done.touch()
            return seq
    return _sequence(str(root), write=False)


def _config(path, bf=0.0):
    """tests/test_e2e_cli.py's _write_config: the camera, 512 features over
    4 levels, Camera.bf for the depth sensors, no IMU block (the default
    noise)."""
    lines = ["%YAML:1.0", "---"] + [f"Camera.{k}: {getattr(JCAM, k)}" for k in
                                    ("fx", "fy", "cx", "cy", "width", "height")]
    lines += [f"Camera.fps: {FPS}", "ORBextractor.nFeatures: 512", "ORBextractor.nLevels: 4"]
    if bf:
        lines.append(f"Camera.bf: {bf}")  # as test_e2e_cli.py writes it
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def _run(sensor, root, tmp_path, n_max=None, extra=()):
    """The port's runner as tests/test_e2e_cli.py runs the reference's:
    (RunResult, {frame id: camera centre})."""
    from orb_slam3_modified_tpu_torch import run

    bf = BASELINE_M * JCAM.fx if sensor != "mono-imu" else 0.0
    argv = ["--dataset", "euroc", "--path", root, "--config",
            _config(str(tmp_path / "cfg.yaml"), bf), "--sensor", sensor, "--device", "cpu",
            "--out", str(tmp_path / "traj.txt"), "--no-loop", "--chunked", "--chunk-size", "8",
            "--sync-mapping", *(["--max-frames", str(n_max)] if n_max else []), *extra]
    res = run.main(argv)
    centres = {f: np.linalg.inv(T)[:3, 3] for _, f, T in res.slam.tracker.absolute_trajectory()}
    return res, centres


def _tail_fit(centres, gt, first):
    fids = np.array(sorted(f for f in centres if f >= first))
    rmse, s = ate_rmse(np.array([centres[f] for f in fids]), gt[fids])
    return len(fids), float(rmse), float(s)


def test_mono_inertial_chunked_sync(loop_sequence, tmp_path):
    from orb_slam3_modified_tpu_torch import run
    from orb_slam3_modified_tpu_torch.slam_map.serialization import load_atlas

    root, gt = loop_sequence
    out = {k: str(tmp_path / k) for k in ("kf.txt", "atlas", "debug.jsonl", "viz", "cloud.ply")}
    res, centres = _run("mono-imu", root, tmp_path, extra=[
        "--kf-out", out["kf.txt"], "--atlas-out", out["atlas"], "--debug-out",
        out["debug.jsonl"], "--viz-out", out["viz"], "--viz-every", "16", "--semantic-out",
        out["cloud.ply"]])
    slam = res.slam
    assert res.retired == list(range(N_FRAMES)) and res.n_frames == N_FRAMES
    imu = slam.tracker.imu
    assert imu.initialized, "IMU never initialized"
    assert imu.stage >= 2, f"staged init stalled at {imu.stage}"
    n_tail, rmse, s = _tail_fit(centres, gt, N_FRAMES // 2)
    assert n_tail >= 80, f"tracked tail too short ({n_tail})"
    assert rmse < 0.30, f"sync-chunked mono-inertial ATE {rmse:.3f} m"
    assert abs(s - 1.0) < 0.15, f"metric scale off: {s:.3f}"

    # every output of the run
    traj = np.loadtxt(str(tmp_path / "traj.txt"), ndmin=2)
    assert len(traj) == len(centres)
    assert len(np.loadtxt(out["kf.txt"], ndmin=2)) == slam.map.n_keyframes(all_maps=True)
    atlas = load_atlas(out["atlas"])
    for name, v in vars(slam.map).items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(getattr(atlas, name), v), name
    events = open(out["debug.jsonl"]).read().splitlines()
    assert len(events) == len(imu.init_log) >= 2
    shots = sorted(glob.glob(os.path.join(out["viz"], "frame_*.png")))
    ids = [int(os.path.basename(p)[6:12]) for p in shots]
    assert len(ids) >= N_FRAMES // 16 - 2 and set(ids) <= set(res.retired)
    with open(out["cloud.ply"]) as f:
        head = [next(f) for _ in range(3)]
    assert head[0] == "ply\n" and int(head[2].split()[-1]) > 200

    # resume from the atlas: 8 frames, async mapper and loop closing on
    resumed = run.main(["--dataset", "euroc", "--path", root, "--config",
                        str(tmp_path / "cfg.yaml"), "--sensor", "mono-imu", "--device", "cpu",
                        "--out", str(tmp_path / "resumed.txt"), "--chunked", "--chunk-size",
                        "8", "--max-frames", "8", "--atlas-in", out["atlas"]])
    r = resumed.slam
    assert resumed.retired == list(range(8))
    holders = [r.tracker.map, r.mapper.map, r.closer.map, r.async_mapper.mapper.map,
               resumed.frontend.tracker.map]
    assert all(h is r.map for h in holders)
    assert r.closer._on_kf_removed in r.map.kf_removed_callbacks
    assert r.map.n_maps == atlas.n_maps + 1 and r.map.active_map == atlas.n_maps
    old = atlas.keyframe_indices(all_maps=True)
    assert np.array_equal(r.map.kf_frame_id[old], atlas.kf_frame_id[old])
    assert {int(k) for k in old} <= set(r.closer.kfdb.kf_words)  # Map::PostLoad


def test_stereo_inertial_chunked_sync(loop_sequence, tmp_path):
    root, gt = loop_sequence
    res, centres = _run("stereo-imu", root, tmp_path)
    slam, ref = res.slam, REF_STEREO_CHUNKED_SYNC
    assert res.retired == list(range(N_FRAMES))
    imu = slam.tracker.imu
    assert imu.initialized and imu.stage >= ref["imu_stage"], imu.stage
    assert all(e["scale"] == 1.0 for e in imu.init_log if e["applied"])  # metric: no rescale
    n_tail, rmse, s = _tail_fit(centres, gt, N_FRAMES // 2)
    assert n_tail >= ref["tail"], n_tail
    assert rmse <= ref["tail_ate_m"], (rmse, s)


def test_rgbd_inertial_chunked(tmp_path):
    root, gt = _sequence(str(tmp_path / "seq"), with_depth=True)
    res, centres = _run("rgbd-imu", root, tmp_path, n_max=120)
    assert res.retired == list(range(120))
    imu = res.slam.tracker.imu
    assert imu.initialized, "IMU never initialized"
    assert not imu.cfg.mono, "RGB-D-inertial must not re-solve scale"
    n_tail, rmse, s = _tail_fit(centres, gt, 50)
    assert n_tail >= 40, f"tracked tail too short ({n_tail})"
    assert rmse < 0.5, f"chunked rgbd-inertial ATE {rmse:.3f} m"
    assert abs(s - 1.0) < 0.25, f"metric scale off: {s:.3f}"
