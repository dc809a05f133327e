"""Port parity for SlamSystem's trajectory savers and debug dump, and the
eval CLI (eval/__main__.py).

The same frame trajectory, keyframes, rig extrinsics and init events are
injected into a reference and a port SlamSystem (made with __new__: only
the savers run), and every file the savers write must equal the
reference's byte for byte: TUM and keyframe TUM, EuRoC and keyframe EuRoC
(camera frame for the visual sensors, body frame through T_bc for the
inertial ones, nanosecond stamps), KITTI and the JSON-lines debug dump.
tests/test_system_modes.py::TestTrajectoryFormats' format checks and
tests/test_staged_init.py::test_save_debug_data_dump's ones run on the
port's files. eval's main prints the same report and returns the same
RMSE as the reference's on the same two TUM files.
"""
import json
import types

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

from orb_slam3_modified_tpu.eval import __main__ as j_eval
from orb_slam3_modified_tpu.slam_map.map_state import MapState as JMapState
from orb_slam3_modified_tpu.system.slam_system import SlamSystem as JSlamSystem
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.eval import __main__ as p_eval
from orb_slam3_modified_tpu_torch.system.slam_system import SlamSystem as PSlamSystem

SAVERS = ("save_trajectory_tum", "save_keyframe_trajectory_tum", "save_trajectory_euroc",
          "save_keyframe_trajectory_euroc", "save_trajectory_kitti", "save_debug_data")


def _pose(R, t):
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    return T


def _scene(inertial: bool):
    """(trajectory [(ts, fid, T_cw)], reference MapState with keyframes,
    imu namespace or None): EuRoC-like stamps (1.4e9 s)."""
    rng = np.random.default_rng(3 if inertial else 2)
    t0 = 1403636579.763555584
    Rs = Rotation.random(40, random_state=int(inertial)).as_matrix()
    traj = [(t0 + 0.05 * i, i, _pose(Rs[i], rng.normal(0, 2, 3))) for i in range(40)]
    m = JMapState.create(max_kf=16, max_mp=64, feat_cap=8)
    for i in (30, 3, 12, 21, 0):  # slots out of time order
        k = m.alloc_keyframe()
        m.kf_R[k] = Rs[i].astype(np.float32)
        m.kf_t[k] = traj[i][2][:3, 3].astype(np.float32)
        m.kf_ts[k], m.kf_frame_id[k] = traj[i][0], i
    imu = None
    if inertial:
        R_bc = Rotation.from_rotvec([0.01, -1.57, 0.02]).as_matrix().astype(np.float32)
        events = []
        for j, kind in enumerate(("init", "refine", "refine")):
            events.append({"kind": kind, "stage": j, "scale": 1.0 + 0.3 / (j + 1),
                           "R_wg": Rotation.random(random_state=j).as_matrix().astype(np.float32),
                           "t_solve": 0.1 * j + 0.25, "ts": t0 + j, "applied": j != 2})
        imu = types.SimpleNamespace(cfg=types.SimpleNamespace(
            R_bc=R_bc, t_bc=np.array([-0.0216, -0.0647, 0.0098], np.float32)), init_log=events)
    return traj, m, imu


def _system(cls, traj, m, imu):
    s = cls.__new__(cls)
    s.map = m
    s.tracker = types.SimpleNamespace(absolute_trajectory=lambda: list(traj), imu=imu)
    return s


@pytest.mark.parametrize("inertial", [False, True])
def test_savers_write_the_reference_files(inertial, tmp_path):
    traj, m, imu = _scene(inertial)
    ref = _system(JSlamSystem, traj, m, imu)
    port = _system(PSlamSystem, traj, convert.map_state(m), imu)
    for saver in SAVERS:
        a, b = tmp_path / f"ref_{saver}.txt", tmp_path / f"port_{saver}.txt"
        assert getattr(port, saver)(str(b)) == getattr(ref, saver)(str(a))
        assert b.read_bytes() == a.read_bytes(), saver

    # tests/test_system_modes.py::TestTrajectoryFormats on the port's files
    le = (tmp_path / "port_save_trajectory_euroc.txt").read_text().strip().splitlines()
    lk = (tmp_path / "port_save_trajectory_kitti.txt").read_text().strip().splitlines()
    assert len(le) == len(lk) > 10
    first = le[0].split()
    assert len(first) == 8
    assert int(first[0]) == int(round(traj[0][0] * 1e9))
    assert abs(np.linalg.norm([float(x) for x in first[4:8]]) - 1) < 1e-5
    row = np.array([float(x) for x in lk[0].split()])
    assert row.shape == (12,)
    R = row.reshape(3, 4)[:, :3]
    assert np.allclose(R @ R.T, np.eye(3), atol=1e-4)
    kf_ts = [float(x.split()[0]) for x in
             (tmp_path / "port_save_keyframe_trajectory_tum.txt").read_text().splitlines()]
    assert kf_ts == sorted(kf_ts) and len(kf_ts) == 5

    # tests/test_staged_init.py::test_save_debug_data_dump on the port's dump
    rows = [json.loads(x) for x in open(tmp_path / "port_save_debug_data.txt")]
    assert len(rows) == (3 if inertial else 0)
    if inertial:
        assert rows[1]["kind"] == "refine" and rows[1]["applied"]
        assert len(rows[-1]["R_wg"]) == 9 and rows[-1]["t_solve"] >= 0


def _tum(path, ts, pos, quat):
    with open(path, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for t, p, q in zip(ts, pos, quat):
            f.write(f"{t:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} {q[0]} {q[1]} {q[2]} {q[3]}\n")


def test_eval_main_matches_reference(tmp_path, capsys):
    rng = np.random.default_rng(5)
    n = 60
    ts = 1.0 + 0.05 * np.arange(n)
    gt = np.cumsum(rng.normal(0, 0.1, (n, 3)), axis=0)
    R = Rotation.from_rotvec([0.2, -0.1, 0.4]).as_matrix()
    est = (0.7 * gt @ R.T + [1.0, -2.0, 0.5] + rng.normal(0, 0.01, (n, 3)))[5:-3]
    quat = [[0, 0, 0, 1]] * n
    _tum(tmp_path / "gt.txt", ts, gt, quat)
    _tum(tmp_path / "est.txt", ts[5:-3] + rng.uniform(-0.015, 0.015, n - 8), est, quat)
    args = [str(tmp_path / "gt.txt"), str(tmp_path / "est.txt")]
    for extra in ([], ["--no-scale"], ["--max-dt", "0.01"],
                  ["--plot", str(tmp_path / "ate.png")]):
        rmse_p = p_eval.main(args + extra)
        out_p = capsys.readouterr().out
        rmse_j = j_eval.main(args + extra)
        assert rmse_p == rmse_j and out_p == capsys.readouterr().out, extra
    assert (tmp_path / "ate.png").stat().st_size > 1000
    ts_p, pos_p = p_eval.load_tum(args[0])
    ts_j, pos_j = j_eval.load_tum(args[0])
    assert np.array_equal(ts_p, ts_j) and np.array_equal(pos_p, pos_j)
