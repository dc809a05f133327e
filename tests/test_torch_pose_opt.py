"""Port parity: IRLS-LM pose optimization, JAX vs torch.

The scenes of tests/test_pose_opt.py (make_scene, numpy) go through both
solvers from the same initial pose. Gates: the same inlier mask, and the
pose within 1e-5 (rotation entries and translation in metres): the normal
equations are float32 sums over hundreds of rows, which the two runtimes
accumulate in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.cameras import Camera as JCamera
from orb_slam3_modified_tpu.lie import se3 as jse3
from orb_slam3_modified_tpu.lie.se3 import SE3 as JSE3
from orb_slam3_modified_tpu.optim.pose_opt import pose_optimization as j_pose_optimization
from orb_slam3_modified_tpu.utils.synthetic import make_scene
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.lie import se3 as tse3
from orb_slam3_modified_tpu_torch.lie.se3 import SE3
from orb_slam3_modified_tpu_torch.optim.pose_opt import pose_optimization

torch.set_num_threads(2)
JCAM = JCamera.pinhole(458.654, 457.296, 367.215, 248.375, width=752, height=480)
CAM = convert.camera(JCAM, device="cpu")
POSE_TOL = 1e-5

# (noise_px, outlier_frac, initial tangent) of the cases in tests/test_pose_opt.py
CASES = {
    "perturbed": (0.5, 0.0, [0.05, -0.03, 0.04, 0.02, -0.015, 0.01]),
    "outliers": (0.5, 0.3, [0.03, 0.02, -0.03, 0.01, 0.02, -0.01]),
    "noiseless_at_gt": (0.0, 0.0, [0.0] * 6),
    "large_error": (0.5, 0.0, [0.3, -0.2, 0.2, 0.1, -0.1, 0.08]),
}


def _scene(noise_px, outlier_frac, xi, n=300, seed=0):
    scene = make_scene(n_points=n, n_frames=2, noise_px=noise_px, seed=seed)
    R_gt = np.asarray(scene.T_cw.R[0])
    t_gt = np.asarray(scene.T_cw.t[0])
    uv = np.array(scene.uv[0])
    if outlier_frac > 0:
        rng = np.random.default_rng(seed + 1)
        n_out = int(n * outlier_frac)
        idx = rng.choice(n, n_out, replace=False)
        uv[idx] += rng.uniform(20, 80, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    T0 = jse3.exp(jnp.asarray(np.asarray(xi, np.float32))) @ JSE3(jnp.asarray(R_gt), jnp.asarray(t_gt))
    return dict(
        pts=np.asarray(scene.points, np.float32), uv=uv.astype(np.float32),
        valid=np.asarray(scene.visible[0]), R0=np.array(T0.R), t0=np.array(T0.t),
        R_gt=R_gt, t_gt=t_gt,
    )


def _run_both(s, inv_s2=None, ur=None, bf=None, rounds=4, iters=10):
    n = s["pts"].shape[0]
    inv_s2 = np.ones(n, np.float32) if inv_s2 is None else inv_s2
    jres = j_pose_optimization(
        JSE3(jnp.asarray(s["R0"]), jnp.asarray(s["t0"])), JCAM, jnp.asarray(s["pts"]),
        jnp.asarray(s["uv"]), jnp.asarray(inv_s2), rounds, iters, valid=jnp.asarray(s["valid"]),
        ur_obs=None if ur is None else jnp.asarray(ur), bf=None if bf is None else jnp.float32(bf),
    )
    tres = pose_optimization(
        SE3(torch.from_numpy(s["R0"]), torch.from_numpy(s["t0"])), CAM,
        torch.from_numpy(s["pts"]), torch.from_numpy(s["uv"]), torch.from_numpy(inv_s2),
        rounds, iters, valid=torch.from_numpy(s["valid"]),
        ur_obs=None if ur is None else torch.from_numpy(ur),
        bf=None if bf is None else torch.tensor(bf, dtype=torch.float32),
    )
    return jres, tres


def _assert_parity(jres, tres):
    np.testing.assert_array_equal(tres.inliers.numpy(), np.asarray(jres.inliers))
    assert int(tres.n_inliers) == int(jres.n_inliers)
    np.testing.assert_allclose(tres.T_cw.R.numpy(), np.asarray(jres.T_cw.R), atol=POSE_TOL)
    np.testing.assert_allclose(tres.T_cw.t.numpy(), np.asarray(jres.T_cw.t), atol=POSE_TOL)


def pose_err(T, R_gt, t_gt):
    dR = T.R.numpy() @ R_gt.T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    return ang, np.linalg.norm(T.t.numpy() - t_gt)


@pytest.fixture(scope="module")
def results():
    out = {}
    for name, (noise, frac, xi) in CASES.items():
        s = _scene(noise, frac, xi)
        out[name] = (s, *_run_both(s))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_parity_with_reference(results, case):
    _, jres, tres = results[case]
    _assert_parity(jres, tres)


def test_parity_with_level_weights_and_stereo_rows():
    s = _scene(0.5, 0.1, [0.02, -0.01, 0.03, 0.01, 0.0, -0.01], seed=3)
    n = s["pts"].shape[0]
    rng = np.random.default_rng(5)
    inv_s2 = (1.0 / 1.2 ** (2.0 * rng.integers(0, 8, n))).astype(np.float32)
    bf = 0.11 * 458.654
    pc = s["pts"] @ s["R_gt"].T + s["t_gt"]
    ur = (s["uv"][:, 0] - bf / pc[:, 2] + rng.normal(0, 0.5, n)).astype(np.float32)
    ur[rng.random(n) < 0.4] = -1.0  # mono rows
    jres, tres = _run_both(s, inv_s2=inv_s2, ur=ur, bf=bf, rounds=3, iters=6)
    _assert_parity(jres, tres)


# The cases of tests/test_pose_opt.py, re-run on the port.
def test_converges_from_perturbed_pose(results):
    s, _, tres = results["perturbed"]
    ang, dt = pose_err(tres.T_cw, s["R_gt"], s["t_gt"])
    assert ang < 0.05 and dt < 0.01 and int(tres.n_inliers) > 200


def test_robust_to_outliers(results):
    s, _, tres = results["outliers"]
    ang, dt = pose_err(tres.T_cw, s["R_gt"], s["t_gt"])
    assert ang < 0.1 and dt < 0.02
    assert tres.inliers.sum() < s["valid"].sum()


def test_exact_at_ground_truth_noiseless(results):
    s, _, tres = results["noiseless_at_gt"]
    ang, dt = pose_err(tres.T_cw, s["R_gt"], s["t_gt"])
    assert ang < 1e-3 and dt < 1e-4


def test_large_initial_error(results):
    s, _, tres = results["large_error"]
    ang, dt = pose_err(tres.T_cw, s["R_gt"], s["t_gt"])
    assert ang < 0.1 and dt < 0.05


def test_se3_exp_left_update_matches_reference():
    xi = np.array([0.01, -0.02, 0.03, 0.004, -0.005, 0.006], np.float32)
    T = tse3.exp(torch.from_numpy(xi))
    J = jse3.exp(jnp.asarray(xi))
    np.testing.assert_allclose(T.R.numpy(), np.asarray(J.R), atol=1e-6)
    np.testing.assert_allclose(T.t.numpy(), np.asarray(J.t), atol=1e-6)
