"""Port parity: IMU preintegration, the inertial factors and the staged
init's inertial-only solve, JAX vs torch.

The same seeded numpy inputs go through orb_slam3_modified_tpu's
imu/preintegration.py and optim/inertial.py and their ports
(orb_slam3_modified_tpu_torch, on the CPU). Tolerances are stated per test:
the integration is float32 in both, so the deltas agree to float32
rounding; the inertial-only MAP agrees to ~1e-5 relative (its Gauss-Newton
jacobian is jax.jacfwd in the reference, a float64 central difference in
the port). The reference's own gates (tests/test_imu.py,
tests/test_inertial.py) are asserted on the port's results as well. The
in-memory IMU stream is held against the CSV write_euroc_sequence writes.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.imu import preintegration as J
from orb_slam3_modified_tpu.lie import so3 as jso3
from orb_slam3_modified_tpu.optim import inertial as JI
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.imu import preintegration as P
from orb_slam3_modified_tpu_torch.optim import inertial as PI

from test_inertial import circle_sim

torch.set_num_threads(2)
GRAVITY = J.GRAVITY
DELTA_TOL = 1e-6  # absolute, float32 deltas of O(1) magnitude
FIELDS = ("dT", "dR", "dV", "dP", "C", "JRg", "JVg", "JVa", "JPg", "JPa", "avg_a", "avg_w")


def _t(a):
    return torch.from_numpy(np.array(a))


def _samples(seed, n=24, n_valid=17):
    rng = np.random.default_rng(seed)
    acc = (rng.normal(0, 1.0, (n, 3)) + [0.0, 0.0, GRAVITY]).astype(np.float32)
    gyro = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    dts = np.full(n, 0.005, np.float32)
    valid = np.zeros(n, bool)
    valid[:n_valid] = True
    bg = rng.normal(0, 0.01, 3).astype(np.float32)
    ba = rng.normal(0, 0.05, 3).astype(np.float32)
    return acc, gyro, dts, valid, bg, ba


def _both(seed, n=24, n_valid=17):
    acc, gyro, dts, valid, bg, ba = _samples(seed, n, n_valid)
    pj = J.integrate(jnp.asarray(acc), jnp.asarray(gyro), jnp.asarray(dts), jnp.asarray(valid),
                     J.ImuBias(jnp.asarray(bg), jnp.asarray(ba)))
    pp = P.integrate(_t(acc), _t(gyro), _t(dts), _t(valid), P.ImuBias(_t(bg), _t(ba)))
    return pj, pp


def _close(pj, pp, tol):
    for f in FIELDS:
        want = np.asarray(getattr(pj, f))
        np.testing.assert_allclose(getattr(pp, f).numpy(), want,
                                   atol=tol * max(1.0, float(np.abs(want).max())), err_msg=f)


@pytest.mark.parametrize("seed,n_valid", [(0, 17), (1, 24), (2, 1)])
def test_integrate_matches_reference(seed, n_valid):
    """Masked integration: padded samples leave every field untouched."""
    pj, pp = _both(seed, n_valid=n_valid)
    _close(pj, pp, DELTA_TOL)
    # the mask: the same samples without the padding give the same interval
    acc, gyro, dts, valid, bg, ba = _samples(seed)
    short = P.integrate(_t(acc[:n_valid]), _t(gyro[:n_valid]), _t(dts[:n_valid]),
                        torch.ones(n_valid, dtype=torch.bool), P.ImuBias(_t(bg), _t(ba)))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(short, f).numpy(), getattr(pp, f).numpy(), err_msg=f)


def test_merge_predict_and_getters_match_reference():
    pj1, pp1 = _both(3)
    pj2, pp2 = _both(4)
    pj2 = pj2._replace(bias=pj1.bias)
    pp2 = pp2._replace(bias=pp1.bias)
    _close(J.merge(pj1, pj2), P.merge(pp1, pp2), DELTA_TOL)
    rng = np.random.default_rng(9)
    bj = J.ImuBias(jnp.asarray(rng.normal(0, 0.01, 3).astype(np.float32)),
                   jnp.asarray(rng.normal(0, 0.05, 3).astype(np.float32)))
    bp = convert.imu_bias(bj, "cpu")
    for fj, fp in ((J.delta_rotation, P.delta_rotation), (J.delta_velocity, P.delta_velocity),
                   (J.delta_position, P.delta_position)):
        np.testing.assert_allclose(fp(pp1, bp).numpy(), np.asarray(fj(pj1, bj)), atol=DELTA_TOL)
    R = np.asarray(jso3.exp(jnp.asarray([0.1, -0.2, 0.3])), np.float32)
    v = np.array([0.3, -0.1, 0.2], np.float32)
    p = np.array([1.0, 2.0, -0.5], np.float32)
    want = J.predict_state(jnp.asarray(R), jnp.asarray(v), jnp.asarray(p), pj1, bj)
    got = P.predict_state(_t(R), _t(v), _t(p), pp1, bp)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=DELTA_TOL)
    # convert.preintegrated carries the reference's interval across exactly
    _close(pj1, convert.preintegrated(pj1, "cpu"), 0.0)


def _chains(bias_g=None):
    kf_states, pres = circle_sim(bias_g=bias_g)
    jchain = JI.InertialChain.from_preintegrated(pres)
    pchain = PI.InertialChain.from_preintegrated([convert.preintegrated(p, "cpu") for p in pres])
    return kf_states, jchain, pchain


def test_inertial_residuals_and_linear_init_match_reference():
    kf_states, jchain, pchain = _chains()
    R = np.stack([s[0] for s in kf_states]).astype(np.float32)
    p = np.stack([s[1] for s in kf_states]).astype(np.float32)
    v = np.stack([s[2] for s in kf_states]).astype(np.float32)
    bg = np.array([1e-3, -2e-3, 5e-4], np.float32)
    ba = np.array([0.01, 0.0, -0.02], np.float32)
    g = np.array([0.0, 0.05, -GRAVITY], np.float32)
    want = JI.inertial_residuals(jchain, jnp.asarray(R), jnp.asarray(p), jnp.asarray(v),
                                 jnp.asarray(bg), jnp.asarray(ba), jnp.asarray(g),
                                 jnp.asarray(1.1))
    got = PI.inertial_residuals(pchain, _t(R), _t(p), _t(v), _t(bg), _t(ba), _t(g), 1.1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # the reference's own gate: ~0 at the ground truth
    r0 = PI.inertial_residuals(pchain, _t(R), _t(p), _t(v), torch.zeros(3), torch.zeros(3),
                               torch.tensor([0.0, 0.0, -GRAVITY]), 1.0)
    assert float(r0.abs().max()) < 0.02
    np.testing.assert_array_equal(pchain.C_inv.numpy(), np.asarray(jchain.C_inv))
    s_j, g_j, v_j = JI.linear_inertial_init(jchain, jnp.asarray(R), jnp.asarray(p / 2.5))
    s_p, g_p, v_p = PI.linear_inertial_init(pchain, _t(R), _t(p / 2.5))
    assert abs(float(s_p) - float(s_j)) < 1e-4 * abs(float(s_j))
    np.testing.assert_allclose(g_p.numpy(), np.asarray(g_j), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(v_p.numpy(), np.asarray(v_j), atol=1e-4)


@pytest.mark.parametrize("case", ["scale", "gyro_bias", "fixed_scale"])
def test_inertial_only_optimization_matches_reference(case):
    """The staged init's MAP (tests/test_inertial.py's setup): scale 2.5,
    a 0.36 rad gravity tilt; the port within 1e-5 relative of the
    reference on every output but the final cost (1e-3 relative: a sum of
    residuals whitened by ~1e4), and on the reference's gates."""
    bias_g = np.array([0.02, -0.015, 0.01]) if case == "gyro_bias" else None
    kf_states, jchain, pchain = _chains(bias_g)
    s_gt = 2.5
    R_mg = np.asarray(jso3.exp(jnp.asarray([0.3, -0.2, 0.0])))
    R = np.stack([R_mg @ s[0] for s in kf_states]).astype(np.float32)
    p = np.stack([R_mg @ s[1] / s_gt for s in kf_states]).astype(np.float32)
    v0 = np.zeros((len(kf_states), 3), np.float32)
    fix = case == "fixed_scale"
    want = JI.inertial_only_optimization(jchain, jnp.asarray(R), jnp.asarray(p), jnp.asarray(v0),
                                         fix, 40)
    got = PI.inertial_only_optimization(pchain, _t(R), _t(p), _t(v0), fix, 40)
    for f in want._fields:
        w = np.asarray(getattr(want, f))
        rel = 1e-3 if f == "cost" else 1e-5
        np.testing.assert_allclose(getattr(got, f).numpy(), w,
                                   atol=rel * max(1.0, float(np.abs(w).max())), err_msg=f)
    if case == "scale":
        assert abs(float(got.scale) - s_gt) / s_gt < 0.02
        g_est = (got.R_wg @ torch.tensor([0.0, 0.0, -GRAVITY])).numpy()
        g_gt = R_mg @ np.array([0.0, 0.0, -GRAVITY])
        assert g_est @ g_gt / (np.linalg.norm(g_est) * np.linalg.norm(g_gt)) > 0.9995
        v_gt = np.stack([R_mg @ s[2] for s in kf_states])
        assert np.linalg.norm(got.v_w.numpy() - v_gt, axis=-1).mean() < 0.05
    elif case == "gyro_bias":
        np.testing.assert_allclose(got.bg.numpy(), bias_g, atol=3e-3)
    else:
        assert float(got.scale) == 1.0


def test_imu_stream_matches_the_euroc_writer(tmp_path):
    """utils/synthetic_dataset.py::imu_stream against the mav0/imu0/data.csv
    of the reference's write_euroc_sequence(with_imu=True), on a tiny camera
    and 6 frames, with a lever-arm rig, noise and biases: within 1e-9 (the
    CSV's 9 decimals)."""
    from orb_slam3_modified_tpu.cameras import Camera as JCamera
    from orb_slam3_modified_tpu.utils.synthetic_dataset import write_euroc_sequence
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import imu_between, imu_stream

    T_bc = np.eye(4)
    T_bc[:3, :3] = [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]]
    T_bc[:3, 3] = [0.05, -0.02, 0.01]
    kw = dict(T_bc=T_bc, gyro_noise_std=1e-3, acc_noise_std=1e-2, gyro_bias=(0.01, 0.0, 0.0),
              acc_bias=(0.0, 0.1, 0.0))
    write_euroc_sequence(str(tmp_path),
                         JCamera.pinhole(60.0, 60.0, 32.0, 24.0, width=64, height=48),
                         n_frames=6, with_imu=True, **kw)
    rows = np.loadtxt(os.path.join(tmp_path, "mav0", "imu0", "data.csv"), delimiter=",",
                      skiprows=1)
    ts, gyro, acc = imu_stream(6, **kw)
    assert rows.shape == (len(ts), 7)
    np.testing.assert_allclose(ts, rows[:, 0] * 1e-9, atol=1e-9)
    np.testing.assert_allclose(gyro, rows[:, 1:4], atol=1e-9)
    np.testing.assert_allclose(acc, rows[:, 4:7], atol=1e-9)
    # frame 1's samples: (0, 0.05], dt 0.005 each from the previous sample
    a1, g1, d1 = imu_between(ts, gyro, acc, 0.0, 0.05)
    assert len(d1) == 10 and np.allclose(d1, 0.005)
    a0, _, d0 = imu_between(ts, gyro, acc, None, 0.0)
    assert len(d0) == 1 and d0[0] == 0.0
