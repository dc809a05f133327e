"""Port parity: SO(3) / SE(3) and the camera models, JAX vs torch.

The same numpy batches go through both packages. Tolerance: 1e-5 relative
(plus 1e-6 absolute for entries near zero) in float32, the rounding of a
few chained float32 products that the two runtimes order differently.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.cameras import models as jcam
from orb_slam3_modified_tpu.lie import se3 as jse3
from orb_slam3_modified_tpu.lie import so3 as jso3
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.cameras import models as tcam
from orb_slam3_modified_tpu_torch.lie import se3 as tse3
from orb_slam3_modified_tpu_torch.lie import so3 as tso3

torch.set_num_threads(2)
RTOL, ATOL = 1e-5, 1e-6


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol)


def _w(seed, n=64, scale=2.0):
    return (np.random.default_rng(seed).standard_normal((n, 3)) * scale).astype(np.float32)


def _tangents():
    """Generic, small-angle (Taylor branch) and near-pi rotation vectors."""
    axes = _w(3, 16, 1.0)
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    return np.concatenate([_w(1), _w(2, 16, 1e-4), axes * np.float32(np.pi - 1e-3)])


class TestSO3Parity:
    def test_exp(self):
        w = _tangents()
        close(tso3.exp(torch.from_numpy(w)), jso3.exp(jnp.asarray(w)))

    def test_log(self):
        R = np.array(jso3.exp(jnp.asarray(_tangents())))
        close(tso3.log(torch.from_numpy(R)), jso3.log(jnp.asarray(R)), atol=1e-5)

    def test_normalize(self):
        rng = np.random.default_rng(4)
        R = np.array(jso3.exp(jnp.asarray(_w(5)))) + 1e-3 * rng.standard_normal((64, 3, 3))
        R = R.astype(np.float32)
        close(tso3.normalize(torch.from_numpy(R)), jso3.normalize(jnp.asarray(R)))

    def test_jacobians(self):
        w = _tangents()
        close(tso3.left_jacobian(torch.from_numpy(w)), jso3.left_jacobian(jnp.asarray(w)))
        close(tso3.left_jacobian_inv(torch.from_numpy(w)),
              jso3.left_jacobian_inv(jnp.asarray(w)), atol=1e-4)


def _xi(seed, n=32):
    rng = np.random.default_rng(seed)
    return np.concatenate(
        [rng.standard_normal((n, 3)) * 2.0, rng.standard_normal((n, 3)) * 0.8], axis=-1
    ).astype(np.float32)


class TestSE3Parity:
    def test_exp_compose_inverse_apply(self):
        a, b = _xi(6), _xi(7)
        p = np.random.default_rng(8).standard_normal((32, 3)).astype(np.float32)
        Ja, Jb = jse3.exp(jnp.asarray(a)), jse3.exp(jnp.asarray(b))
        Ta, Tb = tse3.exp(torch.from_numpy(a)), tse3.exp(torch.from_numpy(b))
        close(Ta.R, Ja.R)
        close(Ta.t, Ja.t)
        Jc, Tc = Ja @ Jb.inverse(), Ta @ Tb.inverse()
        close(Tc.R, Jc.R)
        close(Tc.t, Jc.t, atol=1e-5)
        close(Tc.apply(torch.from_numpy(p)), Jc.apply(jnp.asarray(p)), atol=1e-5)

    def test_log(self):
        a = _xi(9)
        close(tse3.log(tse3.exp(torch.from_numpy(a))), jse3.log(jse3.exp(jnp.asarray(a))),
              atol=1e-4)

    def test_exp_log_roundtrip(self):
        a = _xi(10) * 0.3
        T = tse3.exp(torch.from_numpy(a))
        T2 = tse3.exp(tse3.log(T))
        close(T2.R, T.R, atol=1e-5)
        close(T2.t, T.t, atol=1e-5)


def _points(seed, n=256):
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.3, 10.0, (n, 1))
    return np.concatenate([rng.standard_normal((n, 2)) * 0.4 * z, z], -1).astype(np.float32)


CAMS = {
    "pinhole": jcam.Camera.pinhole(458.654, 457.296, 367.215, 248.375, width=752, height=480),
    "kb8": jcam.Camera.kb8(190.978, 190.973, 254.932, 256.897, 0.00348238, 0.000715034,
                           -0.00205323, 0.000202936, width=512, height=512),
}


class TestCameraParity:
    @pytest.mark.parametrize("kind", sorted(CAMS))
    def test_project_unproject_jac(self, kind):
        jc = CAMS[kind]
        tc = convert.camera(jc, device="cpu")
        pc = _points(11)
        uv = np.array(jcam.project(jc, jnp.asarray(pc)))
        close(tcam.project(tc, torch.from_numpy(pc)), uv, atol=1e-4)
        close(tcam.project_jac(tc, torch.from_numpy(pc)), jcam.project_jac(jc, jnp.asarray(pc)),
              atol=1e-4)
        close(tcam.unproject(tc, torch.from_numpy(uv)), jcam.unproject(jc, jnp.asarray(uv)))
        close(tcam.project_np(tc, pc.astype(np.float64)), jcam.project_np(jc, pc.astype(np.float64)))
        close(tcam.unproject_np(tc, uv.astype(np.float64)), jcam.unproject_np(jc, uv.astype(np.float64)))

    def test_pinhole_constructor(self):
        tc = tcam.Camera.pinhole(458.654, 457.296, 367.215, 248.375, 752, 480, device="cpu")
        np.testing.assert_array_equal(tc.params.numpy(), np.asarray(CAMS["pinhole"].params))

    def test_pinhole_roundtrip(self):
        tc = convert.camera(CAMS["pinhole"], device="cpu")
        pc = torch.from_numpy(_points(12))
        rays = tcam.unproject(tc, tcam.project(tc, pc))
        close(rays * pc[:, 2:3], pc, atol=1e-4)
