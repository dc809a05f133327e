"""Port parity: bundle adjustment, JAX vs torch, padded and unpadded.

The problems of tests/test_ba.py (reference make_scene, perturbed poses and
points, one fixed camera; and the same with 10% gross outliers), built once
in numpy and solved by both packages with the reference's LM schedule.
Gates: obs_inlier equal; rotations within TOL; camera centres and points
within TOL after one scale about the fixed camera's centre. A monocular BA
with one fixed camera leaves the scale free (a gauge direction), and the
damped LM step along it is set by float32 noise: the two packages sum the
normal equations in another order (dense einsums in XLA, per-observation
blocks with index_add_ in the port) and land 4.5e-5 apart in scale, while
the centres agree to 4e-6 and the points to 4e-5 of their distance once
that scale is removed (points seen by two or more cameras; a point seen
once is free along its ray). The port also solves each problem
padded by local_mapper._pad_problem (the CPU buckets, and the card's
buckets by asking for a CUDA device): padded cameras fixed, padded points and
observations invalid, so the result is the unpadded one within TOL.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.cameras import Camera as JCamera
from orb_slam3_modified_tpu.lie import se3 as jse3
from orb_slam3_modified_tpu.lie.se3 import SE3 as JSE3
from orb_slam3_modified_tpu.optim.ba import BAProblem as JBAProblem
from orb_slam3_modified_tpu.optim.ba import bundle_adjust as j_bundle_adjust
from orb_slam3_modified_tpu.utils.synthetic import make_scene
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.lie.se3 import SE3np
from orb_slam3_modified_tpu_torch.mapping.local_mapper import _pad_problem
from orb_slam3_modified_tpu_torch.optim.ba import BAProblem, bundle_adjust, to_device

torch.set_num_threads(2)
JCAM = JCamera.pinhole(458.654, 457.296, 367.215, 248.375, width=752, height=480)
TOL = 1e-4


def _centred(R, t, pts):
    """Camera centres and points relative to camera 0's centre."""
    c = -np.einsum("kji,kj->ki", R, t)
    return c - c[0], pts - c[0]


def _assert_same_up_to_scale(got, want, obs_pt):
    (R, t, pts, _), (R_j, t_j, p_j, _) = got, want
    np.testing.assert_allclose(R, R_j, atol=TOL)
    c, p = _centred(R, t, pts)
    c_j, p_j = _centred(R_j, t_j, p_j)
    s = np.sum(c * c_j) / np.sum(c * c)  # the gauge: one scale about camera 0
    assert abs(s - 1.0) < 1e-3
    np.testing.assert_allclose(s * c, c_j, atol=TOL)
    seen = np.bincount(obs_pt, minlength=len(p)) >= 2
    rel = np.linalg.norm(s * p - p_j, axis=-1) / np.linalg.norm(p_j, axis=-1)
    assert rel[seen].max() < TOL, rel[seen].max()


def _problem(outliers, seed=0, n_pts=200, n_kf=6):
    """tests/test_ba.py::build_problem, as numpy arrays."""
    scene = make_scene(n_points=n_pts, n_frames=n_kf, noise_px=0.3 if outliers else 0.5, seed=seed)
    rng = np.random.default_rng(seed + 10)
    kk, pp = np.nonzero(scene.visible)
    uv = scene.uv[kk, pp].astype(np.float32)
    xi = rng.normal(0, 0.02, (n_kf, 6)).astype(np.float32)
    xi[0] = 0
    T = jse3.exp(jnp.asarray(xi)) @ JSE3(scene.T_cw.R, scene.T_cw.t)
    pts = (scene.points + rng.normal(0, 0.05, scene.points.shape)).astype(np.float32)
    if outliers:
        r2 = np.random.default_rng(42)
        out_idx = r2.choice(len(uv), len(uv) // 10, replace=False)
        uv[out_idx] += r2.uniform(15, 60, (len(out_idx), 2)).astype(np.float32)
    fixed = np.zeros(n_kf, bool)
    fixed[0] = True
    return BAProblem(
        T_cw=SE3np(np.asarray(T.R), np.asarray(T.t)), cam_fixed=fixed, points=pts,
        pt_valid=np.ones(n_pts, bool), obs_cam=kk.astype(np.int32), obs_pt=pp.astype(np.int32),
        obs_uv=uv, obs_inv_s2=np.ones(len(kk), np.float32), obs_valid=np.ones(len(kk), bool),
    )


def _reference(prob):
    jp = JBAProblem(JSE3(jnp.asarray(prob.T_cw.R), jnp.asarray(prob.T_cw.t)),
                    *(jnp.asarray(x) for x in prob[1:9]))
    res = j_bundle_adjust(jp, JCAM)
    return [np.asarray(x) for x in (res.T_cw.R, res.T_cw.t, res.points, res.obs_inlier)]


def _port(prob, K, P, O):
    res = bundle_adjust(to_device(prob, "cpu"), convert.camera(JCAM, device="cpu"))
    return [x.numpy() for x in (res.T_cw.R[:K], res.T_cw.t[:K], res.points[:P], res.obs_inlier[:O])]


@pytest.mark.parametrize("outliers", [False, True])
def test_bundle_adjust_matches_reference_padded_and_unpadded(outliers):
    prob = _problem(outliers)
    K, P, O = len(prob.cam_fixed), len(prob.points), len(prob.obs_cam)
    R_j, t_j, p_j, inl_j = _reference(prob)
    padded_cpu = _pad_problem(prob, "cpu")
    padded_card = _pad_problem(prob, "cuda")  # the card's buckets, solved here on the CPU
    assert padded_cpu.points.shape[0] == 4096 and padded_card.obs_cam.shape[0] == 8192
    for p in (prob, padded_cpu, padded_card):
        got = _port(p, K, P, O)
        np.testing.assert_array_equal(got[3], inl_j)
        _assert_same_up_to_scale(got, (R_j, t_j, p_j, inl_j), prob.obs_pt)
        np.testing.assert_allclose(got[0][0], prob.T_cw.R[0], atol=1e-6)  # the fixed camera
        np.testing.assert_allclose(got[1][0], prob.T_cw.t[0], atol=1e-6)
    if outliers:
        assert (~inl_j).sum() >= O // 10 * 0.8


def test_pad_problem_masks_the_padding():
    """Accelerator buckets grow past the static pads for a large problem,
    with the real rows kept and the padding masked (tests/test_map_state.py's
    case, on the port)."""
    K, P, O = 40, 9000, 20000
    prob = BAProblem(SE3np(np.tile(np.eye(3, dtype=np.float32), (K, 1, 1)),
                           np.zeros((K, 3), np.float32)),
                     np.zeros(K, bool), np.zeros((P, 3), np.float32), np.ones(P, bool),
                     np.zeros(O, np.int32), np.zeros(O, np.int32), np.zeros((O, 2), np.float32),
                     np.ones(O, np.float32), np.ones(O, bool))
    out = _pad_problem(prob, "cuda")
    assert out.T_cw.t.shape[0] >= K and out.points.shape[0] >= P and out.obs_cam.shape[0] >= O
    assert out.obs_valid[:O].all() and not out.obs_valid[O:].any()
    assert not out.pt_valid[P:].any() and out.cam_fixed[K:].all()
