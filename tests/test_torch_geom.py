"""Port parity: triangulation and the two-view initializer, JAX vs torch.

Scenes are those of tests/test_geom.py (reference make_scene). The port
draws its minimal sets from a torch.Generator; here its draw is replaced by
the sets the JAX function draws for the same key (two_view's
_sample_minimal_sets on the split keys), so both packages score the same
hypotheses. Gates: triangulate_dlt within DLT_TOL: both packages solve
float32 4x4 eigenproblems with different algorithms (LAPACK syevd, XLA's
own), each about 3e-5 m from the exact points of the noiseless scene, and
4.2e-5 m apart at most; reconstruct_two_views gives the same success, good mask and
used_homography, and R, t within POSE_TOL, on the noiseless and the planar
scene. On the noisy scene (0.5 px) the float32 8-point eigensolve is
ill-conditioned: one and the same minimal set gives essential matrices
2e-3 apart in the two libraries, so the F inlier sets and the triangulated
good masks differ at the threshold edges; there the gate is NOISY_TOL
(measured: R 2.7e-4, unit t 1.7e-3, 9 of 300 good flags). The SVD factors
are not compared: their signs differ between libraries, and cheirality
selection makes the outcome the same.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.cameras import in_image, project, unproject
from orb_slam3_modified_tpu.geom import projection_matrix, reconstruct_two_views, triangulate_dlt
from orb_slam3_modified_tpu.geom import two_view as jtv
from orb_slam3_modified_tpu.lie.se3 import SE3 as JSE3
from orb_slam3_modified_tpu.utils.synthetic import make_scene
from orb_slam3_modified_tpu_torch.geom import triangulation as tt
from orb_slam3_modified_tpu_torch.geom import two_view as ttv
from orb_slam3_modified_tpu_torch.lie.se3 import SE3

torch.set_num_threads(2)
DLT_TOL = 1e-4  # relative, and absolute in meters
POSE_TOL = 1e-4
NOISY_TOL = {"R": 1e-3, "t": 5e-3, "good_flags": 0.05}  # see the module docstring


def _unit_plane(cam, uv):
    ray = np.asarray(unproject(cam, jnp.asarray(uv)))
    return (ray[..., :2] / ray[..., 2:3]).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.mark.parametrize("noise_px,sweep", [(0.0, np.pi / 8), (0.5, np.pi / 6)])
def test_triangulate_dlt_matches_reference(noise_px, sweep):
    scene = make_scene(n_points=256, n_frames=2, noise_px=noise_px, sweep=sweep)
    x0, x1 = _unit_plane(scene.cam, scene.uv[0]), _unit_plane(scene.cam, scene.uv[1])
    P = [np.asarray(jnp.broadcast_to(projection_matrix(JSE3(scene.T_cw.R[i], scene.T_cw.t[i])),
                                     (256, 3, 4))) for i in (0, 1)]
    want = np.asarray(triangulate_dlt(*(jnp.asarray(p) for p in P), jnp.asarray(x0), jnp.asarray(x1)))
    got = tt.triangulate_dlt(_t(P[0]), _t(P[1]), _t(x0), _t(x1)).numpy()
    both = scene.visible[0] & scene.visible[1]
    np.testing.assert_allclose(got[both], want[both], rtol=DLT_TOL, atol=DLT_TOL)
    # the projection matrix and the acceptance gates of the port
    T0 = SE3(_t(scene.T_cw.R[0]), _t(scene.T_cw.t[0]))
    np.testing.assert_array_equal(tt.projection_matrix(T0).numpy(), P[0][0])
    ok, _, e1, _ = tt.depth_and_reproj_checks(
        T0, SE3(_t(scene.T_cw.R[1]), _t(scene.T_cw.t[1])), torch.from_numpy(got),
        _t(x0), _t(x1), 4.0 / 458.0**2)
    assert ok.numpy()[both].mean() > 0.9


def _two_view_scene(noise_px, planar=False, sweep=np.pi / 10, n=300):
    """tests/test_geom.py::TestTwoView._run's scenes."""
    scene = make_scene(n_points=n, n_frames=2, noise_px=noise_px, sweep=sweep)
    if planar:
        rng = np.random.default_rng(3)
        pts = rng.uniform(-2, 2, size=(n, 3)).astype(np.float32)
        pts[:, 2] = 0.3 * pts[:, 0] - 0.1 * pts[:, 1]
        scene = make_scene(n_points=n, n_frames=2, noise_px=noise_px, sweep=sweep)._replace(points=pts)
        pc = JSE3(scene.T_cw.R[:, None], scene.T_cw.t[:, None]).apply(jnp.asarray(pts)[None])
        uv = project(scene.cam, pc)
        vis = np.asarray(in_image(scene.cam, uv, 1.0)) & (np.asarray(pc[..., 2]) > 0.2)
        uv = np.asarray(uv) + rng.normal(0, noise_px, uv.shape).astype(np.float32)
        scene = scene._replace(uv=uv.astype(np.float32), visible=vis)
    x0, x1 = _unit_plane(scene.cam, scene.uv[0]), _unit_plane(scene.cam, scene.uv[1])
    return x0, x1, scene.visible[0] & scene.visible[1]


def _reference_sets(mask, key):
    kE, kH = jax.random.split(key)
    m = jnp.asarray(mask)
    return {8: np.asarray(jtv._sample_minimal_sets(kE, m, jtv.NUM_HYP, 8)),
            4: np.asarray(jtv._sample_minimal_sets(kH, m, jtv.NUM_HYP, 4))}


@pytest.mark.parametrize("case", ["noiseless", "noisy", "planar", "no_parallax"])
def test_reconstruct_two_views_matches_reference(case):
    noise, planar, sweep = {"noiseless": (0.0, False, np.pi / 10), "noisy": (0.5, False, np.pi / 10),
                            "planar": (0.3, True, np.pi / 10),
                            "no_parallax": (0.5, False, 0.0005)}[case]
    x0, x1, mask = _two_view_scene(noise, planar, sweep)
    key = jax.random.PRNGKey(0)
    want = reconstruct_two_views(jnp.asarray(x0), jnp.asarray(x1), jnp.asarray(mask), 458.0, key)
    sets = _reference_sets(mask, key)

    def injected(generator, m, n_sets, set_size):
        return torch.from_numpy(sets[set_size].astype(np.int64))

    with mock.patch.object(ttv, "_sample_minimal_sets", injected):
        got = ttv.reconstruct_two_views(_t(x0), _t(x1), torch.from_numpy(mask), 458.0,
                                        torch.Generator().manual_seed(0))
    assert bool(got.success) == bool(want.success)
    assert bool(got.used_homography) == bool(want.used_homography)
    good, want_good = got.valid.numpy(), np.asarray(want.valid)
    if case == "no_parallax":
        assert not bool(got.success)
        return
    assert bool(got.success)
    if case == "noisy":
        assert (good != want_good).mean() <= NOISY_TOL["good_flags"]
        np.testing.assert_allclose(got.T_21.R.numpy(), np.asarray(want.T_21.R), atol=NOISY_TOL["R"])
        np.testing.assert_allclose(got.T_21.t.numpy(), np.asarray(want.T_21.t), atol=NOISY_TOL["t"])
        return
    np.testing.assert_array_equal(good, want_good)
    assert int(got.n_good) == int(want.n_good)
    np.testing.assert_allclose(got.T_21.R.numpy(), np.asarray(want.T_21.R), atol=POSE_TOL)
    np.testing.assert_allclose(got.T_21.t.numpy(), np.asarray(want.T_21.t), atol=POSE_TOL)
    np.testing.assert_allclose(got.points.numpy()[good], np.asarray(want.points)[good],
                               rtol=POSE_TOL, atol=POSE_TOL)


def test_two_view_own_draws_repeatable():
    """The port's own draw: a seeded generator gives the same result twice,
    and it still recovers the pose of the noisy scene."""
    x0, x1, mask = _two_view_scene(0.5)
    args = (_t(x0), _t(x1), torch.from_numpy(mask), 458.0)
    a = ttv.reconstruct_two_views(*args, torch.Generator().manual_seed(7))
    b = ttv.reconstruct_two_views(*args, torch.Generator().manual_seed(7))
    assert bool(a.success) and torch.equal(a.T_21.R, b.T_21.R) and torch.equal(a.valid, b.valid)
