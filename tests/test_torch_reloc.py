"""Port parity for relocalization: the 6-point DLT, PnP RANSAC and
relocalize, JAX vs torch on the CPU.

The cases of tests/test_reloc.py (clean, outliers, degenerate), with the
reference's minimal sets injected through
loop/sim3_solver.py::_sample_minimal_sets. A six-point DLT from noisy pixels
is ill-conditioned (A^T A squares it): in float32 the reference's
hypotheses stray from the exact DLT of the same points, so which
hypothesis wins depends on the solver's rounding. The parity is therefore
held in float64 on both sides (jax.enable_x64): every hypothesis from six
distinct points within 1e-6 (a set that repeats a point, or collinear
points, leave A^T A rank-deficient and its eigenvector arbitrary), the same success, and, when both winners
come from distinct points, the same inlier mask and count and the pose
within 1e-6. In float32 (the port takes the
eigenvector in float64 always) both packages must meet tests/test_reloc.py's
gates against the true pose. torch.linalg.eigh may return eigenvectors of
the other sign; the DLT fixes the sign by det(M) > 0. relocalize runs on a
map the reference's tracker built: with the reference's PnP result injected,
the same observations and the polished pose within 1e-4; with its own, the
right place.
"""
import numpy as np
import pytest
import torch
from unittest import mock

import jax
import jax.numpy as jnp

from orb_slam3_modified_tpu.cameras import Camera as JCamera
from orb_slam3_modified_tpu.cameras import project as jproject
from orb_slam3_modified_tpu.lie import so3 as jso3
from orb_slam3_modified_tpu.lie.se3 import SE3 as JSE3
from orb_slam3_modified_tpu.loop import relocalization as jreloc
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.lie.se3 import SE3
from orb_slam3_modified_tpu_torch.loop import relocalization as treloc
from orb_slam3_modified_tpu_torch.loop import sim3_solver as tss

torch.set_num_threads(2)
JCAM = JCamera.pinhole(458.654, 457.296, 367.215, 248.375, width=752, height=480)
TCAM = convert.camera(JCAM, device="cpu")
R_TRUE = np.asarray(jso3.exp(jnp.asarray([0.1, -0.2, 0.15])))
T_TRUE = np.array([0.3, -0.1, 0.2], np.float32)


def jax_minimal_sets(key, valid, n_sets, set_size):
    logits = jnp.where(jnp.asarray(valid.detach().cpu().numpy()), 0.0, -jnp.inf)
    sets = jax.random.categorical(jax.random.PRNGKey(int(key)), logits, shape=(n_sets, set_size))
    return torch.from_numpy(np.asarray(sets).astype(np.int64))


def _case(name):
    """tests/test_reloc.py's scenes: (pw, uv, key)."""
    if name == "degenerate":  # collinear points
        pw = np.zeros((50, 3), np.float32)
        pw[:, 0] = np.linspace(-1, 1, 50)
        pw[:, 2] = 5.0
        return pw, np.asarray(jproject(JCAM, jnp.asarray(pw))).astype(np.float32), 2
    n, noise, outliers, seed = {"clean": (120, 0.5, 0, 0), "outliers": (120, 0.5, 30, 1),
                                "masked": (200, 0.5, 40, 4)}[name]
    rng = np.random.default_rng(seed)
    pw = np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(4, 10, (n, 1))], axis=1).astype(np.float32)
    uv = np.array(jproject(JCAM, jnp.asarray(pw @ R_TRUE.T + T_TRUE)))
    uv += rng.normal(0, noise, uv.shape)
    if outliers:
        sel = rng.choice(n, outliers, replace=False)
        uv[sel] += rng.uniform(30, 100, (outliers, 2))
    return pw, uv.astype(np.float32), seed


@pytest.mark.parametrize("name", ["clean", "outliers", "masked", "degenerate"])
def test_pnp_ransac_matches_reference(name):
    pw, uv, key = _case(name)
    valid = np.ones(len(pw), bool)
    if name == "masked":
        valid[::4] = False
    with jax.enable_x64(True):  # the draws too: both sides inside
        want = jreloc.pnp_ransac(JCAM, jnp.asarray(pw, jnp.float64), jnp.asarray(uv, jnp.float64),
                                 jnp.asarray(valid), jax.random.PRNGKey(key))
        with mock.patch.object(tss, "_sample_minimal_sets", jax_minimal_sets):
            got = treloc.pnp_ransac(TCAM, torch.from_numpy(pw.astype(np.float64)),
                                    torch.from_numpy(uv.astype(np.float64)), torch.from_numpy(valid), key)
        sets = jax_minimal_sets(key, torch.from_numpy(valid), treloc.N_HYP, treloc.MIN_SET).numpy()
        rays = treloc.unproject(TCAM, torch.from_numpy(uv.astype(np.float64))).numpy()
        rays = rays[:, :2] / rays[:, 2:3]
        R_j, t_j = (np.asarray(x) for x in jreloc._p6p_dlt(jnp.asarray(pw[sets], jnp.float64),
                                                           jnp.asarray(rays[sets])))
        R_t, t_t = (x.numpy() for x in treloc._p6p_dlt(torch.from_numpy(pw[sets].astype(np.float64)),
                                                       torch.from_numpy(rays[sets])))
    # a set that repeats a point leaves a null space of A^T A, whose
    # eigenvector each solver picks its own way: only the others are held
    distinct = np.array([len(set(r)) == len(r) for r in sets]) & (name != "degenerate")
    np.testing.assert_allclose(R_t[distinct], R_j[distinct], atol=1e-6)
    np.testing.assert_allclose(t_t[distinct], t_j[distinct], atol=1e-6)
    assert bool(got.success) == bool(want.success)
    best_t = int(np.argmin(np.abs(t_t - got.T_cw.t.numpy()).max(axis=1)))
    best_j = int(np.argmin(np.abs(t_j - np.asarray(want.T_cw.t)).max(axis=1)))
    if distinct[best_t] and distinct[best_j]:  # both winners well posed: the same one
        assert int(got.n_inliers) == int(want.n_inliers)
        assert np.array_equal(got.inliers.numpy(), np.asarray(want.inliers))
        np.testing.assert_allclose(got.T_cw.R.numpy(), np.asarray(want.T_cw.R), atol=1e-6)
        np.testing.assert_allclose(got.T_cw.t.numpy(), np.asarray(want.T_cw.t), atol=1e-6)
    # float32, each package's own rounding: tests/test_reloc.py's gates
    want = jreloc.pnp_ransac(JCAM, jnp.asarray(pw), jnp.asarray(uv), jnp.asarray(valid),
                             jax.random.PRNGKey(key))
    with mock.patch.object(tss, "_sample_minimal_sets", jax_minimal_sets):
        got = treloc.pnp_ransac(TCAM, torch.from_numpy(pw), torch.from_numpy(uv),
                                torch.from_numpy(valid), key)
    assert np.isfinite(got.T_cw.t.numpy()).all()
    if name == "degenerate":  # collinear points: any finite pose will do
        return
    for res in (got, want):
        assert bool(res.success)
        dR = np.asarray(res.T_cw.R) @ R_TRUE.T
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        assert ang < 2.0, ang
        assert np.linalg.norm(np.asarray(res.T_cw.t) - T_TRUE) < 0.1


def test_p6p_dlt_does_not_depend_on_the_eigenvector_sign():
    """eigh may return either sign of each eigenvector (torch's CUDA solver
    differs from its CPU one): the DLT's (R, t) must not change."""
    pw, uv, _ = _case("clean")
    rays = ((uv - [367.215, 248.375]) / [458.654, 457.296]).astype(np.float32)
    idx = np.random.default_rng(0).integers(0, len(pw), (64, 6))
    R_a, t_a = treloc._p6p_dlt(torch.from_numpy(pw[idx]), torch.from_numpy(rays[idx]))
    eigh = torch.linalg.eigh
    flip = torch.where(torch.arange(64) % 2 == 0, -1.0, 1.0).to(torch.float64)[:, None, None]
    with mock.patch.object(torch.linalg, "eigh", lambda a: (eigh(a)[0], eigh(a)[1] * flip)):
        R_b, t_b = treloc._p6p_dlt(torch.from_numpy(pw[idx]), torch.from_numpy(rays[idx]))
    assert torch.equal(R_a, R_b) and torch.equal(t_a, t_b)
    assert (torch.linalg.det(R_a) > 0.99).all()


def test_relocalize_matches_reference():
    """A map from the reference's tracker (the orbit and ring world of
    tests/test_e2e_loop.py, 30 frames), both keyframe databases filled with
    its keyframes, then a lost frame near keyframe 2's view relocalized by
    both packages: with the reference's PnP result injected, the same
    observations and the polished pose within 1e-4; with the port's own
    RANSAC, as many observations within 10% and the pose among the
    keyframes around the true frame."""
    from orb_slam3_modified_tpu.bow.kfdb import KeyFrameDatabase as JKFDB
    from orb_slam3_modified_tpu.bow.vocabulary import build_vocabulary as jbuild
    from orb_slam3_modified_tpu.mapping.local_mapper import LocalMapper as JLocalMapper
    from orb_slam3_modified_tpu.mapping.local_mapper import LocalMapperConfig as JLocalMapperConfig
    from orb_slam3_modified_tpu.slam_map.map_state import MapState as JMapState
    from orb_slam3_modified_tpu.tracking.tracker import Tracker as JTracker
    from orb_slam3_modified_tpu.tracking.tracker import TrackerConfig as JTrackerConfig
    from orb_slam3_modified_tpu.utils.synthetic import orbit_trajectory
    from orb_slam3_modified_tpu.utils.synthetic_features import SyntheticFeatureWorld
    from orb_slam3_modified_tpu_torch.bow.kfdb import KeyFrameDatabase
    from orb_slam3_modified_tpu_torch.bow.vocabulary import build_vocabulary
    from orb_slam3_modified_tpu_torch.features.extractor import Features
    from orb_slam3_modified_tpu_torch.tracking.tracker import inv_level_sigma2

    world = SyntheticFeatureWorld(n_points=12000, spread=10.0, seed=7, feat_cap=768, noise_px=0.5,
                                  layout="ring")
    T_all = orbit_trajectory(90, radius=4.0, sweep=2.05 * np.pi)
    m = JMapState.create(max_kf=64, max_mp=32768, feat_cap=768)
    cfg = JTrackerConfig(cam=JCAM)
    tracker, mapper = JTracker(cfg, m), JLocalMapper(JLocalMapperConfig(), cfg, m)
    tracker.on_keyframe = mapper.on_keyframe
    for i in range(30):
        f, _ = world.observe(JCAM, JSE3(T_all.R[i], T_all.t[i]), max_feats=600)
        tracker.track(f, ts=i * 0.05)
    jdb = JKFDB(jbuild(world.desc[:4000], k=8, depth=3, seed=1), m.kf_valid.shape[0])
    tdb = KeyFrameDatabase(build_vocabulary(world.desc[:4000], k=8, depth=3, seed=1), m.kf_valid.shape[0])
    for k in m.keyframe_indices():
        w = jdb.voc.transform_np(m.kf_desc[k][m.kf_feat_valid[k]])
        jdb.add(int(k), w)
        tdb.add(int(k), w)
    i = int(m.kf_frame_id[m.keyframe_indices()[2]]) + 1
    feats, _ = world.observe(JCAM, JSE3(T_all.R[i], T_all.t[i]), max_feats=600)
    inv_s2 = inv_level_sigma2()
    want = jreloc.relocalize(JCAM, jdb, jdb.voc, m, feats, inv_s2, 1234)
    tfeats = Features(*(np.array(x) for x in feats))

    def reference_pnp(cam, pw, uv, valid, key):
        r = jreloc.pnp_ransac(JCAM, jnp.asarray(pw.numpy()), jnp.asarray(uv.numpy()),
                              jnp.asarray(valid.numpy()), jax.random.PRNGKey(key))
        return treloc.PnPResult(torch.tensor(bool(r.success)),
                                SE3(torch.from_numpy(np.array(r.T_cw.R)), torch.from_numpy(np.array(r.T_cw.t))),
                                torch.from_numpy(np.array(r.inliers)), torch.tensor(int(r.n_inliers)))

    with mock.patch.object(treloc, "pnp_ransac", reference_pnp):
        got = treloc.relocalize(TCAM, tdb, tdb.voc, m, tfeats, inv_s2, 1234)
    assert want is not None and got is not None
    T, obs = got
    assert np.array_equal(obs, np.asarray(want[1]))
    np.testing.assert_allclose(T.R, np.asarray(want[0].R), atol=1e-4)
    np.testing.assert_allclose(T.t, np.asarray(want[0].t), atol=1e-4)
    T, obs = treloc.relocalize(TCAM, tdb, tdb.voc, m, tfeats, inv_s2, 1234)  # the port's own RANSAC
    assert (obs >= 0).sum() >= 0.9 * (np.asarray(want[1]) >= 0).sum()
    # and it is the right place: the frame's centre against the keyframes'
    kfs = m.keyframe_indices()
    c_est = -T.R.T @ T.t
    c_kf = np.stack([-m.kf_R[k].T @ m.kf_t[k] for k in kfs])
    nearest = int(np.argmin(np.linalg.norm(c_kf - c_est, axis=1)))
    assert abs(int(m.kf_frame_id[kfs[nearest]]) - i) <= 6


def test_relocalize_takes_more_than_512_matches():
    """A keyframe observing ~1,000 points and a frame that matches more than
    PNP_CAP = 512 of them: the reference pads its PnP problem to 512 but
    indexes the untruncated matches with the 512-long inlier mask, an
    IndexError; the port truncates the matches to 512 and relocalizes."""
    from orb_slam3_modified_tpu.bow.kfdb import KeyFrameDatabase as JKFDB
    from orb_slam3_modified_tpu.bow.vocabulary import build_vocabulary as jbuild
    from orb_slam3_modified_tpu.features.extractor import Features as JFeatures
    from orb_slam3_modified_tpu.slam_map.map_state import MapState as JMapState
    from orb_slam3_modified_tpu.utils.synthetic import orbit_trajectory
    from orb_slam3_modified_tpu.utils.synthetic_features import SyntheticFeatureWorld
    from orb_slam3_modified_tpu_torch.bow.kfdb import KeyFrameDatabase
    from orb_slam3_modified_tpu_torch.bow.vocabulary import build_vocabulary
    from orb_slam3_modified_tpu_torch.features.extractor import Features
    from orb_slam3_modified_tpu_torch.tracking.tracker import inv_level_sigma2

    world = SyntheticFeatureWorld(n_points=30000, spread=10.0, seed=7, feat_cap=1024, noise_px=0.5,
                                  desc_flips=1, layout="ring")
    T = orbit_trajectory(90, radius=4.0, sweep=2.05 * np.pi)
    m = JMapState.create(max_kf=8, max_mp=4096, feat_cap=1024)
    f, idx = world.observe(JCAM, JSE3(T.R[0], T.t[0]), max_feats=1000)
    k = m.alloc_keyframe()
    m.kf_R[k], m.kf_t[k] = np.asarray(T.R[0]), np.asarray(T.t[0])
    m.kf_uv[k], m.kf_desc[k] = np.asarray(f.uv), np.asarray(f.desc)
    m.kf_level[k], m.kf_feat_valid[k] = np.asarray(f.level), np.asarray(f.valid)
    mp = m.alloc_points(len(idx))
    m.mp_pos[mp] = world.points[idx]
    m.kf_obs[k, : len(idx)] = mp
    jdb = JKFDB(jbuild(world.desc[:4000], k=8, depth=3, seed=1), 8)
    tdb = KeyFrameDatabase(build_vocabulary(world.desc[:4000], k=8, depth=3, seed=1), 8)
    w = jdb.voc.transform_np(m.kf_desc[k][m.kf_feat_valid[k]])
    jdb.add(k, w)
    tdb.add(k, w)
    frame, _ = world.observe(JCAM, JSE3(T.R[0], T.t[0]), max_feats=1000)
    assert isinstance(frame, JFeatures)
    with pytest.raises(IndexError):
        jreloc.relocalize(JCAM, jdb, jdb.voc, m, frame, inv_level_sigma2(), 5)
    got = treloc.relocalize(TCAM, tdb, tdb.voc, m, Features(*(np.array(x) for x in frame)),
                            inv_level_sigma2(), 5)
    assert got is not None
    T_cw, obs = got
    assert (obs >= 0).sum() >= 400
    np.testing.assert_allclose(T_cw.t, np.asarray(T.t[0]), atol=0.02)
