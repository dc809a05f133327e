"""Port parity: ORB extraction, JAX vs torch, on a small rendered frame.

Gates and their tolerances:
- level 0 (the frame itself): FAST hi/lo maps, NMS maps and the selected
  keypoints (position, response, validity) are exactly equal: integer-valued
  float32 arithmetic, no rounding;
- descriptors, given the same level image, keypoints and angles, are equal
  bit for bit except for comparisons whose two samples differ by less than
  BRIEF_EPS grey levels: the port sums the bilinear terms in another order
  (no matmul), which moves a sample by ~1e-5;
- levels >= 1: the pyramid is a float32 resize whose sums round differently
  (max |delta| ~2e-4 grey levels), which can flip a FAST threshold test or a
  top-k tie, so only the share of common keypoints is gated.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.features import extractor as jext
from orb_slam3_modified_tpu.ops import brief as jbrief
from orb_slam3_modified_tpu.ops import fast as jfast
from orb_slam3_modified_tpu.ops import image as jimage
from orb_slam3_modified_tpu.ops import orientation as jorient
from orb_slam3_modified_tpu.utils.synthetic_dataset import (
    render_textured_scene as j_render_textured_scene,
)
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.cameras import Camera
from orb_slam3_modified_tpu_torch.features import extractor as text
from orb_slam3_modified_tpu_torch.ops import brief as tbrief
from orb_slam3_modified_tpu_torch.ops import fast as tfast
from orb_slam3_modified_tpu_torch.ops import image as timage
from orb_slam3_modified_tpu_torch.ops import orientation as torient
from orb_slam3_modified_tpu_torch.ops.hamming import hamming_matrix, hamming_pairs
from orb_slam3_modified_tpu_torch.utils.synthetic import orbit_trajectory
from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import (
    camera_rays,
    make_texture,
    render_textured_scene,
)

torch.set_num_threads(2)
W, H = 320, 240
BRIEF_EPS = 1e-3  # grey levels
CFG = jext.ExtractorConfig(n_features=256, n_levels=4)
MIN_OVERLAP = 0.9  # measured 1.0 at every level on this frame


def _cam():
    k = W / 752
    return Camera.pinhole(458.654 * k, 457.296 * k, 367.215 * k, 248.375 * k, W, H, device="cpu")


@pytest.fixture(scope="module")
def frame():
    T = orbit_trajectory(400, radius=4.0, sweep=np.pi / 2)
    T44 = np.eye(4)
    T44[:3, :3] = T.R[40].numpy()
    T44[:3, 3] = T.t[40].numpy()
    img = render_textured_scene(T44, _cam(), make_texture(0, 96, 1024), 2.0, 10.0)
    return np.clip(img, 0, 255).astype(np.uint8).astype(np.float32)


@pytest.fixture(scope="module")
def both(frame):
    jf = jext.extract(jnp.asarray(frame), CFG)
    ex = text.ORBExtractor(convert.extractor_config(CFG), H, W, device="cpu")
    return jf, ex(torch.from_numpy(frame)[None])


def test_render_matches_reference(frame):
    T = orbit_trajectory(400, radius=4.0, sweep=np.pi / 2)
    T44 = np.eye(4)
    T44[:3, :3] = T.R[40].numpy()
    T44[:3, 3] = T.t[40].numpy()
    tex = make_texture(0, 96, 1024)
    cam = _cam()
    ref = j_render_textured_scene(T44, cam, tex, 2.0, 10.0, rays_c=camera_rays(cam))
    np.testing.assert_array_equal(render_textured_scene(T44, cam, tex, 2.0, 10.0), ref)


def test_level0_fast_and_nms_maps_exact(frame):
    j_hi, j_lo = jfast.fast_score_maps(jnp.asarray(frame), CFG.ini_th, CFG.min_th)
    t_hi, t_lo = tfast.fast_score_maps(torch.from_numpy(frame)[None], CFG.ini_th, CFG.min_th)
    np.testing.assert_array_equal(t_hi[0].numpy(), np.asarray(j_hi))
    np.testing.assert_array_equal(t_lo[0].numpy(), np.asarray(j_lo))
    assert (t_hi > 0).sum() > 100
    np.testing.assert_array_equal(
        tfast.nonmax_3x3(t_hi)[0].numpy(), np.asarray(jfast.nonmax_3x3(j_hi)))
    np.testing.assert_array_equal(
        tfast.nonmax_3x3(t_lo)[0].numpy(), np.asarray(jfast.nonmax_3x3(j_lo)))


def test_level0_keypoints_exact(both):
    jf, tf = both
    lvl0 = np.asarray(jf.level) == 0
    assert lvl0.sum() == text.level_budgets(convert.extractor_config(CFG))[0]
    np.testing.assert_array_equal(tf.level[0].numpy(), np.asarray(jf.level))
    np.testing.assert_array_equal(tf.uv[0].numpy()[lvl0], np.asarray(jf.uv)[lvl0])
    np.testing.assert_array_equal(tf.response[0].numpy()[lvl0], np.asarray(jf.response)[lvl0])
    np.testing.assert_array_equal(tf.valid[0].numpy()[lvl0], np.asarray(jf.valid)[lvl0])


def test_pyramid_and_blur(frame):
    pj = jimage.build_pyramid(jnp.asarray(frame), CFG.n_levels, CFG.scale)
    img = torch.from_numpy(frame)[None]
    for lvl, (lh, lw) in enumerate(timage.pyramid_shapes(H, W, CFG.n_levels, CFG.scale)[1:], 1):
        pt = timage.resize(img, torch.from_numpy(timage.resize_weights(H, lh)),
                           torch.from_numpy(timage.resize_weights(W, lw)))
        np.testing.assert_allclose(pt[0].numpy(), np.asarray(pj[lvl]), atol=1e-3)
    blur = timage.gaussian_blur(img, torch.from_numpy(timage.gauss_kernel1d(7, 2.0)))
    np.testing.assert_array_equal(blur[0].numpy(), np.asarray(jimage.gaussian_blur(jnp.asarray(frame))))


def test_descriptors_given_reference_keypoints_and_angles(frame, both):
    """Every level: the reference's level image, keypoints and angles go
    through both descriptor paths; bits agree except near-tie comparisons."""
    jf, _ = both
    pj = jimage.build_pyramid(jnp.asarray(frame), CFG.n_levels, CFG.scale)
    lv, ok = np.asarray(jf.level), np.asarray(jf.valid)
    pattern = torch.from_numpy(tbrief.brief_pattern())
    n_cmp = n_masked = 0
    for lvl in range(CFG.n_levels):
        sel = (lv == lvl) & ok
        s = CFG.scale**lvl
        xy = np.round(np.asarray(jf.uv)[sel] / s).astype(np.int32)
        ang = np.asarray(jf.angle)[sel]
        blurred = np.array(jimage.gaussian_blur(pj[lvl]))
        ref = np.asarray(jbrief.brief_descriptors(
            jnp.asarray(blurred), jnp.asarray(xy[:, 1]), jnp.asarray(xy[:, 0]), jnp.asarray(ang)))
        patches = torient.gather_patches(
            torch.from_numpy(blurred)[None], torch.from_numpy(xy[None, :, 1]),
            torch.from_numpy(xy[None, :, 0]), tbrief.GATHER_R)
        vals = tbrief.brief_values(patches, torch.from_numpy(ang)[None], pattern)[0]
        bits = (vals[..., 0] < vals[..., 1]).numpy()
        ref_bits = ((ref[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(-1, 256)
        near = (vals[..., 0] - vals[..., 1]).abs().numpy() < BRIEF_EPS
        np.testing.assert_array_equal(bits[~near], ref_bits[~near].astype(bool))
        n_cmp += bits.size
        n_masked += int(near.sum())
        # the extractor's own descriptors carry the same bits
        np.testing.assert_array_equal(
            convert.desc_to_uint32(tbrief.pack_bits(torch.from_numpy(ref_bits.astype(bool)))), ref)
    assert n_cmp > 200 * 256
    assert n_masked <= n_cmp * 1e-3, f"{n_masked}/{n_cmp} comparisons within {BRIEF_EPS}"


def test_angles_given_reference_keypoints(frame, both):
    jf, tf = both
    lvl0 = (np.asarray(jf.level) == 0) & np.asarray(jf.valid)
    xy = np.asarray(jf.uv)[lvl0].astype(np.int32)
    blurred = jimage.gaussian_blur(jnp.asarray(frame))
    ref = np.asarray(jorient.ic_angles(blurred, jnp.asarray(xy[:, 1]), jnp.asarray(xy[:, 0])))
    out = torient.ic_angles(torch.tensor(np.asarray(blurred))[None],
                            torch.from_numpy(xy[None, :, 1]), torch.from_numpy(xy[None, :, 0]))
    np.testing.assert_allclose(out[0].numpy(), ref, atol=1e-4)
    np.testing.assert_allclose(tf.angle[0].numpy()[lvl0], np.asarray(jf.angle)[lvl0], atol=1e-4)


def test_coarse_level_keypoint_overlap(both):
    jf, tf = both
    lv = np.asarray(jf.level)
    for lvl in range(1, CFG.n_levels):
        sel = lv == lvl
        ref = {tuple(p) for p in np.asarray(jf.uv)[sel & np.asarray(jf.valid)]}
        got = {tuple(p) for p in tf.uv[0].numpy()[sel & tf.valid[0].numpy()]}
        assert len(ref) > 10
        share = len(ref & got) / len(ref)
        assert share >= MIN_OVERLAP, f"level {lvl}: {share:.3f} keypoints in common"


def test_batch_equals_single(frame):
    ex = text.ORBExtractor(convert.extractor_config(CFG), H, W, device="cpu")
    img = torch.from_numpy(frame)
    batch = ex(torch.stack([img, img.flip(-1)]))
    single = text.extract(img.flip(-1), convert.extractor_config(CFG))
    for name in ("uv", "level", "response", "valid"):
        assert torch.equal(getattr(batch, name)[1], getattr(single, name)), name
    # the moment sums reduce in another order over a batch: angles move by
    # float32 rounding, which can flip a near-tie descriptor bit
    np.testing.assert_allclose(batch.angle[1].numpy(), single.angle.numpy(), atol=1e-5)
    assert (batch.desc[1] == single.desc).all(-1).float().mean() > 0.98


# The cases of tests/test_features.py that exercise the port, re-run on it.
def textured_image(h=240, w=320, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.uniform(0, 255, (h // 8, w // 8)).astype(np.float32)
    import jax.image

    return torch.tensor(np.asarray(jax.image.resize(jnp.asarray(img), (h, w), "cubic")))


class TestFeatureCases:
    def test_detects_corners_on_isolated_squares(self):
        img = torch.zeros((1, 128, 128))
        for y in range(16, 112, 32):
            for x in range(16, 112, 32):
                img[0, y : y + 12, x : x + 12] = 255.0
        assert int((tfast.fast_score_map(img, 20.0) > 0).sum()) >= 16

    def test_flat_image_no_corners(self):
        assert int((tfast.fast_score_map(torch.full((1, 64, 64), 100.0), 7.0) > 0).sum()) == 0

    def test_gradient_orientation(self):
        ramp = torch.arange(64, dtype=torch.float32)
        ys, xs = torch.tensor([[32]]), torch.tensor([[32]])
        ang = torient.ic_angles(ramp[None, :].repeat(64, 1)[None], ys, xs)
        assert abs(float(ang[0, 0])) < 0.05
        ang2 = torient.ic_angles(ramp[:, None].repeat(1, 64)[None], ys, xs)
        assert abs(float(ang2[0, 0]) - np.pi / 2) < 0.05

    def test_distinct_points_distinct_descriptors(self):
        taps = torch.from_numpy(timage.gauss_kernel1d())
        b = timage.gaussian_blur(textured_image()[None], taps)
        ys = torch.tensor([[50, 100, 150, 200]])
        xs = torch.tensor([[60, 120, 200, 100]])
        d = tbrief.brief_descriptors(b, ys, xs, torch.zeros((1, 4)))[0]
        dm = hamming_matrix(d, d).numpy()
        assert (np.diag(dm) == 0).all()
        assert dm[~np.eye(4, dtype=bool)].min() > 60

    def test_rotation_invariance(self):
        taps = torch.from_numpy(timage.gauss_kernel1d())
        img = textured_image(256, 256, seed=3)
        img_rot = torch.rot90(img, 1)
        pts = [(100, 120), (140, 90), (180, 160)]
        w = img.shape[1]

        def desc(im, ys, xs):
            ys, xs = torch.tensor([ys]), torch.tensor([xs])
            ang = torient.ic_angles(im[None], ys, xs)
            return tbrief.brief_descriptors(timage.gaussian_blur(im[None], taps), ys, xs, ang)[0]

        d1 = desc(img, [p[0] for p in pts], [p[1] for p in pts])
        d2 = desc(img_rot, [w - 1 - p[1] for p in pts], [p[0] for p in pts])
        assert hamming_pairs(d1, d2).max() < 80

    def test_budgets_sum(self):
        assert sum(text.level_budgets(text.ExtractorConfig(n_features=1000))) == 1000

    def test_extract_textured(self):
        f = text.extract(textured_image(480, 640, seed=1), text.ExtractorConfig(n_features=500))
        assert f.capacity == 500
        assert int(f.valid.sum()) > 300
        uv = f.uv[f.valid].numpy()
        assert (uv[:, 0] >= 0).all() and (uv[:, 0] < 640).all()
        assert (uv[:, 1] >= 0).all() and (uv[:, 1] < 480).all()
        gx = np.clip((uv[:, 0] // 80).astype(int), 0, 7)
        gy = np.clip((uv[:, 1] // 80).astype(int), 0, 5)
        assert len(set(zip(gx, gy))) >= 24

    def test_multiscale(self):
        f = text.extract(textured_image(480, 640, seed=2), text.ExtractorConfig(n_features=600))
        assert int(f.level[f.valid].max()) >= 4


@pytest.mark.parametrize("size", [(120, 160), (240, 320)])
def test_level_budget_beyond_candidates_is_refused_as_the_reference_refuses_it(size):
    """128 features over 2 levels: at 160x120 the second level has fewer
    per-cell candidates (48) than its budget, and both packages refuse the
    configuration (lax.top_k's ValueError; the port's top_k_lastdim
    raises the same); at 320x240 both extract, and every field of the
    port's Features has the reference's capacity."""
    h, w = size
    img = np.random.default_rng(0).uniform(0, 255, (h, w)).astype(np.float32)
    jcfg = jext.ExtractorConfig(n_features=128, n_levels=2)
    if size == (120, 160):
        with pytest.raises(ValueError, match="top_k"):
            jext.extract(jnp.asarray(img), jcfg)
        with pytest.raises(ValueError, match="top_k"):
            text.extract(torch.from_numpy(img), convert.extractor_config(jcfg))
        return
    jf = jext.extract(jnp.asarray(img), jcfg)
    tf = text.extract(torch.from_numpy(img), convert.extractor_config(jcfg))
    for name, jx, tx in zip(jf._fields, jf, tf):
        assert tuple(tx.shape) == np.asarray(jx).shape, name
        assert tx.shape[0] == jcfg.n_features, name
