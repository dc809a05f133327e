"""Port parity for models/depth.py, the depth + segmentation U-Net.

- The shipped asset is convert.depth_net_state_dict of the reference's
  flax weights, array for array (scripts/convert_depth_net.py wrote it).
- The net against the flax net on the same input at its training size
  (96x128): depth within DEPTH_RTOL relative, logits within LOGIT_ATOL.
- make_depth_fn / make_seg_fn against the reference's _run_at_train_res
  (what its make_depth_fn / make_seg_fn jit) at 480x752 (the antialiased
  shrink to 96x128 and the bilinear growth back):
  depth within DEPTH_RTOL relative; class maps equal wherever the
  reference's two logits are more than TIE apart (measured: equal
  everywhere, depth within 2.4e-6 relative).
- tests/test_depth_model.py's accuracy gates on the port with its asset:
  mean relative depth error < 0.25 on a scene the net never saw, surface
  IoU > 0.9, and a semantic cloud (recon/cloud.py) that lies on the plane.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.models import depth as jdepth
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.cameras import Camera
from orb_slam3_modified_tpu_torch.models import depth as pdepth

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(2)
DEPTH_RTOL = 2e-5
LOGIT_ATOL = 1e-4
TIE = 1e-3
CAM = Camera.pinhole(330.0, 330.0, 256.0, 192.0, width=512, height=384, device="cpu")


@pytest.fixture(scope="module")
def models():
    net_j, params, meta = jdepth.default_depth_model()
    net_p, meta_p = pdepth.default_depth_model(device="cpu")
    assert meta_p == meta
    return net_j, params, net_p, tuple(int(x) for x in meta["train_res"].split("x"))


def test_shipped_asset_is_the_converted_reference(models):
    _, params, net_p, _ = models
    want = convert.depth_net_state_dict(params)
    got = net_p.state_dict()
    assert sorted(want) == sorted(got)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k
    assert os.path.getsize(pdepth.ASSET) < 4 << 20


def test_net_matches_flax_at_training_size(models):
    net_j, params, net_p, hw = models
    x = np.random.default_rng(0).uniform(0, 1, (2, *hw, 1)).astype(np.float32)
    apply = jax.jit(lambda v: net_j.apply({"params": params}, v))
    dj, sj = (np.asarray(a) for a in apply(jnp.asarray(x)))
    with torch.no_grad():
        dp, sp = net_p(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(dp.numpy(), dj, rtol=DEPTH_RTOL)
    np.testing.assert_allclose(sp.numpy(), sj.transpose(0, 3, 1, 2), atol=LOGIT_ATOL)


def test_depth_and_seg_fns_match_reference_at_camera_size(models):
    net_j, params, net_p, hw = models
    h, w = 480, 752  # EuRoC's frames
    rng = np.random.default_rng(h)
    img = cv2.resize(rng.uniform(0, 255, (h // 16, w // 16)).astype(np.float32), (w, h),
                     interpolation=cv2.INTER_CUBIC)
    # what the reference's make_depth_fn / make_seg_fn jit, in one jit
    d_ref, logits = (np.asarray(a) for a in jax.jit(
        lambda im: jdepth._run_at_train_res(net_j, params, im, hw))(img))
    d_got = pdepth.make_depth_fn(net_p, hw)(img)
    assert d_got.shape == (h, w) and d_got.dtype == np.float32
    np.testing.assert_allclose(d_got, d_ref, rtol=DEPTH_RTOL)
    clear = np.abs(logits[..., 1] - logits[..., 0]) > TIE
    s_got = pdepth.make_seg_fn(net_p, hw)(img)
    assert s_got.dtype == np.int32
    assert np.array_equal(s_got[clear], np.argmax(logits, axis=-1)[clear])


def _render_posed(seed=11, n=4, plane_z=2.0):
    """tests/test_depth_model.py's posed ring views over a fresh texture."""
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import (
        camera_rays, orbit_state, render_textured_scene_with_depth,
    )

    rng = np.random.default_rng(seed)
    tex = cv2.resize(rng.uniform(0, 255, (96, 96)).astype(np.float32), (1024, 1024),
                     interpolation=cv2.INTER_CUBIC)
    rays = camera_rays(CAM)
    out = []
    for v in range(n):
        R_cw, p, _, _ = orbit_state(v / 2.0, n / 2.0, 3.0, 2 * np.pi, ring=True)
        T = np.eye(4)
        T[:3, :3] = R_cw
        T[:3, 3] = -R_cw @ p
        img, depth, mask = render_textured_scene_with_depth(T, CAM, tex, plane_z=plane_z,
                                                            plane_half=10.0, rays_c=rays)
        out.append((img, depth, mask, T))
    return out


def test_accuracy_gates_of_the_reference_on_the_port(models):
    from orb_slam3_modified_tpu_torch.recon.cloud import semantic_cloud

    _, _, net_p, hw = models
    depth_fn, seg_fn = pdepth.make_depth_fn(net_p, hw), pdepth.make_seg_fn(net_p, hw)
    views = _render_posed()
    rel = []
    for img, depth_gt, mask, _ in views:
        pred = depth_fn(img)
        v = mask & (depth_gt > 0.5)
        rel.append(np.abs(pred[v] - depth_gt[v]) / depth_gt[v])
    assert np.concatenate(rel).mean() < 0.25
    img, _, mask, _ = views[0]
    seg = seg_fn(img)
    assert ((seg == 1) & mask).sum() / max(((seg == 1) | mask).sum(), 1) > 0.9
    colormap = np.array([[40, 40, 200], [90, 200, 90]], np.uint8)
    pts, cols = semantic_cloud(CAM, [(im, T) for im, _, _, T in views], depth_fn, seg_fn,
                               colormap, stride=8, voxel=0.05)
    assert len(pts) > 500
    surf = (cols == colormap[1]).all(axis=1)
    assert surf.mean() > 0.5
    assert np.median(np.abs(pts[surf][:, 2] - 2.0)) < 0.5
