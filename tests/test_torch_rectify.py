"""Port parity for cameras/rectify.py, JAX vs torch, and the cases of
tests/test_rectify.py against OpenCV on the port.

The startup pieces (undistort_points, stereo_rectify, the rectification
maps) are numpy float64 in both packages: they agree to 1e-9. The pieces
that run on tensors in float32: the keypoint undistorter within 1e-3 px of
the reference's, remap_bilinear within 1e-3 grey levels (a lerp of four
float32 products). The Settings cases (io/settings.py) come with ROADMAP
item 13.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.cameras import rectify as jr
from orb_slam3_modified_tpu_torch.cameras import rectify as tr

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(2)
# tests/test_rectify.py's EuRoC cam0 / cam1-like calibration
K1 = np.array([[458.654, 0, 367.215], [0, 457.296, 248.375], [0, 0, 1]])
D1 = np.array([-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0])
K2 = np.array([[457.587, 0, 379.999], [0, 456.134, 255.238], [0, 0, 1]])
D2 = np.array([-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05, 0.0])
SIZE = (752, 480)
HOST_TOL = 1e-9
KP_TOL = 1e-3  # px
REMAP_TOL = 1e-3  # grey levels


def _relative_pose():
    R, _ = cv2.Rodrigues(np.array([0.003, -0.002, 0.001]))
    return R, np.array([[-0.1100738], [0.000399121], [-0.000853703]])


@pytest.mark.parametrize("with_rp", [False, True])
def test_undistort_points_matches_reference_and_cv2(with_rp):
    rng = np.random.default_rng(1 if with_rp else 0)
    pts = rng.uniform([30, 30], [720, 450], size=(100 if with_rp else 200, 2))
    kw = {}
    if with_rp:
        R, t = _relative_pose()
        R1, _, P1 = cv2.stereoRectify(K1, D1, K2, D2, SIZE, R, t, flags=cv2.CALIB_ZERO_DISPARITY,
                                      alpha=-1)[:3]
        kw = dict(R=R1, P=P1)
    ours = tr.undistort_points(pts, K1, D1, **kw)
    np.testing.assert_allclose(ours, jr.undistort_points(pts, K1, D1, **kw), atol=HOST_TOL)
    ref = cv2.undistortPoints(pts.reshape(-1, 1, 2), K1, D1, **kw).reshape(-1, 2)
    # cv2 stops at 5 fixed-point iterations (~0.25 px on EuRoC's distortion)
    assert np.allclose(ours, ref, atol=0.5 if with_rp else 2e-3)
    if not with_rp:  # an exact round trip through the forward model
        back = tr.radtan_distort_normalized(ours, D1)
        px = back * [K1[0, 0], K1[1, 1]] + [K1[0, 2], K1[1, 2]]
        assert np.abs(px - pts).max() < 1e-9


def test_keypoint_undistorter_matches_reference():
    rng = np.random.default_rng(2)
    pts = rng.uniform([30, 30], [720, 450], size=(300, 2)).astype(np.float32)
    ours = tr.make_keypoint_undistorter(K1, D1)(torch.from_numpy(pts)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jr.make_keypoint_undistorter(K1, D1)(
        jnp.asarray(pts))), atol=KP_TOL)
    ref = tr.undistort_points(pts.astype(np.float64), K1, D1, P=K1)
    assert np.abs(ours - ref).max() < 0.05  # float32, 8 fixed-point iterations


def test_stereo_rectify_and_maps_match_reference_and_cv2():
    R, t = _relative_pose()
    ours = tr.stereo_rectify(K1, D1, K2, D2, SIZE, R, t)
    for a, b in zip(ours, jr.stereo_rectify(K1, D1, K2, D2, SIZE, R, t)):
        np.testing.assert_allclose(a, b, atol=HOST_TOL)
    oR1, oR2, oP1, oP2, _ = ours
    rR1, rR2, rP1, rP2 = cv2.stereoRectify(K1, D1, K2, D2, SIZE, R, t,
                                           flags=cv2.CALIB_ZERO_DISPARITY, alpha=-1)[:4]
    assert np.allclose(oR1, rR1, atol=1e-8) and np.allclose(oR2, rR2, atol=1e-8)
    assert np.allclose(oP1, rP1, atol=0.05) and np.allclose(oP2, rP2, atol=0.05)
    mx, my = tr.init_undistort_rectify_map(K1, D1, oR1, oP1, SIZE)
    jx, jy = jr.init_undistort_rectify_map(K1, D1, oR1, oP1, SIZE)
    np.testing.assert_array_equal(mx, jx)
    np.testing.assert_array_equal(my, jy)
    rmx, rmy = cv2.initUndistortRectifyMap(K1, D1, oR1, oP1, SIZE, cv2.CV_32FC1)
    assert np.allclose(mx, rmx, atol=1e-2) and np.allclose(my, rmy, atol=1e-2)


@pytest.mark.parametrize("build", ["new_style", "legacy"])
def test_rectification_and_remap_match_reference_and_cv2(build):
    """build_rectification / build_rectification_legacy against the
    reference's, and StereoRectification.remap (remap_bilinear) against the
    reference's remap and cv2.remap."""
    rng = np.random.default_rng(3)
    img_l = rng.uniform(0, 255, (480, 752)).astype(np.float32)
    img_r = rng.uniform(0, 255, (480, 752)).astype(np.float32)
    R, t = _relative_pose()
    if build == "new_style":
        args = (K1, D1, K2, D2, SIZE, R, t)
        ours, ref = tr.build_rectification(*args), jr.build_rectification(*args)
    else:
        R1, R2, P1, P2, _ = tr.stereo_rectify(K1, D1, K2, D2, SIZE, R, t)
        args = (K1, D1, R1, P1, K2, D2, R2, P2, SIZE)
        ours, ref = tr.build_rectification_legacy(*args), jr.build_rectification_legacy(*args)
    for f in ("map_lx", "map_ly", "map_rx", "map_ry"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
    for f in ("fx", "fy", "cx", "cy", "bf"):
        assert abs(getattr(ours, f) - getattr(ref, f)) < HOST_TOL
    assert 45.0 < ours.bf < 55.0  # 0.110 m * ~457 px
    l, r = ours.remap(torch.from_numpy(img_l), torch.from_numpy(img_r))
    jl, jrr = ref.remap(img_l, img_r)
    np.testing.assert_allclose(l.numpy(), np.asarray(jl), atol=REMAP_TOL)
    np.testing.assert_allclose(r.numpy(), np.asarray(jrr), atol=REMAP_TOL)
    cvl = cv2.remap(img_l, ours.map_lx, ours.map_ly, cv2.INTER_LINEAR,
                    borderMode=cv2.BORDER_CONSTANT, borderValue=0)
    assert np.quantile(np.abs(l.numpy() - cvl), 0.999) < 0.5


def test_rectified_pair_row_aligned():
    """A 3-D point through both rectified cameras lands on the same row,
    with a positive disparity that gives its depth."""
    R, t = _relative_pose()
    R1, R2, P1, P2, _ = tr.stereo_rectify(K1, D1, K2, D2, SIZE, R, t)
    X = np.random.default_rng(4).uniform([-1, -1, 2], [1, 1, 8], size=(50, 3))
    Xr1 = X @ R1.T
    u1 = Xr1[:, :2] / Xr1[:, 2:3] * P1[0, 0] + P1[:2, 2]
    Xr2 = (X @ R.T + t.ravel()) @ R2.T
    u2 = Xr2[:, :2] / Xr2[:, 2:3] * P2[0, 0] + P2[:2, 2]
    assert np.allclose(u1[:, 1], u2[:, 1], atol=1e-6)
    disp = u1[:, 0] - u2[:, 0]
    assert np.all(disp > 0)
    assert np.allclose(abs(P2[0, 3]) / disp, Xr1[:, 2], rtol=1e-6)


def test_system_undistorts_keypoints():
    """SlamSystem with dist set moves the extracted keypoints by the
    undistortion (Frame::UndistortKeyPoints), on the keypoints' device."""
    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.features.extractor import Features
    from orb_slam3_modified_tpu_torch.system.slam_system import SlamSystem, SystemConfig

    img = np.random.default_rng(5).uniform(0, 255, (480, 752)).astype(np.float32)
    cam = Camera.pinhole(458.654, 457.296, 367.215, 248.375, width=752, height=480, device="cpu")
    sys_plain = SlamSystem(SystemConfig(cam=cam, feat_cap=256, use_loop_closing=False,
                                        device="cpu"))
    sys_dist = SlamSystem(SystemConfig(cam=cam, feat_cap=256, use_loop_closing=False,
                                       device="cpu", dist=D1))
    feats = Features(*(f[0] for f in sys_dist._extract(img)))
    valid = feats.valid.numpy()
    uv0 = sys_plain._post_extract(feats).uv.numpy()[valid]
    uv1 = sys_dist._post_extract(feats).uv.numpy()[valid]
    assert np.abs(uv1 - tr.undistort_points(uv0, K1, D1, P=K1)).max() < 0.05
    assert np.abs(uv1 - uv0).max() > 1.0  # it moved them
