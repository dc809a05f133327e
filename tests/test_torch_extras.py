"""Port parity for the extras: recon/cloud.py, viz/ar.py, viz/frame_drawer.py
and viz/viewer.py, on tests/test_extras.py's cases.

All of them are host numpy in both packages, so each port function is held
to the reference's on the same inputs: planes, clouds, voxel filters,
overlays (bit for bit), PLY files (byte for byte); unprojection goes
through each package's camera model, so backprojected points agree to
1e-5 m. The frame drawer also saves without OpenCV (through io/png.py, a
blank status bar), as on the card host.
"""
import os
import sys

import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.cameras import Camera as JCamera
from orb_slam3_modified_tpu.recon import cloud as jcloud
from orb_slam3_modified_tpu.viz import ar as jar
from orb_slam3_modified_tpu.viz import frame_drawer as jfd
from orb_slam3_modified_tpu.viz import viewer as jviewer
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.recon import cloud as pcloud
from orb_slam3_modified_tpu_torch.viz import ar as par
from orb_slam3_modified_tpu_torch.viz import frame_drawer as pfd
from orb_slam3_modified_tpu_torch.viz import viewer as pviewer

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(2)
JCAM = JCamera.pinhole(458.654, 457.296, 367.215, 248.375, width=752, height=480)
PCAM = convert.camera(JCAM, device="cpu")


def _plane_points(seed):
    """tests/test_extras.py's y = 0.5 plane with 50 outliers."""
    rng = np.random.default_rng(seed)
    n = 300
    pts = np.zeros((n, 3), np.float32)
    pts[:, 0] = rng.uniform(-2, 2, n)
    pts[:, 2] = rng.uniform(2, 6, n)
    pts[:, 1] = 0.5 + rng.normal(0, 0.01, n)
    pts[250:] = rng.uniform(-2, 2, (50, 3))
    return pts


def _same_plane(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_plane_detection_and_overlay_match_reference():
    pts = _plane_points(0)
    plane = par.detect_plane(pts)
    _same_plane(plane, jar.detect_plane(pts))
    assert abs(abs(plane.normal[1]) - 1.0) < 0.05 and plane.inliers.sum() > 200
    uniform = np.random.default_rng(1).uniform(-3, 3, (200, 3)).astype(np.float32)
    _same_plane(par.detect_plane(uniform, min_inlier_frac=0.6),
                jar.detect_plane(uniform, min_inlier_frac=0.6))
    img = np.full((480, 752), 128.0, np.float32)
    for anchor in (None, (400.0, 300.0)):
        out = par.render_overlay(img, PCAM, np.eye(4), plane, model=par.cube_model(0.3),
                                 anchor_uv=anchor)
        ref = jar.render_overlay(img, JCAM, np.eye(4), plane, model=jar.cube_model(0.3),
                                 anchor_uv=anchor)
        assert out.shape == (480, 752, 3) and (out != 128).any()
        assert np.array_equal(out, ref)


def test_cloud_matches_reference(tmp_path):
    depth = np.full((480, 752), 4.0, np.float32)
    depth[100:200, 300:400] = 2.5
    T = np.eye(4)
    T[:3, 3] = [0.1, -0.2, 0.3]
    pw, uv = pcloud.backproject_depth(PCAM, depth, T, stride=16)
    rw, ruv = jcloud.backproject_depth(JCAM, depth, T, stride=16)
    np.testing.assert_array_equal(uv, ruv)
    np.testing.assert_allclose(pw, rw, atol=1e-5)
    pts = np.array([[0, 0, 0], [0.001, 0, 0], [1, 1, 1]], np.float32)
    assert len(pcloud.voxel_filter(pts, 0.05)) == 2
    np.testing.assert_array_equal(pcloud.voxel_filter(pts, 0.05), jcloud.voxel_filter(pts, 0.05))

    def depth_fn(img):
        return np.full(img.shape, 3.0, np.float32)

    def seg_fn(img):
        return (np.arange(img.size).reshape(img.shape) % 3 == 0).astype(np.int32)

    cmap = np.array([[255, 0, 0], [0, 255, 0]], np.uint8)
    frames = [(np.zeros((480, 752), np.float32), np.eye(4)), (np.full((480, 752), 9.0), T)]
    got = pcloud.semantic_cloud(PCAM, frames, depth_fn, seg_fn, cmap, stride=32)
    ref = jcloud.semantic_cloud(JCAM, frames, depth_fn, seg_fn, cmap, stride=32)
    assert len(got[0]) > 100
    np.testing.assert_allclose(got[0], ref[0], atol=1e-5)
    np.testing.assert_array_equal(got[1], ref[1])
    gray = pcloud.semantic_cloud(PCAM, frames[1:], depth_fn, stride=32)
    assert (gray[1] == 9).all()
    pcloud.save_ply(str(tmp_path / "p.ply"), ref[0], ref[1])
    jcloud.save_ply(str(tmp_path / "j.ply"), ref[0], ref[1])
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
    (tmp_path / "cmap.txt").write_text("0 road 128 64 128\n1 sidewalk 244 35 232\n\n")
    np.testing.assert_array_equal(pcloud.load_colormap(str(tmp_path / "cmap.txt")),
                                  jcloud.load_colormap(str(tmp_path / "cmap.txt")))
    m = convert.map_state(_map())
    np.testing.assert_array_equal(pcloud.sparse_cloud(m), m.mp_pos[m.point_indices()])


def _snapshot():
    rng = np.random.default_rng(3)
    h, w, F = 120, 160, 40
    img = rng.uniform(0, 255, (h, w)).astype(np.uint8)
    uv = rng.uniform(10, [w - 10, h - 10], (F, 2)).astype(np.float32)
    tracked = np.zeros(F, bool)
    tracked[:25] = True
    return img, uv, np.ones(F, bool), tracked


@pytest.mark.parametrize("vo", [False, True])
def test_frame_drawer_matches_reference(vo, tmp_path, monkeypatch):
    img, uv, valid, tracked = _snapshot()
    d, r = pfd.FrameDrawer(), jfd.FrameDrawer()
    for x in (d, r):
        x.update(img, uv, valid, tracked, state=1, n_kfs=7, n_mps=321, vo_mode=vo, frame_id=42)
    out = d.render()
    assert out.shape == (120 + 22, 160, 3) and np.array_equal(out, r.render())
    x, y = np.round(uv[0]).astype(int)
    assert (out[y, x] == ([255, 170, 0] if vo else [0, 220, 0])).all()
    x, y = np.round(uv[30]).astype(int)
    assert (out[y - 2, x] == [80, 160, 255]).all() and not (out[y, x] == [80, 160, 255]).all()
    p = d.save(str(tmp_path / "overlay.png"))
    assert np.array_equal(cv2.imread(p)[..., ::-1], out)
    # the card host has no cv2: the PNG comes from io/png.py, the bar is blank
    monkeypatch.setitem(sys.modules, "cv2", None)
    p = d.save(str(tmp_path / "no_cv2.png"))
    monkeypatch.undo()
    saved = cv2.imread(p)[..., ::-1]
    assert np.array_equal(saved[:120], out[:120]) and not saved[120:].any()


def test_frame_drawer_from_tracker_and_write_overlay(tmp_path):
    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.features.extractor import Features
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3np
    from orb_slam3_modified_tpu_torch.slam_map.map_state import MapState
    from orb_slam3_modified_tpu_torch.tracking.tracker import FrameRecord, Tracker, TrackerConfig

    cam = Camera.pinhole(100.0, 100.0, 64.0, 48.0, width=128, height=96, device="cpu")
    t = Tracker(TrackerConfig(cam=cam), MapState.create(max_kf=4, max_mp=64, feat_cap=8),
                device="cpu")
    d = pfd.FrameDrawer()
    assert not d.update_from_tracker(t) and pfd.write_overlay(str(tmp_path), t) == ""
    F = 8
    feats = Features(uv=np.random.default_rng(0).uniform(5, 90, (F, 2)).astype(np.float32),
                     desc=np.zeros((F, 8), np.uint32), angle=np.zeros(F, np.float32),
                     level=np.zeros(F, np.int32), response=np.ones(F, np.float32),
                     valid=np.ones(F, bool))
    obs = np.full(F, -1, np.int32)
    obs[:3] = [0, 1, 2]
    t.last = FrameRecord(feats, SE3np(np.eye(3, dtype=np.float32), np.zeros(3, np.float32)),
                         obs, 0.0, 5)
    t.vo_mode, t.state = True, 1
    assert d.update_from_tracker(t)
    out = d.render()
    assert out.shape == (96 + 22, 128, 3)
    ref = jfd.FrameDrawer()
    ref.update(np.zeros((96, 128), np.uint8), feats.uv, feats.valid, obs != -1, 1, 0, 0,
               vo_mode=True, frame_id=5)
    assert np.array_equal(out, ref.render())
    p = pfd.write_overlay(str(tmp_path / "viz"), t, image=np.full((96, 128), 50, np.uint8))
    assert os.path.basename(p) == "frame_000005.png" and os.path.getsize(p) > 500


def _map():
    from orb_slam3_modified_tpu.slam_map.map_state import MapState

    m = MapState.create(max_kf=8, max_mp=128, feat_cap=16)
    rng = np.random.default_rng(0)
    for i in range(3):
        k = m.alloc_keyframe()
        m.kf_t[k] = [i, 0.1 * i, 0]
        m.kf_obs[k, :5] = np.arange(5)
    mp = m.alloc_points(50)
    m.mp_pos[mp] = rng.uniform(-2, 2, (50, 3))
    return m


def test_viewer_matches_reference(tmp_path):
    ref = _map()
    m = convert.map_state(ref)
    for a, b in zip(pviewer.keyframe_centers(m), jviewer.keyframe_centers(ref)):
        np.testing.assert_array_equal(a, b)
    traj = [np.eye(4), None, np.eye(4)]
    out = pviewer.plot_map(m, trajectory=traj, path=str(tmp_path / "map.png"))
    assert os.path.exists(out) and os.path.getsize(out) > 1000
    img, uv, valid, tracked = _snapshot()
    out = pviewer.draw_frame(img, uv, valid, tracked, path=str(tmp_path / "frame.png"))
    assert os.path.getsize(out) > 1000
