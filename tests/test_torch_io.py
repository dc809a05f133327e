"""Port parity for io/ (settings, PNG, dataset readers) and the EuRoC writer.

- Settings: the port's own YAML reader returns what the reference's PyYAML
  parse returns, and load_settings the same Settings field by field, on
  every file in configs/ and on tests/test_io.py's and test_rectify.py's
  cases, a legacy LEFT./RIGHT. stereo block and a KB8 stereo rig. The
  cameras, extractor configs and IMU blocks are exact; the rectification
  maps are numpy float64 in both packages and agree to 1e-9
  (test_torch_rectify.py's HOST_TOL).
- PNG (io/png.py) against cv2.imread, bit for bit: the reference writer's
  gray and uint16 depth PNGs (libpng's filters), files with every row
  filter (None, Sub, Up, Average, Paeth) at bit depths 8 and 16, colour to
  gray (IMREAD_GRAYSCALE: libpng's rgb_to_gray, reproduced exactly), and
  cv2 reading the port's writer's files.
- Readers: EuRoC (stereo, depth, IMU batches), TUM (colour frames, depth
  association within 0.02 s) and KITTI (stereo) against the reference's
  readers, with either decoder: timestamps, images, depth and IMU exact.
- write_euroc_sequence against the reference's: CSVs, IMU and ground truth
  exact; images (make_texture's torch bicubic against cv2.resize) differ in
  at most 1e-4 of the pixels, by at most 1 grey level.
"""
import filecmp
import glob
import os
import struct
import zlib

import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu.cameras import Camera as JCamera
from orb_slam3_modified_tpu.io import datasets as jds
from orb_slam3_modified_tpu.io import settings as js
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.cameras import FISHEYE_KB8, PINHOLE
from orb_slam3_modified_tpu_torch.cameras import Camera as PCamera
from orb_slam3_modified_tpu_torch.io import datasets as pds
from orb_slam3_modified_tpu_torch.io import png
from orb_slam3_modified_tpu_torch.io import settings as ps

cv2 = pytest.importorskip("cv2")

torch.set_num_threads(2)
CONFIGS = os.path.join(os.path.dirname(__file__), "..", "configs")
HOST_TOL = 1e-9

# tests/test_io.py::test_opencv_yaml_directive
DIRECTIVE = ("%YAML:1.0\n---\nCamera.type: PinHole\nCamera.fx: 100.0\n"
             "Camera.fy: 100.0\nCamera.cx: 50.0\nCamera.cy: 50.0\n"
             "Camera.width: 100\nCamera.height: 100\n")
# tests/test_rectify.py::test_settings_mono_distortion
MONO_DISTORTION = """%YAML:1.0
---
Camera.type: "PinHole"
Camera.fx: 458.654
Camera.fy: 457.296
Camera.cx: 367.215
Camera.cy: 248.375
Camera.k1: -0.28340811
Camera.k2: 0.07395907
Camera.p1: 0.00019359
Camera.p2: 1.76187114e-05
Camera.width: 752
Camera.height: 480
Camera.fps: 20
Camera.RGB: 1
ORBextractor.nFeatures: 1000
"""
# the legacy EuRoC stereo block (Examples_old/Stereo/EuRoC.yaml): K, D, R, P per camera
LEGACY_STEREO = """%YAML:1.0
# legacy stereo calibration, matrices over several lines
Camera.fx: 435.2046959714599
Camera.fy: 435.2046959714599
Camera.cx: 367.4517211914062
Camera.cy: 252.2008514404297
Camera.width: 752
Camera.height: 480
Camera.bf: 47.90639384423901  # baseline times fx
ThDepth: 35
LEFT.height: 480
LEFT.width: 752
LEFT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.0]
LEFT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [458.654, 0.0, 367.215, 0.0, 457.296, 248.375, 0.0, 0.0, 1.0]
LEFT.R:  !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [0.999966347530033, -0.001422739138722922, 0.008079580483432283,
          0.001365741834644127, 0.9999741760894847, 0.007055629199258132,
          -0.008089410156878961, -0.007044357138835809, 0.9999424675829176]
LEFT.P:  !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2046959714599, 0, 367.4517211914062, 0,  0, 435.2046959714599,
          252.2008514404297, 0,  0, 0, 1, 0]
RIGHT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data: [-0.28368365, 0.07451284, -0.00010473, -3.555907e-05, 0.0]
RIGHT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [457.587, 0.0, 379.999, 0.0, 456.134, 255.238, 0.0, 0.0, 1]
RIGHT.R:  !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [0.9999633526194376, -0.003625811871560086, 0.007755443660172947,
          0.003680398547259526, 0.9999684752771629, -0.007035845251224894,
          -0.007729688520722713, 0.007064130529506649, 0.999945173484644]
RIGHT.P:  !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2046959714599, 0, 367.4517211914062, -47.90639384423901, 0, 435.2046959714599,
          252.2008514404297, 0, 0, 0, 1, 0]
ORBextractor.nFeatures: 1200
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
"""
# a KB8 stereo rig (TUM-VI style): right camera + Stereo.T_c1_c2, no rectification
KB8_STEREO = """%YAML:1.0
---
File.version: "1.0"
Camera.type: "KannalaBrandt8"
Camera1.fx: 190.978
Camera1.fy: 190.973
Camera1.cx: 254.932
Camera1.cy: 256.897
Camera1.k1: 0.00348238
Camera1.k2: 0.000715034
Camera1.k3: -0.00205323
Camera1.k4: 0.000202936
Camera2.fx: 190.442
Camera2.fy: 190.448
Camera2.cx: 252.597
Camera2.cy: 254.917
Camera2.k1: 0.00340432
Camera2.k2: 0.000701707
Camera2.k3: -0.00195644
Camera2.k4: 0.000183169
Camera.width: 512
Camera.height: 512
Camera.fps: 20
Camera.RGB: 1
Stereo.ThDepth: 40.0
Stereo.T_c1_c2: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [0.999997, -0.002317, -0.000343, 0.101576,
         0.002312, 0.999898, -0.014090, 0.001986,
         0.000376, 0.014089, 0.999900, 0.001153,
         0, 0, 0, 1.0]
IMU.NoiseGyro: 0.00016
IMU.NoiseAcc: 0.0028
IMU.GyroWalk: 2.2e-05
IMU.AccWalk: 0.00086
IMU.Frequency: 200.0
IMU.T_b_c1: !!opencv-matrix
  rows: 4
  cols: 4
  dt: f
  data: [-0.9995, 0.0297, -0.0105, 0.0475, 0.0075, -0.0995, -0.9950, -0.0473,
         -0.0306, -0.9946, 0.0992, -0.0474, 0.0, 0.0, 0.0, 1.0]
thFarPoints: 20.0
"""
TEXTS = {"directive": DIRECTIVE, "mono_distortion": MONO_DISTORTION,
         "legacy_stereo": LEGACY_STEREO, "kb8_stereo": KB8_STEREO}
SETTINGS_CASES = sorted(os.path.basename(p) for p in glob.glob(os.path.join(CONFIGS, "*.yaml")))
SETTINGS_CASES += sorted(TEXTS)


def _settings_path(case, tmp_path):
    if case in TEXTS:
        p = tmp_path / f"{case}.yaml"
        p.write_text(TEXTS[case])
        return str(p)
    return os.path.join(CONFIGS, case)


def _same_camera(port_cam, ref_cam):
    ref = convert.camera(ref_cam, device="cpu")
    assert port_cam.kind == ref.kind and (port_cam.width, port_cam.height) == (ref.width,
                                                                            ref.height)
    assert torch.equal(port_cam.params.cpu(), ref.params)


@pytest.mark.parametrize("case", SETTINGS_CASES)
def test_settings_match_reference(case, tmp_path):
    path = _settings_path(case, tmp_path)
    assert ps._load_opencv_yaml(path) == js._load_opencv_yaml(path)
    got, ref = ps.load_settings(path, device="cpu"), js.load_settings(path)
    _same_camera(got.cam, ref.cam)
    assert got.extractor == convert.extractor_config(ref.extractor)
    assert (got.imu is None) == (ref.imu is None)
    if ref.imu is not None:
        for f in ("noise_gyro", "noise_acc", "walk_gyro", "walk_acc", "freq"):
            assert getattr(got.imu, f) == getattr(ref.imu, f), f
        np.testing.assert_array_equal(got.imu.T_bc, ref.imu.T_bc)
    for f in ("fps", "rgb", "th_depth", "th_far_points", "sensor"):
        assert getattr(got, f) == getattr(ref, f), f
    assert got.baseline == pytest.approx(ref.baseline, abs=HOST_TOL)
    for f in ("dist", "T_rl"):
        a, b = getattr(got, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert (got.cam_right is None) == (ref.cam_right is None)
    if ref.cam_right is not None:
        _same_camera(got.cam_right, ref.cam_right)
    assert (got.rect is None) == (ref.rect is None)
    if ref.rect is not None:
        for f in ("map_lx", "map_ly", "map_rx", "map_ry", "fx", "fy", "cx", "cy", "bf"):
            np.testing.assert_allclose(getattr(got.rect, f), getattr(ref.rect, f), atol=HOST_TOL)


def test_settings_cases_of_the_reference_tests(tmp_path):
    """tests/test_io.py's TestSettings and test_rectify.py's two Settings
    cases (:137, :156) on the port."""
    st = ps.load_settings(os.path.join(CONFIGS, "euroc_mono.yaml"), device="cpu")
    assert st.cam.kind == PINHOLE and abs(float(st.cam.params[0]) - 458.654) < 1e-3
    assert (st.cam.width, st.cam.height) == (752, 480)
    assert st.extractor.n_features == 1000 and st.extractor.n_levels == 8 and st.imu is None
    st = ps.load_settings(os.path.join(CONFIGS, "euroc_mono_inertial.yaml"), device="cpu")
    assert abs(st.imu.freq - 200.0) < 1e-6 and st.imu.T_bc.shape == (4, 4)
    R = st.imu.T_bc[:3, :3]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    st = ps.load_settings(os.path.join(CONFIGS, "tum_vi_fisheye.yaml"), device="cpu")
    assert st.cam.kind == FISHEYE_KB8 and abs(float(st.cam.params[4]) - 0.00348238) < 1e-8
    st = ps.load_settings(_settings_path("directive", tmp_path), device="cpu")
    assert abs(float(st.cam.params[0]) - 100.0) < 1e-6
    st = ps.load_settings(os.path.join(CONFIGS, "euroc_stereo.yaml"), device="cpu")
    assert st.rect is not None and st.dist is None and 45.0 < st.baseline < 55.0
    assert st.rect.map_lx.shape == (480, 752)
    assert abs(float(st.cam.params[0]) - st.rect.fx) < 1e-3
    st = ps.load_settings(_settings_path("mono_distortion", tmp_path), device="cpu")
    assert st.rect is None and st.dist is not None and abs(st.dist[0] + 0.28340811) < 1e-9


@pytest.mark.parametrize("text", ["Camera.fx: 1\n  - 2\n", "Camera.fx: [1, 2\n",
                                  "Camera.fx: {a: 1}\n", "Camera.fx 1\n", "A:\n  b:\n    c: 1\n"])
def test_settings_reader_refuses_what_it_does_not_cover(text, tmp_path):
    p = tmp_path / "bad.yaml"
    p.write_text(text)
    with pytest.raises(ValueError):
        ps._load_opencv_yaml(str(p))


# ------------------------------------------------------------------ PNG
def _encode(img, filters, path):
    """A PNG whose row r is filtered with filters[r % len(filters)] (an
    encoder independent of io/png.py)."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    depth = 8 * img.dtype.itemsize
    x = np.ascontiguousarray(img.astype(">u2") if depth == 16 else img).view(np.uint8)
    x = x.reshape(h, -1).astype(np.int64)
    bpp = ch * depth // 8
    rows = []
    for r in range(h):
        cur, up = x[r], x[r - 1] if r else np.zeros_like(x[0])
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        f = filters[r % len(filters)]
        p = left + up - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) // 2, paeth][f]
        rows.append(np.concatenate([[f], (cur - pred) & 255]).astype(np.uint8))

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind
                                                                                     + body))
    colour = {1: 0, 3: 2, 4: 6}[ch]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(np.concatenate(rows).tobytes(), 9))
                + chunk(b"IEND", b""))


def _cv2_unchanged(path):
    """cv2.IMREAD_UNCHANGED in the port's channel order (RGB(A))."""
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img.ndim == 3:
        img = img[..., [2, 1, 0, 3][:img.shape[2]]]
    return img


def _smooth(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    top = 255 if dtype == np.uint8 else 65535
    base = (np.sin(xx / 7.0) + np.cos(yy / 5.0) + 2) / 4 * (top - 8)
    img = base[..., None] if len(shape) == 3 else base
    return (img + rng.integers(0, 8, shape)).astype(dtype)


@pytest.mark.parametrize("shape,dtype", [((37, 45), np.uint8), ((37, 45), np.uint16),
                                         ((37, 45, 3), np.uint8), ((21, 30, 4), np.uint8),
                                         ((21, 30, 3), np.uint16)])
def test_png_every_row_filter_matches_cv2(shape, dtype, tmp_path):
    img = _smooth(shape, dtype, seed=len(shape))
    for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4]):
        p = str(tmp_path / f"f{''.join(map(str, filters))}.png")
        _encode(img, filters, p)
        got = png.read_png(p)
        assert got.dtype == img.dtype and np.array_equal(got, img), filters
        assert np.array_equal(got, _cv2_unchanged(p))
        assert np.array_equal(png.read_png_gray(p), cv2.imread(p, cv2.IMREAD_GRAYSCALE))


def test_png_colour_to_gray_equals_cv2_bit_for_bit(tmp_path):
    """IMREAD_GRAYSCALE on colour PNGs that cv2 wrote: exact (libpng's
    rgb_to_gray weights 9797, 19234, 13737 / 2^15, truncated at 8 bits,
    rounded at 16)."""
    rng = np.random.default_rng(0)
    for i, img in enumerate([rng.integers(0, 256, (128, 128, 3), dtype=np.uint8),
                             rng.integers(0, 256, (64, 96, 4), dtype=np.uint8),
                             rng.integers(0, 65536, (40, 50, 3), dtype=np.uint16)]):
        p = str(tmp_path / f"c{i}.png")
        cv2.imwrite(p, img)
        assert np.array_equal(png.read_png_gray(p), cv2.imread(p, cv2.IMREAD_GRAYSCALE))
        assert np.array_equal(png.read_png(p), _cv2_unchanged(p))


def test_png_writer_read_by_cv2(tmp_path):
    rng = np.random.default_rng(1)
    for i, (shape, dtype) in enumerate([((30, 41), np.uint8), ((30, 41), np.uint16),
                                        ((30, 41, 3), np.uint8), ((30, 41, 4), np.uint8)]):
        img = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
        p = str(tmp_path / f"w{i}.png")
        png.write_png(p, img)
        assert np.array_equal(_cv2_unchanged(p), img)
        assert np.array_equal(png.read_png(p), img)


# ------------------------------------------------------------------ readers
JCAM = JCamera.pinhole(150.0, 150.0, 80.0, 60.0, width=160, height=120)


@pytest.fixture(scope="module")
def euroc_root(tmp_path_factory):
    """The reference writer's sequence (cv2 PNGs): cam0 + cam1 + depth0 + imu0."""
    from orb_slam3_modified_tpu.utils.synthetic_dataset import write_euroc_sequence

    root = str(tmp_path_factory.mktemp("euroc_io"))
    write_euroc_sequence(root, JCAM, n_frames=6, stereo_baseline=0.11, with_imu=True,
                         with_depth=True, gyro_noise_std=1e-3, acc_noise_std=1e-2)
    return root


def test_png_reads_the_reference_writers_files(euroc_root):
    files = sorted(glob.glob(os.path.join(euroc_root, "mav0", "*", "data", "*.png")))
    assert len(files) == 18
    for p in files:
        assert np.array_equal(png.read_png(p), cv2.imread(p, cv2.IMREAD_UNCHANGED)), p
        assert np.array_equal(png.read_png_gray(p), cv2.imread(p, cv2.IMREAD_GRAYSCALE)), p


def _same_frames(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.ts == b.ts
        for f in ("image", "image_right", "depth"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                assert x.dtype == y.dtype and np.array_equal(x, y), f
        assert (a.imu is None) == (b.imu is None)
        if a.imu is not None:
            assert [s.ts for s in a.imu] == [s.ts for s in b.imu]
            for s, t in zip(a.imu, b.imu):
                assert np.array_equal(s.gyro, t.gyro) and np.array_equal(s.acc, t.acc)


@pytest.fixture(params=["cv2", "png"])
def decoder(request, monkeypatch):
    monkeypatch.setattr(pds, "PNG_DECODER", request.param)
    return request.param


def test_euroc_reader_matches_reference(euroc_root, decoder):
    kw = dict(stereo=True, with_imu=True, with_depth=True)
    got, ref = list(pds.EurocDataset(euroc_root, **kw)), list(jds.EurocDataset(euroc_root, **kw))
    _same_frames(got, ref)
    assert len(pds.EurocDataset(euroc_root)) == 6
    assert sum(len(f.imu) for f in got) == len(pds.EurocDataset(euroc_root, with_imu=True).imu)


def test_tum_and_kitti_readers_match_reference(tmp_path, decoder):
    rng = np.random.default_rng(2)
    tum = tmp_path / "tum"
    (tum / "rgb").mkdir(parents=True)
    (tum / "depth").mkdir()
    rgb_ts = [1.0 + 0.033 * i for i in range(5)]
    depth_ts = [t + d for t, d in zip(rgb_ts, (0.004, -0.01, 0.03, 0.0, 0.019))]
    for t in rgb_ts:
        cv2.imwrite(str(tum / "rgb" / f"{t:.6f}.png"),
                    rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
    for t in depth_ts:
        cv2.imwrite(str(tum / "depth" / f"{t:.6f}.png"),
                    rng.integers(0, 20000, (48, 64), dtype=np.uint16))
    (tum / "rgb.txt").write_text("# timestamp filename\n" + "".join(
        f"{t:.6f} rgb/{t:.6f}.png\n" for t in rgb_ts))
    (tum / "depth.txt").write_text("# timestamp filename\n" + "".join(
        f"{t:.6f} depth/{t:.6f}.png\n" for t in depth_ts))
    got = list(pds.TumDataset(str(tum), with_depth=True))
    _same_frames(got, list(jds.TumDataset(str(tum), with_depth=True)))
    assert [f.depth is None for f in got] == [False, False, True, False, False]

    kitti = tmp_path / "kitti"
    for cam in ("image_0", "image_1"):
        (kitti / cam).mkdir(parents=True)
        for i in range(4):
            cv2.imwrite(str(kitti / cam / f"{i:06d}.png"),
                        rng.integers(0, 256, (40, 70), dtype=np.uint8))
    (kitti / "times.txt").write_text("".join(f"{0.1 * i:.6e}\n" for i in range(4)))
    for stereo in (False, True):
        _same_frames(list(pds.KittiDataset(str(kitti), stereo=stereo)),
                     list(jds.KittiDataset(str(kitti), stereo=stereo)))


def test_write_euroc_sequence_matches_reference(euroc_root, tmp_path):
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import write_euroc_sequence

    root = str(tmp_path / "port")
    gts = write_euroc_sequence(root, PCamera.pinhole(150.0, 150.0, 80.0, 60.0, width=160,
                                                     height=120, device="cpu"),
                               n_frames=6, stereo_baseline=0.11, with_imu=True, with_depth=True,
                               gyro_noise_std=1e-3, acc_noise_std=1e-2)
    from orb_slam3_modified_tpu.utils.synthetic_dataset import orbit_state

    for i, T in enumerate(gts):
        R_cw, p, _, _ = orbit_state(i / 20.0, 6 / 20.0, 3.0, np.pi / 4, 0.4, False)
        assert np.array_equal(T[:3, :3], R_cw) and np.array_equal(T[:3, 3], -R_cw @ p)
    for stream in ("cam0", "cam1", "depth0", "imu0"):
        assert filecmp.cmp(os.path.join(root, "mav0", stream, "data.csv"),
                           os.path.join(euroc_root, "mav0", stream, "data.csv"), shallow=False)
    n, differ = 0, 0
    for stream in ("cam0", "cam1", "depth0"):
        for p in sorted(glob.glob(os.path.join(euroc_root, "mav0", stream, "data", "*.png"))):
            ref = cv2.imread(p, cv2.IMREAD_UNCHANGED).astype(np.int64)
            got = png.read_png(os.path.join(root, "mav0", stream, "data",
                                            os.path.basename(p))).astype(np.int64)
            if stream == "depth0":  # depth comes from geometry alone: exact
                assert np.array_equal(got, ref)
                continue
            assert np.abs(got - ref).max() <= 1
            n, differ = n + ref.size, differ + int((got != ref).sum())
    assert differ <= 1e-4 * n, differ / n


def test_port_modules_import_no_jax_yaml_or_reference():
    """Importing every module of the port (run and models.depth included)
    loads none of jax, flax, yaml, msgpack or the reference package, and
    neither cv2 nor matplotlib (they load inside the functions that use
    them; the card host need not have them)."""
    import subprocess
    import sys

    code = (
        "import importlib, pkgutil, sys\n"
        "import orb_slam3_modified_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = ('jax', 'flax', 'yaml', 'msgpack', 'orb_slam3_modified_tpu', 'cv2', 'matplotlib')\n"
        "print(sorted({n.split('.')[0] for n in sys.modules} & set(bad)))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=os.path.join(os.path.dirname(__file__), ".."),
                         env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
