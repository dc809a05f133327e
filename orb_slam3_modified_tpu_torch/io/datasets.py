"""Dataset readers: EuRoC, TUM and KITTI timestamp / image / IMU streams.

Port of orb_slam3_modified_tpu/io/datasets.py (ImuSample, FrameData,
EurocDataset, TumDataset, KittiDataset; :20-200), after the example mains'
loaders (Examples/Monocular-Inertial/mono_inertial_euroc.cc LoadImages :258
/ LoadIMU :285; Examples/Monocular/mono_{tum,kitti}.cc). Same iteration:
a frame's EuRoC IMU batch holds the samples with prev_ts < ts <= t, TUM's
depth map is the nearest within 0.02 s, KITTI's times come from times.txt.

Frames stay on the host: images (H, W) float32 grey levels and depth maps
float32 meters, as numpy; the runner moves them to the device. PNGs decode
with OpenCV where cv2 can be imported, as the JAX loader does, and with
io/png.py otherwise (the card host has no cv2); PNG_DECODER names the one
in use, and both give the same pixels (tests/test_torch_io.py).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import os
from typing import Iterator, Optional

import numpy as np

from . import png

# "cv2" or "png": which decoder the readers use (set it to force one)
PNG_DECODER = "cv2" if importlib.util.find_spec("cv2") is not None else "png"


@dataclasses.dataclass
class ImuSample:
    ts: float
    gyro: np.ndarray  # (3,)
    acc: np.ndarray  # (3,)


@dataclasses.dataclass
class FrameData:
    ts: float
    image: np.ndarray  # (H, W) float32 grayscale
    image_right: Optional[np.ndarray] = None
    depth: Optional[np.ndarray] = None
    imu: Optional[list] = None  # ImuSamples since previous frame


def _imread_gray(path: str) -> np.ndarray:
    """(H, W) float32 grey levels (cv2.IMREAD_GRAYSCALE)."""
    if PNG_DECODER == "cv2":
        import cv2

        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise FileNotFoundError(path)
    else:
        img = png.read_png_gray(path)
    return img.astype(np.float32)


def _imread_raw(path: str) -> np.ndarray:
    """The stored samples (cv2.IMREAD_UNCHANGED), for depth maps."""
    if PNG_DECODER == "cv2":
        import cv2

        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        return img
    return png.read_png(path)


class EurocDataset:
    """EuRoC MAV format: mav0/cam0/data.csv + data/, mav0/imu0/data.csv."""

    def __init__(self, root: str, stereo: bool = False, with_imu: bool = False,
                 with_depth: bool = False, depth_scale: float = 1000.0):
        self.root = root
        self.stereo = stereo
        self.with_imu = with_imu
        self.with_depth = with_depth
        self.depth_scale = depth_scale  # depth png units per meter
        cam0 = os.path.join(root, "mav0", "cam0")
        self.ts, self.files = self._read_cam_csv(cam0)
        if stereo:
            cam1 = os.path.join(root, "mav0", "cam1")
            _, self.files_r = self._read_cam_csv(cam1)
        if with_depth:
            # aligned depth stream (RGB-D / RGB-D-inertial configs;
            # Examples/RGB-D-Inertial/rgbd_inertial_realsense_D435i.cc)
            depth0 = os.path.join(root, "mav0", "depth0")
            _, self.files_d = self._read_cam_csv(depth0)
        self.imu = self._read_imu() if with_imu else None

    @staticmethod
    def _read_cam_csv(cam_dir: str):
        ts, files = [], []
        with open(os.path.join(cam_dir, "data.csv")) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                parts = line.strip().split(",")
                if len(parts) < 2:
                    continue
                ts.append(int(parts[0]) * 1e-9)
                files.append(os.path.join(cam_dir, "data", parts[1].strip()))
        return np.array(ts), files

    def _read_imu(self):
        samples = []
        with open(os.path.join(self.root, "mav0", "imu0", "data.csv")) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                p = line.strip().split(",")
                if len(p) < 7:
                    continue
                samples.append(ImuSample(int(p[0]) * 1e-9, np.array(p[1:4], np.float64),
                                         np.array(p[4:7], np.float64)))
        return samples

    def __len__(self):
        return len(self.files)

    def __iter__(self) -> Iterator[FrameData]:
        imu_i = 0
        prev_ts = None
        for i, (t, f) in enumerate(zip(self.ts, self.files)):
            img = _imread_gray(f)
            right = _imread_gray(self.files_r[i]) if self.stereo else None
            depth = None
            if self.with_depth:
                depth = _imread_raw(self.files_d[i]).astype(np.float32) / self.depth_scale
            imu_batch = None
            if self.imu is not None:
                imu_batch = []
                while imu_i < len(self.imu) and self.imu[imu_i].ts <= t:
                    if prev_ts is None or self.imu[imu_i].ts > prev_ts:
                        imu_batch.append(self.imu[imu_i])
                    imu_i += 1
            prev_ts = t
            yield FrameData(t, img, image_right=right, depth=depth, imu=imu_batch)


class TumDataset:
    """TUM RGB-D format: rgb.txt (+ depth.txt associations)."""

    def __init__(self, root: str, with_depth: bool = False):
        self.root = root
        self.ts, self.files = self._read_list(os.path.join(root, "rgb.txt"))
        self.with_depth = with_depth
        if with_depth:
            self.dts, self.dfiles = self._read_list(os.path.join(root, "depth.txt"))

    def _read_list(self, path):
        ts, files = [], []
        with open(path) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                p = line.strip().split()
                if len(p) < 2:
                    continue
                ts.append(float(p[0]))
                files.append(os.path.join(self.root, p[1]))
        return np.array(ts), files

    def __len__(self):
        return len(self.files)

    def __iter__(self):
        for t, f in zip(self.ts, self.files):
            depth = None
            if self.with_depth:
                j = int(np.argmin(np.abs(self.dts - t)))
                if abs(self.dts[j] - t) < 0.02:
                    depth = _imread_raw(self.dfiles[j]).astype(np.float32) / 5000.0
            yield FrameData(t, _imread_gray(f), depth=depth)


class KittiDataset:
    """KITTI odometry grayscale: image_0/ (+ image_1/) + times.txt."""

    def __init__(self, root: str, stereo: bool = False):
        self.root = root
        self.stereo = stereo
        with open(os.path.join(root, "times.txt")) as f:
            self.ts = np.array([float(x) for x in f if x.strip()])
        self.files = [os.path.join(root, "image_0", f"{i:06d}.png") for i in range(len(self.ts))]
        if stereo:
            self.files_r = [os.path.join(root, "image_1", f"{i:06d}.png")
                            for i in range(len(self.ts))]

    def __len__(self):
        return len(self.ts)

    def __iter__(self):
        for i, (t, f) in enumerate(zip(self.ts, self.files)):
            right = _imread_gray(self.files_r[i]) if self.stereo else None
            yield FrameData(t, _imread_gray(f), image_right=right)
