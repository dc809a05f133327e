"""Settings: the reference's YAML configuration files.

Port of orb_slam3_modified_tpu/io/settings.py (Settings, ImuSettings,
load_settings, _cv_mat, _load_opencv_yaml; :25-232), after the reference's
include/Settings.h:44-121 (new-style "File.version 1.0" files) and the
legacy per-key parsing of src/Tracking.cc (ParseCamParamFile :621,
ParseORBParamFile :1219, ParseIMUParamFile :1303).

The JAX package parses the files with PyYAML. The port reads them with a
reader of its own (_load_opencv_yaml), which covers the OpenCV FileStorage
subset those files use and returns what yaml.safe_load returns for them:
the %YAML directive and --- lines, comments, flat dotted keys with plain
(YAML 1.1 int / float / bool / null / string) or quoted scalars, flow
sequences (which may run over several lines), and one level of nested map
for the !!opencv-matrix nodes (rows / cols / dt / data). Anything else
raises. Rectification goes through the port's cameras/rectify.py.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

import numpy as np

from ..cameras import Camera
from ..features.extractor import ExtractorConfig


@dataclasses.dataclass
class ImuSettings:
    noise_gyro: float
    noise_acc: float
    walk_gyro: float
    walk_acc: float
    freq: float
    T_bc: np.ndarray  # (4, 4) camera-to-body


@dataclasses.dataclass
class Settings:
    cam: Camera
    extractor: ExtractorConfig
    imu: Optional[ImuSettings]
    fps: float
    rgb: bool
    baseline: float = 0.0  # stereo: b*fx (ThDepth domain)
    th_depth: float = 35.0
    # discard depth/stereo points beyond this range (meters); 0 = disabled
    # (reference: thFarPoints YAML flag, src/System.cc:199-209)
    th_far_points: float = 0.0
    sensor: str = "monocular"
    # pinhole radtan distortion (k1,k2,p1,p2,k3) of the (left) camera; None
    # when the images are pre-rectified or the model is KB8
    dist: Optional[np.ndarray] = None
    # stereo rectification maps (cameras/rectify.py::StereoRectification);
    # when set, `cam`/`baseline` already describe the rectified pair
    rect: object = None
    # non-rectified (KB8 fisheye) stereo rig: right camera + left->right
    # extrinsics (reference: ComputeStereoFishEyeMatches src/Frame.cc:1126)
    cam_right: object = None
    T_rl: Optional[np.ndarray] = None  # (4,4): p_right = R p_left + t


# ---------------------------------------------------------------- the reader
# YAML 1.1 plain-scalar resolution, as PyYAML's safe loader does it
_INT = re.compile(r"[-+]?(0b[0-1_]+|0[0-7_]+|0|[1-9][0-9_]*|0x[0-9a-fA-F_]+)")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)\.[0-9_]*([eE][-+][0-9]+)?|\.[0-9][0-9_]*([eE][-+][0-9]+)?"
                    r"|[-+]?\.(inf|Inf|INF)|\.(nan|NaN|NAN)")
_BOOL = {v: b for b, vs in ((True, "yes Yes YES true True TRUE on On ON"),
                            (False, "no No NO false False FALSE off Off OFF"))
         for v in vs.split()}
_NULL = {"", "~", "null", "Null", "NULL"}


def _plain(s: str):
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.fullmatch(s):
        t = s.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t[0] == "0":
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.fullmatch(s):
        t = s.replace("_", "").lower()
        if t.endswith("inf"):
            return float("-inf") if t[0] == "-" else float("inf")
        return float("nan") if t.endswith("nan") else float(t)
    return s


def _scalar(s: str, where: str):
    if s[:1] == '"':
        if len(s) < 2 or s[-1] != '"':
            raise ValueError(f"{where}: unterminated string {s!r}")
        return re.sub(r'\\(.)', lambda m: {"n": "\n", "t": "\t"}.get(m[1], m[1]), s[1:-1])
    if s[:1] == "'":
        if len(s) < 2 or s[-1] != "'":
            raise ValueError(f"{where}: unterminated string {s!r}")
        return s[1:-1].replace("''", "'")
    if s[:1] == "[":
        if s[-1] != "]":
            raise ValueError(f"{where}: unterminated sequence {s!r}")
        items = [x.strip() for x in s[1:-1].split(",")]
        if items and items[-1] == "":
            items.pop()
        return [_scalar(x, where) for x in items]
    if s[:1] in "{&*!|>@`":
        raise ValueError(f"{where}: unsupported YAML {s!r}")
    return _plain(s)


def _strip_comment(line: str) -> str:
    """The line up to a '#' that opens a comment (at the start or after a
    blank, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'" and (i == 0 or line[i - 1] in " :[,"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _load_opencv_yaml(path: str) -> dict:
    """OpenCV FileStorage YAML -> dict of its top-level (dotted) keys."""
    with open(path) as f:
        text = f.read()
    lines = [
        ln for ln in text.splitlines()
        if not ln.startswith("%YAML") and not ln.strip() == "---"
    ]
    # opencv matrices are '!!opencv-matrix' tagged maps; the tag goes
    text = "\n".join(lines).replace("!!opencv-matrix", "")
    out: dict = {}
    parent = None  # the top-level key whose nested map the indented lines fill
    open_seq = None  # [target map, key, text so far] of a flow sequence still open
    for n, raw in enumerate(text.splitlines(), 1):
        line = _strip_comment(raw).rstrip()
        where = f"{path}:{n}"
        if open_seq is not None:
            open_seq[2] += " " + line.strip()
            target, key, rest = open_seq
        elif not line.strip():
            continue
        else:
            indent = len(line) - len(line.lstrip(" "))
            if "\t" in line[:indent + 1]:
                raise ValueError(f"{where}: tab indentation")
            key, sep, rest = line.strip().partition(":")
            if not sep or (rest and rest[0] != " ") or not key:
                raise ValueError(f"{where}: not a 'key: value' line: {raw!r}")
            key, rest = _scalar(key.strip(), where), rest.strip()
            if indent == 0:
                target, parent = out, None
                if rest == "":  # a nested map follows, or the value is null
                    out[key] = None
                    parent = key
                    continue
            else:
                if parent is None:
                    raise ValueError(f"{where}: indented line outside a map: {raw!r}")
                if rest == "":
                    raise ValueError(f"{where}: nested maps deeper than one level")
                if out[parent] is None:
                    out[parent] = {}
                target = out[parent]
        if rest.startswith("[") and rest.count("[") > rest.count("]"):
            open_seq = [target, key, rest]  # the sequence goes on on the next line
            continue
        open_seq = None
        target[key] = _scalar(rest, where)
    if open_seq is not None:
        raise ValueError(f"{path}: the sequence of {open_seq[1]!r} is never closed")
    return out


def _cv_mat(d, key):
    """Parse an opencv-matrix node ({rows, cols, data}) if present."""
    v = d.get(key)
    if isinstance(v, dict) and "data" in v:
        rows = int(v.get("rows", 1))
        cols = int(v.get("cols", len(v["data"]) // max(rows, 1)))
        return np.array(v["data"], np.float64).reshape(rows, cols)
    if isinstance(v, (list, tuple)):
        return np.array(v, np.float64)
    return None


def load_settings(path: str, device="cuda") -> Settings:
    """Settings of a reference configuration file; the cameras' parameters
    are tensors on `device`."""
    d = _load_opencv_yaml(path)

    def get(key, default=None):
        return d[key] if key in d else default

    cam_type = get("Camera.type", get("Camera1.type", "PinHole"))
    prefix = "Camera" if "Camera.fx" in d else "Camera1"
    fx = float(get(f"{prefix}.fx", 458.654))
    fy = float(get(f"{prefix}.fy", 457.296))
    cx = float(get(f"{prefix}.cx", 367.215))
    cy = float(get(f"{prefix}.cy", 248.375))
    w = int(get("Camera.width", get("Camera1.width", 752)))
    h = int(get("Camera.height", get("Camera1.height", 480)))
    dist = None
    rect = None
    cam_right = None
    T_rl = None
    is_kb8 = str(cam_type).lower().startswith(("kannala", "fisheye"))
    if is_kb8:
        k0 = float(get(f"{prefix}.k1", 0.0))
        k1 = float(get(f"{prefix}.k2", 0.0))
        k2 = float(get(f"{prefix}.k3", 0.0))
        k3 = float(get(f"{prefix}.k4", 0.0))
        cam = Camera.kb8(fx, fy, cx, cy, k0, k1, k2, k3, width=w, height=h, device=device)
        if "Camera2.fx" in d:
            # KB8 stereo rig (TUM-VI style): no rectification; the right
            # camera + T_c1_c2 drive general left<->right bearing matching
            cam_right = Camera.kb8(
                float(d["Camera2.fx"]), float(d["Camera2.fy"]),
                float(d["Camera2.cx"]), float(d["Camera2.cy"]),
                float(d.get("Camera2.k1", 0.0) or 0.0),
                float(d.get("Camera2.k2", 0.0) or 0.0),
                float(d.get("Camera2.k3", 0.0) or 0.0),
                float(d.get("Camera2.k4", 0.0) or 0.0),
                width=w, height=h, device=device,
            )
            T12 = _cv_mat(d, "Stereo.T_c1_c2")
            if T12 is not None:
                T12 = np.vstack([T12[:3], [0, 0, 0, 1.0]])
                # T_c1_c2 = pose of cam2 in cam1; we need p_r = R p_l + t
                Rrel = T12[:3, :3].T
                trel = -Rrel @ T12[:3, 3]
                T_rl = np.eye(4)
                T_rl[:3, :3] = Rrel
                T_rl[:3, 3] = trel
    else:
        cam = Camera.pinhole(fx, fy, cx, cy, width=w, height=h, device=device)
        dvec = np.array(
            [float(get(f"{prefix}.{k}", 0.0) or 0.0)
             for k in ("k1", "k2", "p1", "p2", "k3")], np.float64
        )
        if np.any(dvec != 0):
            dist = dvec

    # ---- stereo rectification (reference: include/Settings.h:44-121
    # needToRectify / precomputed LEFT./RIGHT. maps, src/Tracking.cc:621)
    lk = _cv_mat(d, "LEFT.K")
    if lk is not None:
        # legacy EuRoC stereo block: K/D/R/P given per camera
        from ..cameras.rectify import build_rectification_legacy

        size = (int(d.get("LEFT.width", w)), int(d.get("LEFT.height", h)))
        rect = build_rectification_legacy(
            lk, _cv_mat(d, "LEFT.D"), _cv_mat(d, "LEFT.R"), _cv_mat(d, "LEFT.P"),
            _cv_mat(d, "RIGHT.K"), _cv_mat(d, "RIGHT.D"),
            _cv_mat(d, "RIGHT.R"), _cv_mat(d, "RIGHT.P"), size,
        )
    elif "Camera2.fx" in d and dist is not None:
        # new-style two-pinhole-with-distortion rig: rectify from calibration
        from ..cameras.rectify import build_rectification

        K1m = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
        K2m = np.array(
            [[float(d["Camera2.fx"]), 0, float(d["Camera2.cx"])],
             [0, float(d["Camera2.fy"]), float(d["Camera2.cy"])],
             [0, 0, 1]]
        )
        D2 = np.array(
            [float(d.get(f"Camera2.{k}", 0.0) or 0.0)
             for k in ("k1", "k2", "p1", "p2", "k3")], np.float64
        )
        T12 = _cv_mat(d, "Stereo.T_c1_c2")
        if T12 is not None:
            T12 = np.vstack([T12[:3], [0, 0, 0, 1]])
            # x_c2 = R x_c1 + t with T_c1_c2 the pose of cam2 in cam1
            Rrel = T12[:3, :3].T
            trel = -Rrel @ T12[:3, 3]
            rect = build_rectification(K1m, dist, K2m, D2, (w, h), Rrel, trel)
    if rect is not None:
        # the pipeline sees the rectified pair: rectified intrinsics, no
        # distortion, metric bf from the rectified projection
        cam = Camera.pinhole(rect.fx, rect.fy, rect.cx, rect.cy, width=w, height=h,
                             device=device)
        dist = None

    ext = ExtractorConfig(
        n_features=int(get("ORBextractor.nFeatures", 1000)),
        n_levels=int(get("ORBextractor.nLevels", 8)),
        scale=float(get("ORBextractor.scaleFactor", 1.2)),
        ini_th=float(get("ORBextractor.iniThFAST", 20)),
        min_th=float(get("ORBextractor.minThFAST", 7)),
    )

    imu = None
    if "IMU.NoiseGyro" in d:
        Tbc = d.get("IMU.T_b_c1", d.get("Tbc"))
        if isinstance(Tbc, dict) and "data" in Tbc:
            Tbc = np.array(Tbc["data"], np.float64).reshape(4, 4)
        else:
            Tbc = np.eye(4)
        imu = ImuSettings(
            noise_gyro=float(d["IMU.NoiseGyro"]),
            noise_acc=float(d.get("IMU.NoiseAcc", 2e-3)),
            walk_gyro=float(d.get("IMU.GyroWalk", 1.9e-5)),
            walk_acc=float(d.get("IMU.AccWalk", 3e-3)),
            freq=float(d.get("IMU.Frequency", 200.0)),
            T_bc=Tbc,
        )

    baseline = float(get("Camera.bf", get("Stereo.b", 0.0)) or 0.0)
    if rect is not None and rect.bf > 0:
        baseline = rect.bf
    if T_rl is not None and baseline <= 0:
        # KB8 rig: bf from the stereo baseline and the left focal length
        # (reference: Settings::readCamera2 computes b from Tlr and bf = b*fx)
        baseline = float(np.linalg.norm(T_rl[:3, 3])) * fx
    return Settings(
        cam_right=cam_right,
        T_rl=T_rl,
        cam=cam,
        extractor=ext,
        imu=imu,
        fps=float(get("Camera.fps", 20.0) or 20.0),
        rgb=bool(int(get("Camera.RGB", 1) or 1)),
        baseline=baseline,
        th_depth=float(get("ThDepth", get("Stereo.ThDepth", 35.0)) or 35.0),
        th_far_points=float(get("thFarPoints", 0.0) or 0.0),
        dist=dist,
        rect=rect,
    )
