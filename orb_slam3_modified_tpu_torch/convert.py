"""Carry state across from the JAX package to the port, and descriptors back.

Each function takes one of the reference's objects (read only through its
attributes and np.asarray, so nothing here imports the reference package)
and returns the port's counterpart on `device`. Descriptors keep their 256
bits: the reference's (N, 8) uint32 become (N, 8) int32 by a bit view.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from . import resolve_device
from .cameras import Camera
from .features.extractor import ExtractorConfig, Features
from .lie.se3 import SE3np
from .slam_map.map_state import MapState
from .tracking.fused import DeviceTrackState, MapCache
from .tracking.tracker import FrameRecord


def _t(x, device, dtype=None):
    return torch.tensor(np.asarray(x, dtype=dtype), device=device)  # copies


def desc_from_uint32(desc, device="cuda") -> torch.Tensor:
    """(..., 8) uint32 array -> (..., 8) int32 tensor with the same bits."""
    return _t(np.asarray(desc, dtype=np.uint32).view(np.int32), resolve_device(device))


def desc_to_uint32(desc) -> np.ndarray:
    """(..., 8) int32 tensor -> (..., 8) uint32 numpy array with the same bits."""
    return desc.detach().cpu().numpy().astype(np.int32, copy=False).view(np.uint32)


def camera(cam, device="cuda") -> Camera:
    return Camera(
        int(cam.kind), _t(cam.params, resolve_device(device), np.float32),
        int(cam.width), int(cam.height),
    )


def extractor_config(cfg) -> ExtractorConfig:
    return ExtractorConfig(*(getattr(cfg, f) for f in ExtractorConfig._fields))


def map_cache(cache, device="cuda") -> MapCache:
    dev = resolve_device(device)
    return MapCache(
        pos=_t(cache.pos, dev, np.float32),
        desc=desc_from_uint32(cache.desc, dev),
        valid=_t(cache.valid, dev, bool),
        mp_id=_t(cache.mp_id, dev, np.int32),
    )


def track_state(state, device="cuda") -> DeviceTrackState:
    dev = resolve_device(device)
    return DeviceTrackState(
        R=_t(state.R, dev, np.float32), t=_t(state.t, dev, np.float32),
        R_prev=_t(state.R_prev, dev, np.float32), t_prev=_t(state.t_prev, dev, np.float32),
        ok=_t(state.ok, dev, bool),
    )


def vi_track_state(state, device="cuda"):
    """A reference VITrackState (tracking/vi_fused.py) -> the port's."""
    from .tracking.vi_fused import VITrackState

    dev = resolve_device(device)
    return VITrackState(*(_t(x, dev, bool if f == "ok" else np.float32)
                          for f, x in zip(VITrackState._fields, state)))


def features(f, device="cuda") -> Features:
    dev = resolve_device(device)
    return Features(
        uv=_t(f.uv, dev, np.float32), desc=desc_from_uint32(f.desc, dev),
        angle=_t(f.angle, dev, np.float32), level=_t(f.level, dev, np.int32),
        response=_t(f.response, dev, np.float32), valid=_t(f.valid, dev, bool),
    )


def host_features(f) -> Features:
    """A reference Features (one frame) -> the port's host Features (numpy,
    uint32 descriptors), as the port's tracker takes them."""
    return Features(*(np.array(x) for x in f))


def map_state(src, dst: MapState = None) -> MapState:
    """A reference MapState -> the port's: every array (kf_ur, the
    keyframes' right-image u, included) and bookkeeping field, copied; the
    removal callbacks stay the destination's. dst: a port MapState of the
    same capacities to copy into, else a new one."""
    if dst is None:
        K, F = src.kf_obs.shape
        dst = MapState.create(K, src.mp_valid.shape[0], F)
    for f in dataclasses.fields(src):
        if f.name == "kf_removed_callbacks":
            continue
        v = getattr(src, f.name)
        if isinstance(v, np.ndarray):
            np.copyto(getattr(dst, f.name), v)
        else:
            setattr(dst, f.name, copy.deepcopy(v))
    return dst


def frame_record(rec) -> FrameRecord:
    """A reference tracker's FrameRecord -> the port's, with its per-feature
    depth and right-image u (stereo / RGB-D) when it has them."""
    def opt(a):
        return None if a is None else np.array(a, np.float32)

    return FrameRecord(
        host_features(rec.features),
        SE3np(np.array(rec.T_cw.R, np.float32), np.array(rec.T_cw.t, np.float32)),
        np.array(rec.obs_mp, np.int32), float(rec.ts), int(rec.frame_id),
        depth=opt(rec.depth), ur=opt(rec.ur),
    )


def imu_bias(b, device="cuda"):
    """A reference ImuBias -> the port's, on `device`."""
    from .imu.preintegration import ImuBias

    dev = resolve_device(device)
    return ImuBias(_t(b.bg, dev, np.float32), _t(b.ba, dev, np.float32))


def preintegrated(p, device="cuda"):
    """A reference Preintegrated -> the port's, on `device`."""
    from .imu.preintegration import Preintegrated

    dev = resolve_device(device)
    return Preintegrated(*(imu_bias(x, dev) if f == "bias" else _t(x, dev, np.float32)
                           for f, x in zip(Preintegrated._fields, p)))


def imu_config(cfg):
    """A reference ImuConfig -> the port's (a copy)."""
    from .tracking.imu_frontend import ImuConfig

    out = ImuConfig(*(copy.deepcopy(getattr(cfg, f.name)) for f in dataclasses.fields(ImuConfig)))
    for name in ("R_bc", "t_bc"):
        if getattr(out, name) is not None:
            setattr(out, name, np.asarray(getattr(out, name), np.float32))
    return out


def imu_frontend(src, dst=None, device="cuda"):
    """A reference ImuFrontend's state -> the port's: the body velocity and
    bias, the stage, the keyframe chain (host intervals), the priors, the
    per-frame and per-keyframe intervals (on `device`), the gravity and
    bad-IMU bookkeeping. dst: a port ImuFrontend to copy into, else a new
    one on `device`."""
    from .tracking.imu_frontend import ImuFrontend

    if dst is None:
        dst = ImuFrontend(imu_config(src.cfg), device=device)
    dev = dst.device

    def opt_np(a):
        return None if a is None else np.array(a, np.float32)

    def opt_pre(p, d):
        return None if p is None else preintegrated(p, d)

    dst.v_w = np.array(src.v_w, np.float32)
    dst.bias = imu_bias(src.bias, dev)
    dst.stage = int(src.stage)
    dst.initialized = bool(src.initialized)
    dst.kf_chain = [(int(k), int(f), preintegrated(p, "cpu")) for k, f, p in src.kf_chain]
    dst.marg_prior = opt_np(src.marg_prior)
    dst._marg_pending = opt_np(src._marg_pending)
    dst.kf_prior = (None if src.kf_prior is None else
                    (int(src.kf_prior[0]), int(src.kf_prior[1]), opt_np(src.kf_prior[2])))
    dst.preint_frame = opt_pre(src.preint_frame, dev)
    dst.preint_kf = opt_pre(src.preint_kf, dev)
    dst._pred_v = opt_np(getattr(src, "_pred_v", None))
    dst.first_kf_ts = None if src.first_kf_ts is None else float(src.first_kf_ts)
    dst.R_gw = np.array(src.R_gw, np.float32)
    dst.t_motion = float(src.t_motion)
    dst.bad_imu = bool(src.bad_imu)
    dst.refine_idx = int(src.refine_idx)
    return dst


def depth_net_state_dict(params) -> dict:
    """The reference DepthSegNet's flax params (nested dicts of numpy
    arrays) -> the port's models/depth.py state_dict as numpy arrays: HWIO
    kernels become OIHW; _ConvBlock_i/Conv_j -> blocks.i.convj, Conv_0 (the
    inverse-depth head) -> inv_head, Conv_1 (the seg head) -> seg_head."""
    out = {}

    def conv(name, p):
        out[f"{name}.weight"] = np.ascontiguousarray(
            np.asarray(p["kernel"], np.float32).transpose(3, 2, 0, 1))
        out[f"{name}.bias"] = np.asarray(p["bias"], np.float32)

    for key, sub in params.items():
        if key.startswith("_ConvBlock_"):
            i = int(key.rsplit("_", 1)[1])
            for ckey, p in sub.items():
                conv(f"blocks.{i}.conv{int(ckey.rsplit('_', 1)[1])}", p)
        else:
            conv({"Conv_0": "inv_head", "Conv_1": "seg_head"}[key], sub)
    return out
