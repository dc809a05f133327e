"""Carry state across from the JAX package to the port, and descriptors back.

Each function takes one of the reference's objects (read only through its
attributes and np.asarray, so nothing here imports the reference package)
and returns the port's counterpart on `device`. Descriptors keep their 256
bits: the reference's (N, 8) uint32 become (N, 8) int32 by a bit view.
"""
from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .cameras import Camera
from .features.extractor import ExtractorConfig, Features
from .tracking.fused import DeviceTrackState, MapCache


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


def features(f, device="cuda") -> Features:
    dev = resolve_device(device)
    return Features(
        uv=_t(f.uv, dev, np.float32), desc=desc_from_uint32(f.desc, dev),
        angle=_t(f.angle, dev, np.float32), level=_t(f.level, dev, np.int32),
        response=_t(f.response, dev, np.float32), valid=_t(f.valid, dev, bool),
    )
