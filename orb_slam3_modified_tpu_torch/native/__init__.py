"""Native (C++) covisibility engine, loaded via ctypes with numpy fallbacks.

Port of orb_slam3_modified_tpu/native/__init__.py. covis.cc (a copy of the
reference's source) is host bookkeeping, not a device kernel: it is built
with g++ at first use into the package's git-ignored `_build/`, and every
entry point returns None when no library can be built or loaded, so the
callers in slam_map/map_state.py take their numpy path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).parent / "covis.cc"
LIBRARY = Path(__file__).parent.parent / "_build" / "libcovis.so"
_lib = None
_tried = False


def _build():
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    # portable baseline ISA (no -march=native): the build directory may be
    # copied to another machine; -O3 vectorizes the counting loops anyway
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(SOURCE), "-o", str(tmp)],
                   check=True, capture_output=True)
    os.replace(tmp, LIBRARY)  # atomic: concurrent builders never load half a file


def _smoke_test(lib) -> bool:
    """One tiny call: a stale or foreign binary fails here, not in tracking."""
    obs = np.full((2, 4), -1, np.int32)
    obs[0, 0] = 0
    obs[1, 1] = 0
    out = np.empty(2, np.int32)
    lib.covis_weights(obs, np.ones(2, np.uint8), 2, 4, 4, 0, out)
    return out[1] == 1 and out[0] == 0


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
            _build()
        lib = ctypes.CDLL(str(LIBRARY))
        i64 = ctypes.c_int64
        p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.covis_weights.argtypes = [p32, pu8, i64, i64, i64, i64, p32]
        lib.obs_counts.argtypes = [p32, pu8, i64, i64, i64, p32]
        lib.point_observers.argtypes = [p32, pu8, i64, i64, i64, p32, i64, pu8]
        for fn in (lib.covis_weights, lib.obs_counts, lib.point_observers):
            fn.restype = None
        if not _smoke_test(lib):
            raise RuntimeError("native covis smoke test failed")
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def _u8(valid):
    return np.ascontiguousarray(valid.view(np.uint8))


def covis_weights(obs: np.ndarray, valid: np.ndarray, n_points: int, k: int):
    lib = get_lib()
    if lib is None:
        return None
    K, F = obs.shape
    out = np.empty(K, np.int32)
    lib.covis_weights(np.ascontiguousarray(obs), _u8(valid), K, F, n_points, k, out)
    return out


def obs_counts(obs: np.ndarray, valid: np.ndarray, n_points: int):
    lib = get_lib()
    if lib is None:
        return None
    K, F = obs.shape
    out = np.empty(n_points, np.int32)
    lib.obs_counts(np.ascontiguousarray(obs), _u8(valid), K, F, n_points, out)
    return out


def point_observers(obs: np.ndarray, valid: np.ndarray, n_points: int, pts: np.ndarray):
    lib = get_lib()
    if lib is None:
        return None
    K, F = obs.shape
    out = np.empty(K, np.uint8)
    pts32 = np.ascontiguousarray(pts.astype(np.int32))
    lib.point_observers(np.ascontiguousarray(obs), _u8(valid), K, F, n_points, pts32,
                        len(pts32), out)
    return out.astype(bool)
