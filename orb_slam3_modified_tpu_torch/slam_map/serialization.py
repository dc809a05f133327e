"""Atlas checkpoint / resume.

Port of orb_slam3_modified_tpu/slam_map/serialization.py (save_atlas,
load_atlas, _voc_checksum; :25-79), after System::SaveAtlas / LoadAtlas
(src/System.cc:1443,1487) and its vocabulary MD5 gate (:1550). The map is
flat arrays, so a checkpoint is one compressed <path>.npz of every array of
the MapState plus a <path>.json manifest (format version 1, the
vocabulary's MD5 over node_desc + word_weight, the atlas scalars and the
loop edges). Both packages' MapState have the same fields, so an atlas
written by either loads in the other (tests/test_torch_serialization.py).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json

import numpy as np

from .map_state import MapState

FORMAT_VERSION = 1


def _voc_checksum(voc) -> str:
    if voc is None:
        return ""
    h = hashlib.md5()
    h.update(voc.node_desc.tobytes())
    h.update(voc.word_weight.tobytes())
    return h.hexdigest()


def save_atlas(path: str, m: MapState, voc=None, extra: dict | None = None):
    """Write <path>.npz + <path>.json manifest."""
    arrays = {
        f.name: getattr(m, f.name)
        for f in dataclasses.fields(m)
        if isinstance(getattr(m, f.name), np.ndarray)
    }
    np.savez_compressed(path + ".npz", **arrays)
    manifest = {
        "format_version": FORMAT_VERSION,
        "voc_md5": _voc_checksum(voc),
        "active_map": int(m.active_map),
        "n_maps": int(m.n_maps),
        "n_inertial_ba": int(m.n_inertial_ba),
        "imu_initialized": bool(m.imu_initialized),
        # persistent loop / merge edges (KeyFrame::AddLoopEdge survives
        # Save/LoadAtlas in the reference)
        "loop_edges": [[int(x) for x in e] for e in m.loop_edges],
        "extra": extra or {},
    }
    with open(path + ".json", "w") as f:
        json.dump(manifest, f, indent=2)


def load_atlas(path: str, voc=None, check_vocab: bool = True) -> MapState:
    with open(path + ".json") as f:
        manifest = json.load(f)
    if manifest["format_version"] != FORMAT_VERSION:
        raise ValueError(f"unsupported atlas format {manifest['format_version']}")
    if check_vocab and voc is not None and manifest["voc_md5"]:
        if manifest["voc_md5"] != _voc_checksum(voc):
            raise ValueError(
                "vocabulary checksum mismatch — atlas was built with a "
                "different vocabulary (reference gate: src/System.cc:1522)"
            )
    with np.load(path + ".npz") as data:
        kwargs = {k: data[k] for k in data.files}
    return MapState(
        **kwargs,
        active_map=manifest["active_map"],
        n_maps=manifest["n_maps"],
        n_inertial_ba=manifest["n_inertial_ba"],
        imu_initialized=manifest["imu_initialized"],
        loop_edges=[tuple(e) for e in manifest.get("loop_edges", [])],
    )
