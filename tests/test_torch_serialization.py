"""Port parity for slam_map/serialization.py (atlas save / resume).

tests/test_serialization.py's round trip and vocabulary-checksum gate on
the port, and atlases across the two packages both ways: one written by
the reference loads in the port and one written by the port loads in the
reference, every array (dtype included) and the manifest's scalars and
loop edges equal.
"""
import dataclasses

import numpy as np
import pytest

from orb_slam3_modified_tpu.bow.vocabulary import build_vocabulary as j_build_vocabulary
from orb_slam3_modified_tpu.slam_map import serialization as jser
from orb_slam3_modified_tpu.slam_map.map_state import MapState as JMapState
from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.bow.vocabulary import build_vocabulary
from orb_slam3_modified_tpu_torch.slam_map import serialization as pser
from orb_slam3_modified_tpu_torch.slam_map.map_state import MapState


def make_map(cls=MapState):
    """tests/test_serialization.py's map, plus a second map, a loop edge and
    the inertial flags, so every manifest field carries a value."""
    rng = np.random.default_rng(0)
    m = cls.create(max_kf=16, max_mp=256, feat_cap=32)
    k = m.alloc_keyframe()
    m.kf_t[k] = [1, 2, 3]
    mp = m.alloc_points(10)
    m.mp_pos[mp] = np.arange(30).reshape(10, 3)
    m.kf_obs[k, :10] = mp
    m.kf_frame_id[k] = 4
    m.kf_ts[k] = 1403636579.763555584
    m.kf_desc[k] = rng.integers(0, 2**32, m.kf_desc[k].shape, dtype=np.uint32)
    m.create_new_map()
    k2 = m.alloc_keyframe()
    m.kf_frame_id[k2] = 9
    m.kf_vel[k2] = [0.5, -0.25, 0.125]
    m.add_loop_edge(k, k2)
    m.n_inertial_ba, m.imu_initialized = 2, True
    return m


def _same_maps(a, b):
    names = [f.name for f in dataclasses.fields(a)]
    assert names == [f.name for f in dataclasses.fields(b)]
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), name
    for name in ("active_map", "n_maps", "n_inertial_ba", "imu_initialized"):
        assert getattr(a, name) == getattr(b, name), name
    assert [tuple(e) for e in a.loop_edges] == [tuple(e) for e in b.loop_edges]


def test_roundtrip(tmp_path):
    m = make_map()
    p = str(tmp_path / "atlas")
    pser.save_atlas(p, m)
    m2 = pser.load_atlas(p)
    _same_maps(m, m2)
    assert m2.n_keyframes(all_maps=True) == 2 and m2.n_points(all_maps=True) == 10


def test_vocab_checksum_gate(tmp_path):
    rng = np.random.default_rng(0)
    voc1 = build_vocabulary(rng.integers(0, 2**32, (500, 8), dtype=np.uint32), k=4, depth=2)
    voc2 = build_vocabulary(rng.integers(0, 2**32, (500, 8), dtype=np.uint32), k=4, depth=2,
                            seed=9)
    p = str(tmp_path / "atlas")
    pser.save_atlas(p, make_map(), voc=voc1)
    pser.load_atlas(p, voc=voc1)  # ok
    with pytest.raises(ValueError, match="checksum"):
        pser.load_atlas(p, voc=voc2)


def test_atlases_load_across_the_packages(tmp_path):
    """Written by the reference -> loaded by the port, and the other way,
    with the same vocabulary checksum in both manifests."""
    rng = np.random.default_rng(1)
    descs = rng.integers(0, 2**32, (400, 8), dtype=np.uint32)
    jvoc, pvoc = (build(descs, k=4, depth=2) for build in (j_build_vocabulary, build_vocabulary))
    assert pser._voc_checksum(pvoc) == jser._voc_checksum(jvoc) != ""

    ref = make_map(JMapState)
    p = str(tmp_path / "from_reference")
    jser.save_atlas(p, ref, voc=jvoc)
    _same_maps(pser.load_atlas(p, voc=pvoc), convert.map_state(ref))

    port = make_map()
    p = str(tmp_path / "from_port")
    pser.save_atlas(p, port, voc=pvoc)
    back = jser.load_atlas(p, voc=jvoc)
    _same_maps(port, convert.map_state(back))
    with pytest.raises(ValueError, match="checksum"):
        jser.load_atlas(p, voc=j_build_vocabulary(descs[::-1].copy(), k=4, depth=2, seed=3))
