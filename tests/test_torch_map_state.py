"""Port parity: the numpy map arena and the native covisibility engine.

The port keeps its own copy of slam_map/map_state.py and native/covis.cc.
Gates: after the same sequence of operations (allocation, observations,
point statistics, culling, fusion, keyframe removal with the spanning-tree
redirect, a new map) both arenas are array-equal, field by field; the
port's native library (built with g++ into the package's _build/) and its
numpy paths agree; the cases of tests/test_map_state.py and
tests/test_native.py hold on the port.
"""
import dataclasses

import numpy as np
import pytest

from orb_slam3_modified_tpu.slam_map.map_state import MapState as JMapState
from orb_slam3_modified_tpu_torch import native
from orb_slam3_modified_tpu_torch.slam_map.map_state import NO_POINT, MapState


def _ops(m, seed=0):
    """A fixed random sequence of arena operations (the same on both)."""
    rng = np.random.default_rng(seed)
    sf = 1.2 ** np.arange(8)
    pts = m.alloc_points(60)
    m.mp_pos[pts] = rng.normal(0, 1, (60, 3)).astype(np.float32) + [0, 0, 5]
    kfs = []
    for i in range(6):
        k = m.alloc_keyframe()
        kfs.append(k)
        m.kf_R[k] = np.eye(3, dtype=np.float32)
        m.kf_t[k] = np.array([0.3 * i, 0.05 * i, 0], np.float32)
        m.kf_frame_id[k] = 10 * i
        m.kf_parent[k] = kfs[-2] if i else -1
        sel = rng.permutation(60)[: 50 - 3 * i]
        m.kf_obs[k, : len(sel)] = pts[sel]
        m.kf_feat_valid[k, : len(sel)] = True
        m.kf_level[k, : len(sel)] = rng.integers(0, 8, len(sel))
        m.kf_desc[k] = rng.integers(0, 2**32, (m.kf_desc.shape[1], 8), dtype=np.uint32)
        m.kf_uv[k] = rng.uniform(0, 700, (m.kf_uv.shape[1], 2)).astype(np.float32)
    _, mps = m.observations_of_kf(kfs[0])
    m.update_point_stats(mps, sf)
    m.update_point_stats(np.concatenate([pts[:5], pts[:5], pts[4::-1]]), sf)
    m.remove_point(pts[[3, 17, 40]])
    m.replace_point(int(pts[5]), int(pts[6]))
    m.remove_keyframe(kfs[2])
    m.update_point_stats(pts, sf)
    out = [m.covisibility_weights(k) for k in kfs] + [m.obs_count_per_point(),
                                                       m.point_observers(pts[:20]),
                                                       m.best_covisible(kfs[1], 3, 5)]
    m.create_new_map()
    k = m.alloc_keyframe()
    m.kf_frame_id[k] = 99
    new_pts = m.alloc_points(4)
    return out + [m.keyframe_indices(), m.point_indices(all_maps=True), np.array([k]), new_pts]


def _fields(m):
    return {f.name: getattr(m, f.name) for f in dataclasses.fields(m)
            if isinstance(getattr(m, f.name), np.ndarray)}


def test_same_operations_give_equal_arenas():
    j = JMapState.create(max_kf=16, max_mp=128, feat_cap=64)
    t = MapState.create(max_kf=16, max_mp=128, feat_cap=64)
    jq, tq = _ops(j), _ops(t)
    for a, b in zip(jq, tq):
        np.testing.assert_array_equal(b, a)
    jf, tf = _fields(j), _fields(t)
    assert jf.keys() == tf.keys()
    for name in jf:
        assert tf[name].dtype == jf[name].dtype, name
        np.testing.assert_array_equal(tf[name], jf[name], err_msg=name)
    assert (t.active_map, t.n_maps) == (j.active_map, j.n_maps)
    assert t.culled_redirect.keys() == j.culled_redirect.keys()
    for key in j.culled_redirect:
        np.testing.assert_array_equal(t.culled_redirect[key][2], j.culled_redirect[key][2])


@pytest.fixture(scope="module")
def arena():
    """tests/test_native.py's arena."""
    rng = np.random.default_rng(0)
    m = MapState.create(max_kf=32, max_mp=512, feat_cap=64)
    for _ in range(10):
        k = m.alloc_keyframe()
        n = rng.integers(20, 60)
        mp = rng.choice(512, n, replace=False)
        m.mp_valid[mp] = True
        m.kf_obs[k, rng.choice(64, n, replace=False)] = mp
    return m


def test_native_builds_into_the_package_build_dir():
    assert native.get_lib() is not None, "g++ build failed"
    assert native.LIBRARY.parent.name == "_build" and native.LIBRARY.exists()


def test_native_and_numpy_paths_agree(arena, monkeypatch):
    m = arena
    pts = m.point_indices()[:20]
    got = ([m.covisibility_weights(int(k)) for k in m.keyframe_indices()]
           + [m.obs_count_per_point(), m.point_observers(pts)])
    monkeypatch.setattr(native, "get_lib", lambda: None)  # the numpy paths
    want = ([m.covisibility_weights(int(k)) for k in m.keyframe_indices()]
            + [m.obs_count_per_point(), m.point_observers(pts)])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_unsorted_point_list_normals():
    """tests/test_map_state.py: slot-order (unsorted) ids give the normals
    of the per-point loop."""
    rng = np.random.default_rng(0)
    m = MapState.create(max_kf=16, max_mp=256, feat_cap=64)
    pts = m.alloc_points(24)
    m.mp_pos[pts] = rng.normal(0, 1, (24, 3)).astype(np.float32) + [0, 0, 5]
    for i in range(4):
        k = m.alloc_keyframe()
        m.kf_t[k] = np.array([0.4 * i, 0.1 * i, 0], np.float32)
        sel = rng.permutation(24)[: 24 - 2 * i]
        m.kf_obs[k, : len(sel)] = pts[sel]
        m.kf_level[k, : len(sel)] = rng.integers(0, 4, len(sel))
    _, mps = m.observations_of_kf(0)
    assert not np.all(np.diff(mps) > 0)
    m.update_point_stats(mps, 1.2 ** np.arange(4))
    for mp in mps:
        ks, _ = np.where((m.kf_obs == mp) & m.kf_valid[:, None])
        vec = m.mp_pos[mp] - np.stack([-m.kf_R[k].T @ m.kf_t[k] for k in ks])
        s = (vec / np.linalg.norm(vec, axis=-1, keepdims=True)).sum(0)
        np.testing.assert_allclose(m.mp_normal[mp], s / np.linalg.norm(s), atol=1e-5)
    assert (m.kf_obs[m.kf_obs != NO_POINT] >= 0).all()
