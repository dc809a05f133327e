"""Card-only tests of the port's hand-written CUDA kernels (marker `cuda`).

A CUDA kernel has no CPU mode, so each test checks inside its body for a
card and skips without one. The machine with the card has no JAX, so this
file imports only the port; run it there with

    python -m pytest tests/test_torch_cuda_kernels.py --noconftest -q -p no:cacheprovider
"""
from unittest import mock

import numpy as np
import pytest
import torch

from orb_slam3_modified_tpu_torch import convert
from orb_slam3_modified_tpu_torch.features import matcher
from orb_slam3_modified_tpu_torch.ops import hamming as th


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _desc(rng, n, dev):
    return convert.desc_from_uint32(rng.integers(0, 2**32, (n, 8), dtype=np.uint32), device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n1,n2", [(4096, 1024), (1024, 1024), (1000, 333), (1, 1), (65, 129)])
def test_hamming_kernel_matches_plain(n1, n2):
    dev = _card()
    rng = np.random.default_rng(n1 * 7 + n2)
    a, b = _desc(rng, n1, dev), _desc(rng, n2, dev)
    before = th.HAMMING_KERNEL.launches
    out = th.hamming_matrix(a, b)
    torch.cuda.synchronize()
    assert th.HAMMING_KERNEL.launches == before + 1
    assert out.dtype == torch.int32 and out.shape == (n1, n2)
    assert torch.equal(out, th.hamming_matrix_plain(a, b))


@pytest.mark.cuda
def test_hamming_wrapper_rejects_what_the_kernel_does_not_take():
    dev = _card()
    a = _desc(np.random.default_rng(0), 64, dev)
    with pytest.raises(ValueError):
        th.hamming_matrix(a.to(torch.int64), a.to(torch.int64))
    with pytest.raises(ValueError):
        th.hamming_matrix(a[:, :4].contiguous(), a[:, :4].contiguous())
    with pytest.raises(ValueError):
        th.hamming_matrix(a.t().contiguous().t(), a)
    with pytest.raises(ValueError):
        th.hamming_matrix(a, a.cpu())


@pytest.mark.cuda
def test_chunk_step_kernel_path_equals_plain_path():
    """A small chunk on the card: the kernel path launches and gives the
    poses of the plain-Hamming path bit for bit."""
    dev = _card()
    from orb_slam3_modified_tpu_torch.cameras import Camera
    from orb_slam3_modified_tpu_torch.features.extractor import ExtractorConfig, ORBExtractor
    from orb_slam3_modified_tpu_torch.lie.se3 import SE3
    from orb_slam3_modified_tpu_torch.tracking.chunked import make_chunk_step
    from orb_slam3_modified_tpu_torch.tracking.fused import DeviceTrackState
    from orb_slam3_modified_tpu_torch.tracking.tracker import inv_level_sigma2
    from orb_slam3_modified_tpu_torch.utils.synthetic import orbit_trajectory
    from orb_slam3_modified_tpu_torch.utils.synthetic_dataset import (
        make_texture, render_sequence, seed_map_cache,
    )

    k = 320 / 752
    cam = Camera.pinhole(458.654 * k, 457.296 * k, 367.215 * k, 248.375 * k, 320, 240, device=dev)
    cfg = ExtractorConfig(n_features=256, n_levels=4)
    T_all = orbit_trajectory(400, radius=4.0, sweep=np.pi / 2)
    T = SE3(T_all.R[:30], T_all.t[:30])
    frames = torch.from_numpy(render_sequence(cam, T, make_texture(0, 96, 1024))).to(dev)
    kf = [0, 8, 16, 24]
    cache = seed_map_cache(cam, ORBExtractor(cfg, 240, 320, device=dev)(frames[kf]),
                           SE3(T.R[kf], T.t[kf]), 2.0, 1024)
    state = DeviceTrackState(T.R[1].to(dev), T.t[1].to(dev), T.R[0].to(dev), T.t[0].to(dev),
                             torch.ones((), dtype=torch.bool, device=dev))
    inv_s2 = inv_level_sigma2(4, 1.2)
    before = th.HAMMING_KERNEL.launches
    _, outs, _ = make_chunk_step(cam, inv_s2, cfg, device=dev)(state, cache, frames[2:6])
    assert th.HAMMING_KERNEL.launches > before
    with mock.patch.object(matcher, "hamming_matrix", th.hamming_matrix_plain):
        _, outs_p, _ = make_chunk_step(cam, inv_s2, cfg, device=dev)(state, cache, frames[2:6])
    assert torch.equal(outs.R, outs_p.R) and torch.equal(outs.t, outs_p.t)
    assert torch.equal(outs.obs_cache_idx, outs_p.obs_cache_idx)
    err = torch.linalg.norm(outs.t.cpu() - T.t[2:6], dim=-1)
    assert float(err.max()) < 0.05
