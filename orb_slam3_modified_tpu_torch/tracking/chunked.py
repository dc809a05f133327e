"""Chunked tracking: K frames per call, everything on the device.

Port of make_chunk_step from orb_slam3_modified_tpu/tracking/chunked.py
(monocular): batched ORB extraction over the chunk, then the fused track step
for each frame in order, carrying DeviceTrackState. The host driver around it
(ChunkedTracker: cache refresh, keyframe replay, slow path) is not ported yet.
"""
from __future__ import annotations

import torch
from torch import nn

from .. import resolve_device
from ..features.extractor import ExtractorConfig, ORBExtractor
from .fused import DeviceTrackState, MapCache, StepOutput, TrackStep


class ChunkStep(nn.Module):
    """(state, cache, imgs (K, H, W) uint8) -> (state', outs, feats); outs and
    feats are stacked over the K frames and stay on the device."""

    def __init__(self, cam, inv_s2_levels, ecfg: ExtractorConfig, rounds=3, iters=6,
                 device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.extractor = ORBExtractor(ecfg, cam.height, cam.width, device=dev)
        self.step = TrackStep(cam, inv_s2_levels, ecfg.n_features, rounds, iters, device=dev)

    def forward(self, state: DeviceTrackState, cache: MapCache, imgs):
        feats = self.extractor(imgs)
        outs = []
        for k in range(imgs.shape[0]):
            state, out = self.step(
                state, cache, feats.uv[k], feats.desc[k], feats.level[k], feats.valid[k]
            )
            outs.append(out)
        return state, StepOutput(*(torch.stack(f) for f in zip(*outs))), feats


def make_chunk_step(cam, inv_s2_levels, ecfg: ExtractorConfig, rounds=3, iters=6,
                    device="cuda"):
    """The chunk step as a ChunkStep module; frames must be cam.height x cam.width."""
    return ChunkStep(cam, inv_s2_levels, ecfg, rounds, iters, device=device)

