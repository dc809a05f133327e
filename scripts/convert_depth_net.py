#!/usr/bin/env python3
"""Write the port's depth + segmentation weights from the JAX package's.

    JAX_PLATFORMS=cpu python scripts/convert_depth_net.py

Reads orb_slam3_modified_tpu/assets/depth_seg_net.npz (a flax msgpack blob,
which needs flax to read) and writes
orb_slam3_modified_tpu_torch/assets/depth_seg_net.npz: the port's
DepthSegNet state_dict as plain named float32 arrays plus the same `meta`
strings, readable with numpy alone (convert.depth_net_state_dict).
"""
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    from orb_slam3_modified_tpu.models.depth import load_depth_model
    from orb_slam3_modified_tpu_torch import convert
    from orb_slam3_modified_tpu_torch.models.depth import ASSET

    src = os.path.join(ROOT, "orb_slam3_modified_tpu", "assets", "depth_seg_net.npz")
    params, meta = load_depth_model(src)
    state = convert.depth_net_state_dict(params)
    np.savez_compressed(ASSET, **state,
                        meta=np.array([f"{k}={v}" for k, v in sorted(meta.items())]))
    print(f"{len(state)} arrays, meta {meta} -> {ASSET}")


if __name__ == "__main__":
    main()
