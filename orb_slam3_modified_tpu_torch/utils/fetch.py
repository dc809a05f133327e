"""Device -> host readback of result trees.

Port of orb_slam3_modified_tpu/utils/fetch.py. `Readback(tree)` starts one
non-blocking copy per CUDA tensor into a pinned host buffer on the current
stream and records one event; `.wait()` synchronizes on that event and
returns the tree with numpy arrays in place of tensors. The lag-1 chunk
pipeline starts a readback at dispatch and waits a chunk later, so chunk
i's outputs copy while chunk i+1 is dispatched. `fetch(tree)` is both at
once. CPU tensors are copied synchronously. Trees are (named) tuples,
lists, dicts and leaves; non-tensor leaves pass through.
"""
from __future__ import annotations

import numpy as np
import torch


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


class Readback:
    """Copies of a tree's tensors into host memory, started now, read by wait()."""

    def __init__(self, tree):
        self.event = None

        def start(t):
            t = t.detach()
            if t.device.type != "cuda":
                return t.numpy().copy()
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            if self.event is None:
                self.event = torch.cuda.Event()
            return host

        self._tree = _map(start, tree)
        if self.event is not None:
            self.event.record()  # after every copy: one sync covers them all

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return _map(lambda t: t.numpy(), self._tree)


def fetch(tree):
    """Tensor tree -> numpy tree (writable arrays), one event sync."""
    return Readback(tree).wait()


def upload(arr: np.ndarray, device) -> torch.Tensor:
    """One numpy array -> a tensor on `device`: a pinned staging copy and one
    non-blocking transfer on the current stream for CUDA, a copy for the CPU."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # e.g. a read-only view of another library's buffer
        arr = arr.copy()
    src = torch.from_numpy(arr)
    if torch.device(device).type != "cuda":
        return src.clone()
    return src.pin_memory().to(device, non_blocking=True)
