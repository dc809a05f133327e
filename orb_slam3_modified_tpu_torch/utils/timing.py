"""Per-stage timing instrumentation.

TPU-native replacement for the REGISTER_TIMES machinery (reference:
include/Settings.h:24 compile flag, Tracking::PrintTimeStats
src/Tracking.cc:263 dumping mean/median per stage to ExecTimeMean.txt).
Always-on but near-zero overhead (perf_counter pairs on the host).
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np


class TimeStats:
    def __init__(self):
        self.samples = defaultdict(list)

    @contextlib.contextmanager
    def measure(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def summary(self) -> dict:
        out = {}
        for name, xs in self.samples.items():
            a = np.array(xs)
            out[name] = {
                "mean_ms": float(a.mean() * 1e3),
                "median_ms": float(np.median(a) * 1e3),
                "count": len(xs),
            }
        return out

    def dump(self, path: str | None = None) -> str:
        """Human-readable table (the reference writes ExecTimeMean.txt)."""
        lines = [f"{'stage':<16}{'mean ms':>10}{'median ms':>12}{'count':>8}"]
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:<16}{s['mean_ms']:>10.2f}{s['median_ms']:>12.2f}{s['count']:>8}"
            )
        text = "\n".join(lines)
        if path:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text
