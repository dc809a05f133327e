"""Build and load the hand-written CUDA kernels of csrc/ (nvcc + ctypes).

Each kernel source has a plain C entry point, so it compiles in seconds
without PyTorch's headers. `nvcc` is run at first use into `_build/`, which
git ignores. A wrapper launches through a CudaKernel, which counts its
launches.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME/bin")


class CudaKernel:
    """One csrc/<source> built into _build/lib<stem>.so; `symbol` is its C
    launcher, which returns cudaGetLastError() after the launch.

    `launches` counts successful launches through __call__ only."""

    def __init__(self, source: str, symbol: str, argtypes):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.library = BUILD_DIR / f"lib{self.source.stem}.so"
        self.launches = 0
        self.build_info = None  # {"cmd", "seconds", "ptxas"} of the last build
        self._fn = None

    def build(self):
        """Compile if the library is missing or older than its source, then
        load it. Returns build_info (None when an existing build was used)."""
        if self._fn is not None:
            return self.build_info
        if not self.library.exists() or self.library.stat().st_mtime < self.source.stat().st_mtime:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = self.library.with_name(f"{self.library.name}.{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) for {self.source}:\n{proc.stdout}"
                )
            os.replace(tmp, self.library)
            self.build_info = {
                "cmd": " ".join(cmd),
                "seconds": time.perf_counter() - t0,
                "ptxas": proc.stdout.strip(),
            }
        fn = getattr(ctypes.CDLL(str(self.library)), self.symbol)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        self._fn = fn
        return self.build_info

    def __call__(self, *args):
        if self._fn is None:
            self.build()
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.symbol} failed: cudaError {rc}")
        self.launches += 1
