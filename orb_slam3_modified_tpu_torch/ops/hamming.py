"""Binary descriptor Hamming distances.

Port of orb_slam3_modified_tpu/ops/hamming.py and of the TPU kernel
ops/pallas_kernels.py::_hamming_kernel. Descriptors are (N, 8) int32 holding
the reference's 256 bits.

`hamming_matrix` is the distance matrix. On CUDA tensors it launches the
hand-written kernel csrc/hamming.cu (bit products on the tensor cores) or
raises; it takes the plain torch version only for CPU tensors.
`hamming_matrix_plain` is that plain version: the CPU tests run it, and the
chip check holds the kernel against it. The matcher's path on the card is the
fused entry of the same source (features/matcher.py), which never writes the
matrix.
"""
from __future__ import annotations

import ctypes

import torch

from .._cuda import CudaKernel

MAX_DIST = 256
N_WORDS = 8

HAMMING_KERNEL = CudaKernel(
    "hamming.cu",
    "hamming_matrix_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
     ctypes.c_void_p],
)
MATRIX_TILE = 64  # csrc/hamming.cu kTile: a block owns a 64 x 64 output tile, 128 threads
_MAX_ROW_BLOCKS = 65535  # grid.y limit


def popcount32(x):
    """Bit count of each int32 element (torch has no popcount op).

    SWAR on the low 31 bits, which stay non-negative so no step overflows,
    plus the sign bit."""
    low = x & 0x7FFFFFFF
    low = low - ((low >> 1) & 0x55555555)
    low = (low & 0x33333333) + ((low >> 2) & 0x33333333)
    low = (low + (low >> 4)) & 0x0F0F0F0F
    low = low + (low >> 8)
    low = low + (low >> 16)
    return (low & 0x3F) + (x < 0).to(x.dtype)


def _pm1(d):
    """(N, 8) int32 -> (N, 256) float32 of +-1 (bit set -> -1)."""
    shifts = torch.arange(32, dtype=torch.int32, device=d.device)
    bits = (d[..., None] >> shifts) & 1
    return (1 - 2 * bits.reshape(d.shape[0], N_WORDS * 32)).to(torch.float32)


def hamming_matrix_plain(d1, d2):
    """(N1, 8) x (N2, 8) int32 -> (N1, N2) int32, as a product of +-1 bits:
    popc(a ^ b) = (256 - <pm1(a), pm1(b)>) / 2. Every partial sum is an
    integer of magnitude <= 256, so the float32 product is exact in any
    summation order (TF32 too: +-1 is exact in it)."""
    dot = _pm1(d1) @ _pm1(d2).T
    return ((MAX_DIST - dot) / 2).to(torch.int32)


def check_desc(d, name):
    if d.dtype != torch.int32 or d.dim() != 2 or d.shape[1] != N_WORDS:
        raise ValueError(f"{name}: expected (N, {N_WORDS}) int32, got {tuple(d.shape)} {d.dtype}")
    if not d.is_contiguous() or d.data_ptr() % 16:
        raise ValueError(f"{name}: must be contiguous and 16-byte aligned")


def hamming_matrix(d1, d2):
    """(N1, 8) x (N2, 8) int32 -> (N1, N2) int32 Hamming distances."""
    if d1.device.type == "cpu" and d2.device.type == "cpu":
        return hamming_matrix_plain(d1, d2)
    if d1.device.type != "cuda" or d1.device != d2.device:
        raise ValueError(f"hamming_matrix: tensors on {d1.device} and {d2.device}")
    check_desc(d1, "d1")
    check_desc(d2, "d2")
    n1, n2 = d1.shape[0], d2.shape[0]
    if n1 > _MAX_ROW_BLOCKS * MATRIX_TILE:
        raise ValueError(f"hamming_matrix: n1={n1} exceeds the kernel's grid")
    out = torch.empty((n1, n2), dtype=torch.int32, device=d1.device)
    if n1 and n2:
        with torch.cuda.device(d1.device):
            HAMMING_KERNEL(
                d1.data_ptr(), d2.data_ptr(), out.data_ptr(), n1, n2,
                torch.cuda.current_stream().cuda_stream,
            )
    return out


def hamming_pairs(d1, d2):
    """Row-wise distances for aligned pairs: (N, 8), (N, 8) -> (N,) int32."""
    return torch.sum(popcount32(d1 ^ d2), dim=-1, dtype=torch.int32)
