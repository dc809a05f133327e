// All-pairs Hamming distance of 256-bit binary descriptors, for Hopper (sm_90a).
//
//   out[i, j] = sum_w popc(a[i, w] ^ b[j, w]),  a (n1, 8), b (n2, 8) 32-bit words,
//   out (n1, n2) int32 row-major.
//
// Replaces the TPU kernel orb_slam3_modified_tpu/ops/pallas_kernels.py::_hamming_kernel
// (one (128, 128) output tile per sequential grid step, n1 and n2 multiples of 128).
//
// Bound at the main path's shape (4096, 8) x (1024, 8) -> (4096, 1024):
//   bytes: 160 KB of descriptors in, 16 MiB of int32 out -> ~5.0 us at 3.35 TB/s;
//   operations: 4096*1024*8 = 33.6 M word pairs, each XOR + POPC + ADD. POPC issues
//   at 16 per SM per clock on compute capability 9.0 (a quarter of the 64/clk of
//   XOR and ADD), so 33.6 M POPC / (132 SMs * 16 * 1.98 GHz) = ~8.0 us.
//   So integer throughput (POPC), not bytes, bounds it on this card.
// Design: the output write is the only large traffic, so each thread owns one
// output column j and keeps b[j] (32 bytes) in registers; each CTA stages 64 rows of
// a in shared memory, which every thread of a warp reads at the same address (a
// broadcast, no bank conflicts). A warp's stores for one row are 32 consecutive
// int32, so every store is coalesced. Ragged edges are masked, so n1 and n2 take any
// value. This is the simple kernel: the later redesign fuses the mask, the row best /
// second best and the column argmin of mutual_best_match so the matrix never
// reaches device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 128;  // b rows per CTA = threads per CTA, one output column each
constexpr int kRows = 64;   // a rows per CTA, staged in shared memory

__global__ void __launch_bounds__(kCols)
hamming_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
               int32_t* __restrict__ out, int n1, int n2) {
  __shared__ uint4 sa[kRows][2];
  const int i0 = blockIdx.y * kRows;
  const int j = blockIdx.x * kCols + threadIdx.x;

  {  // 128 threads stage 64 rows x 2 uint4
    const int r = threadIdx.x >> 1;
    const int h = threadIdx.x & 1;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (i0 + r < n1) v = a[(size_t)(i0 + r) * 2 + h];
    sa[r][h] = v;
  }
  uint4 b0 = make_uint4(0u, 0u, 0u, 0u), b1 = b0;
  if (j < n2) {
    b0 = b[(size_t)j * 2];
    b1 = b[(size_t)j * 2 + 1];
  }
  __syncthreads();
  if (j >= n2) return;

  const int rows = min(kRows, n1 - i0);
  int32_t* o = out + (size_t)i0 * n2 + j;
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    const uint4 lo = sa[r][0];
    const uint4 hi = sa[r][1];
    const int d = __popc(lo.x ^ b0.x) + __popc(lo.y ^ b0.y) + __popc(lo.z ^ b0.z) +
                  __popc(lo.w ^ b0.w) + __popc(hi.x ^ b1.x) + __popc(hi.y ^ b1.y) +
                  __popc(hi.z ^ b1.z) + __popc(hi.w ^ b1.w);
    o[(size_t)r * n2] = d;
  }
}

}  // namespace

// a, b: 16-byte aligned (n, 8) 32-bit words; out: (n1, n2) int32; stream: cudaStream_t.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hamming_matrix_launch(const void* a, const void* b, void* out, int n1,
                                     int n2, void* stream) {
  if (n1 <= 0 || n2 <= 0) return 0;
  const dim3 grid((n2 + kCols - 1) / kCols, (n1 + kRows - 1) / kRows);
  hamming_kernel<<<grid, kCols, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b),
      static_cast<int32_t*>(out), n1, n2);
  return static_cast<int>(cudaGetLastError());
}
