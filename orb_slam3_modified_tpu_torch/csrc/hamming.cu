// Hamming distances of 256-bit binary descriptors on the tensor cores, for Hopper
// (sm_90a). Two entries:
//
//   hamming_matrix_launch   out[i, j] = popc(a[i] ^ b[j]), a (n1, 8), b (n2, 8) 32-bit
//                           words, out (n1, n2) int32 row-major;
//   mutual_best_match_launch  the masked (and optionally windowed) mutual-best match of
//                           features/matcher.py on the same distances, fused, so the
//                           (n1, n2) matrix is never written.
//
// Replaces the TPU kernel orb_slam3_modified_tpu/ops/pallas_kernels.py::_hamming_kernel
// (one (128, 128) output tile per sequential grid step, n1 and n2 multiples of 128).
//
// Bit products on the tensor cores: one 256-bit descriptor is exactly the k = 256 of
// mma.sync.m16n8k256.b1, whose .and.popc form gives acc = popc(a & b) for a 16 x 8
// tile in one instruction. Then popc(a ^ b) = popc(a) + popc(b) - 2 * popc(a & b),
// with the row popcounts computed once per tile. The bit order inside a fragment
// register does not matter: A and B take the descriptor's words in the same k order
// and the product is a sum over k.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxDist = 256;  // ops/hamming.py MAX_DIST: what a pair that is not allowed reads

// --- fragments -----------------------------------------------------------------------
// m16n8k256 .b1 (PTX ISA, "Matrix Fragments for mma.m16n8k256"), lane = 4 * g + q:
//   A 16 x 256 row-major, 4 x .b32: a0 = (row g, k 32q..), a1 = (row g + 8, k 32q..),
//                                   a2 = (row g, k 128 + 32q..), a3 = (row g + 8, ..);
//   B 256 x 8 col-major, 2 x .b32:  b0 = (col g, k 32q..), b1 = (col g, k 128 + 32q..);
//   C/D 16 x 8 s32:                 c0, c1 = (row g, cols 2q, 2q + 1), c2, c3 = row g + 8.
// So descriptor word q and word 4 + q go to the lane with that q, for A and B alike.
__device__ __forceinline__ void mma_and_popc(int (&d)[4], uint32_t a0, uint32_t a1,
                                             uint32_t a2, uint32_t a3, uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Descriptors in shared memory: row r's 16-byte halves are swapped when bit 2 of r is
// set, so the 8 rows x 4 words a fragment load touches fall in 32 distinct banks.
__device__ __forceinline__ int swz_half(int row, int half) { return half ^ ((row >> 2) & 1); }

__device__ __forceinline__ uint32_t desc_word(const uint32_t* s, int row, int w) {
  return s[row * 8 + swz_half(row, w >> 2) * 4 + (w & 3)];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int src_bytes = pred ? 16 : 0;  // 0: zero-fill, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ int desc_popc(const uint32_t* s, int row) {
  int p = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) p += __popc(s[row * 8 + w]);
  return p;
}

// --- entry 1: the distance matrix ----------------------------------------------------
// Bound at the main path's shape (4096, 8) x (1024, 8) -> (4096, 1024): the 16 MiB int32
// output write, 5.0 us at 3.35 TB/s; the products, 4096 * 1024 * 256 = 1.07 G bit pairs
// (2.15 G int8-equivalent operations), take 1.1 us at 1,979 TOP/s. So each CTA owns a
// 64 x 64 output tile (1024 CTAs at (4096, 1024), 256 at (1024, 1024): more than one
// wave of 132 SMs), stages its 2 x 64 descriptors (4 KiB) with cp.async, runs 32 MMAs
// (4 warps x 16 rows x 8 column tiles), and stages the tile through shared memory so
// each warp stores whole 128-byte lines.
constexpr int kTile = 64;
constexpr int kLd = kTile + 8;  // padded row of the output stage: conflict-free int2 writes

__global__ void __launch_bounds__(128)
hamming_mma_kernel(const uint4* __restrict__ a, const uint4* __restrict__ b,
                   int32_t* __restrict__ out, int n1, int n2) {
  __shared__ __align__(16) uint32_t sa[kTile * 8];
  __shared__ __align__(16) uint32_t sb[kTile * 8];
  __shared__ int spa[kTile], spb[kTile];
  __shared__ __align__(16) int so[kTile * kLd];

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int i0 = blockIdx.y * kTile, j0 = blockIdx.x * kTile;

  {  // 128 threads: row t >> 1, half t & 1 of both tiles; rows past the edge read as 0
    const int r = t >> 1, h = t & 1;
    const bool ra = i0 + r < n1, rb = j0 + r < n2;
    cp_async16(sa + r * 8 + swz_half(r, h) * 4, a + (ra ? (size_t)(i0 + r) * 2 + h : 0), ra);
    cp_async16(sb + r * 8 + swz_half(r, h) * 4, b + (rb ? (size_t)(j0 + r) * 2 + h : 0), rb);
    cp_async_wait_all();
  }
  __syncthreads();
  if (t < kTile) spa[t] = desc_popc(sa, t);
  else spb[t - kTile] = desc_popc(sb, t - kTile);

  const int r0 = warp * 16 + g;
  const uint32_t a0 = desc_word(sa, r0, q), a1 = desc_word(sa, r0 + 8, q);
  const uint32_t a2 = desc_word(sa, r0, 4 + q), a3 = desc_word(sa, r0 + 8, 4 + q);
  int acc[kTile / 8][4];
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
    mma_and_popc(acc[nt], a0, a1, a2, a3, desc_word(sb, nt * 8 + g, q),
                 desc_word(sb, nt * 8 + g, 4 + q));
  }
  __syncthreads();  // spa, spb

  const int pa0 = spa[r0], pa1 = spa[r0 + 8];
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    const int c = nt * 8 + 2 * q;
    const int pb0 = spb[c], pb1 = spb[c + 1];
    *reinterpret_cast<int2*>(so + r0 * kLd + c) =
        make_int2(pa0 + pb0 - 2 * acc[nt][0], pa0 + pb1 - 2 * acc[nt][1]);
    *reinterpret_cast<int2*>(so + (r0 + 8) * kLd + c) =
        make_int2(pa1 + pb0 - 2 * acc[nt][2], pa1 + pb1 - 2 * acc[nt][3]);
  }
  __syncthreads();

  const int rows = min(kTile, n1 - i0), cols = min(kTile, n2 - j0);
  if ((n2 & 3) == 0) {  // rows start 16-byte aligned: 16 int4 per row, 2 rows per warp
#pragma unroll
    for (int it = 0; it < kTile * kTile / 4 / 128; ++it) {
      const int e = it * 128 + t, r = e >> 4, c = (e & 15) * 4;
      if (r < rows && c < cols)
        *reinterpret_cast<int4*>(out + (size_t)(i0 + r) * n2 + j0 + c) =
            *reinterpret_cast<const int4*>(so + r * kLd + c);
    }
  } else {  // any n2: a warp stores 32 consecutive int32 of one row
#pragma unroll 4
    for (int it = 0; it < kTile * kTile / 128; ++it) {
      const int e = it * 128 + t, r = e >> 6, c = e & 63;
      if (r < rows && c < cols) out[(size_t)(i0 + r) * n2 + j0 + c] = so[r * kLd + c];
    }
  }
}

// --- entry 2: the windowed mutual-best match, fused ---------------------------------
// What features/matcher.py::mutual_best_match computes on the masked matrix
//   d[i, j] = allowed(i, j) ? popc(a[i] ^ b[j]) : 256,
//   allowed = valid1[i] & valid2[j] & (|uv1[i] - uv2[j]|^2 < r[j]^2, when windowed),
// (the window of tracking/fused.py), without writing d: per row its first argmin idx,
// best and second best, per column its first argmin, and
//   ok = best <= max_dist & best < ratio * second & col_argmin[idx] == row.
// Bound at (4096, 1024): about 0.3 MB of inputs and outputs (under 0.0001 ms), against
// the same 2.15 G int8-equivalent products as entry 1 (1.1 us) plus 4 M window tests:
// operations bound it. Design: a CTA owns 32 rows x 256 columns (at (4096, 1024) a grid
// of 128 x 4 = 512 CTAs of 8 warps); each warp runs 2 m-tiles over 4 column tiles of 8,
// so the tensor cores give popc(a & b) and the epilogue masks each pair, pushes it into
// the running row partial and reduces the column over the CTA's rows (shuffles, then
// shared memory); one coalesced atomicMin per column sends the CTA's key (d << 32 | row).
// Row partials of the column splits are merged, and ok computed, by a short second
// kernel. The epilogue, not the tensor cores, sets the time: about 20 instructions per
// pair against 1/32 of a BMMA.
constexpr int kMRows = 32;   // rows per CTA: 2 m-tiles, shared by the warps
constexpr int kMCols = 256;  // columns per CTA
constexpr int kMWarps = 8;   // 4 column tiles of 8 per warp
constexpr int kEmpty = 1023; // best of an empty partial: above every distance
constexpr int kNoIdx = 0x7fffffff;
static_assert(kMCols == 32 * kMWarps, "one thread stages one column");

// Inside a CTA every distance travels as d8 = d << 8 | row in the CTA (0-31), so one
// unsigned min gives a column's first argmin. A row partial is (key = best << 8 | column
// in the CTA, sec8 = second << 8 | any). A pair enters as key = min(key, d << 8 | c): the
// lexicographic min, so ties keep the first column; and sec8 = min(sec8, max(key, d8)),
// whose high part is min(second, max(best, d)): the old best when d wins, else d, and
// best when d ties it, as the scatter-and-amin of the reference gives. Two partials merge
// as key = min(k1, k2), sec8 = min(s1, s2, max(k1, k2)).
__device__ __forceinline__ void part_push(uint32_t& key, uint32_t& sec8, uint32_t d8,
                                          uint32_t c) {
  sec8 = min(sec8, max(key, d8));
  key = min(key, (d8 & 0xffffff00u) | c);
}

__device__ __forceinline__ void part_merge(uint32_t& key, uint32_t& sec8, uint32_t k2,
                                           uint32_t s2) {
  sec8 = min(min(sec8, s2), max(key, k2));
  key = min(key, k2);
}

// The same merge on (best, global idx, second), across the column splits.
__device__ __forceinline__ void part_merge(int& best, int& idx, int& second, int b2, int i2,
                                           int s2) {
  second = min(min(second, s2), max(best, b2));
  if (b2 < best || (b2 == best && i2 < idx)) {
    best = b2;
    idx = i2;
  }
}

// Pair (row, column col) allowed? The window compares in float32 without FMA
// contraction (the intrinsics), so pairs on the boundary fall as they do in torch; an
// invalid row carries u = NaN and an invalid column r^2 = NaN, so the test is false.
// Unwindowed, col.z holds the column's valid flag.
template <bool kWindowed>
__device__ __forceinline__ bool allowed(float u1x, float u1y, bool rvalid, int4 col) {
  if (!kWindowed) return rvalid && col.z != 0;
  const float dx = __fsub_rn(u1x, __int_as_float(col.x));
  const float dy = __fsub_rn(u1y, __int_as_float(col.y));
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) < __int_as_float(col.z);
}

template <bool kWindowed>
__global__ void __launch_bounds__(32 * kMWarps)
match_kernel(const uint32_t* __restrict__ a, const uint8_t* __restrict__ valid1,
             const float2* __restrict__ uv1, const uint4* __restrict__ b,
             const uint8_t* __restrict__ valid2, const float2* __restrict__ uv2,
             const float* __restrict__ radius, int n1, int n2, int* __restrict__ part,
             unsigned long long* __restrict__ col_key) {
  __shared__ __align__(16) uint32_t sb[kMCols * 8];
  __shared__ int4 scol[kMCols];        // u, v, r^2 (float bits) or valid, popc << 8
  __shared__ uint32_t scmin[kMCols];   // each column's min d8 over the CTA's rows
  __shared__ uint2 srow[kMWarps][kMRows];
  const float nan = __int_as_float(0x7fc00000);

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int i0 = blockIdx.x * kMRows, j0 = blockIdx.y * kMCols;

  {  // stage column t; past n2: zero words, not allowed
    const int j = j0 + t;
    uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
    int4 col = make_int4(0, 0, kWindowed ? __float_as_int(nan) : 0, 0);
    if (j < n2) {
      lo = b[(size_t)j * 2];
      hi = b[(size_t)j * 2 + 1];
      const bool v = valid2[j];
      col.w = (__popc(lo.x) + __popc(lo.y) + __popc(lo.z) + __popc(lo.w) + __popc(hi.x) +
               __popc(hi.y) + __popc(hi.z) + __popc(hi.w)) << 8;
      if (kWindowed) {
        const float2 uv = uv2[j];
        const float r = radius[j];
        col.x = __float_as_int(uv.x);
        col.y = __float_as_int(uv.y);
        col.z = __float_as_int(v ? __fmul_rn(r, r) : nan);
      } else {
        col.z = v;
      }
    }
    *reinterpret_cast<uint4*>(sb + t * 8 + swz_half(t, 0) * 4) = lo;
    *reinterpret_cast<uint4*>(sb + t * 8 + swz_half(t, 1) * 4) = hi;
    scol[t] = col;
  }

  // this lane's rows: g, g + 8 (m-tile 0) and g + 16, g + 24 (m-tile 1)
  uint32_t af[2][4], pa8[4], masked8[4], key[4], sec8[4];
  bool rvalid[4];
  float u1x[4], u1y[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = i0 + g + 8 * k;
    const bool exists = i < n1;
    const uint32_t w0 = exists ? a[(size_t)i * 8 + q] : 0u;
    const uint32_t w1 = exists ? a[(size_t)i * 8 + 4 + q] : 0u;
    af[k >> 1][k & 1] = w0;        // a0 / a1: word q of rows g / g + 8
    af[k >> 1][2 + (k & 1)] = w1;  // a2 / a3: word 4 + q
    pa8[k] = __popc(w0) + __popc(w1);
    rvalid[k] = exists && valid1[i];
    // a pair that is not allowed reads 256; a row past n1 is out of every column min
    masked8[k] = exists ? (uint32_t)(kMaxDist << 8 | (g + 8 * k)) : 0xffffffffu;
    u1x[k] = u1y[k] = nan;
    if (kWindowed && rvalid[k]) {
      const float2 uv = uv1[i];
      u1x[k] = uv.x;
      u1y[k] = uv.y;
    }
    key[k] = (uint32_t)kEmpty << 8 | 0xffu;
    sec8[k] = (uint32_t)kMaxDist << 8 | 0xffu;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {  // row popcount: the 4 lanes of a group hold 2 words each
    pa8[k] += __shfl_xor_sync(0xffffffffu, pa8[k], 1);
    pa8[k] += __shfl_xor_sync(0xffffffffu, pa8[k], 2);
    pa8[k] = pa8[k] << 8 | (g + 8 * k);
  }
  __syncthreads();  // sb, scol

  constexpr int kTiles = kMCols / 8 / kMWarps;
#pragma unroll
  for (int nt = warp * kTiles; nt < (warp + 1) * kTiles; ++nt) {
    const uint32_t b0 = desc_word(sb, nt * 8 + g, q), b1 = desc_word(sb, nt * 8 + g, 4 + q);
    int acc[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0;
      mma_and_popc(acc[m], af[m][0], af[m][1], af[m][2], af[m][3], b0, b1);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t c = nt * 8 + 2 * q + e;
      const int4 col = scol[c];
      uint32_t cmin = 0xffffffffu;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        // (pa + pb - 2 popc(a & b)) << 8 | row
        const uint32_t h8 = pa8[k] + (uint32_t)col.w - ((uint32_t)acc[k >> 1][2 * (k & 1) + e] << 9);
        const uint32_t d8 = allowed<kWindowed>(u1x[k], u1y[k], rvalid[k], col) ? h8 : masked8[k];
        part_push(key[k], sec8[k], d8, c);  // a column past n2 reads 256 here: harmless
        cmin = min(cmin, d8);
      }
      cmin = min(cmin, __shfl_xor_sync(0xffffffffu, cmin, 4));
      cmin = min(cmin, __shfl_xor_sync(0xffffffffu, cmin, 8));
      cmin = min(cmin, __shfl_xor_sync(0xffffffffu, cmin, 16));
      if (g == 0) scmin[c] = cmin;
    }
  }

#pragma unroll
  for (int k = 0; k < 4; ++k) {  // merge the 4 lanes of a group, then the warps
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1)
      part_merge(key[k], sec8[k], __shfl_xor_sync(0xffffffffu, key[k], off),
                 __shfl_xor_sync(0xffffffffu, sec8[k], off));
    if (q == 0) srow[warp][g + 8 * k] = make_uint2(key[k], sec8[k]);
  }
  __syncthreads();
  if (j0 + t < n2) {  // one atomic per column: the CTA's min, as (d << 32 | row)
    const uint32_t v = scmin[t];
    atomicMin(col_key + j0 + t, (unsigned long long)(v >> 8) << 32 | (unsigned)(i0 + (v & 0xff)));
  }
  if (t < kMRows && i0 + t < n1) {
    uint32_t k = srow[0][t].x, s = srow[0][t].y;
#pragma unroll
    for (int w = 1; w < kMWarps; ++w) part_merge(k, s, srow[w][t].x, srow[w][t].y);
    const size_t o = (size_t)blockIdx.y * n1 + i0 + t;  // part: (3, splits, n1)
    const size_t plane = (size_t)gridDim.y * n1;
    part[o] = (int)(k >> 8);
    part[plane + o] = j0 + (int)(k & 0xff);
    part[2 * plane + o] = (int)(s >> 8);
  }
}

__global__ void __launch_bounds__(256)
match_finish_kernel(const int* __restrict__ part, int splits, int n1,
                    const unsigned long long* __restrict__ col_key, int max_dist,
                    float ratio, int64_t* __restrict__ idx_out, uint8_t* __restrict__ ok_out,
                    int32_t* __restrict__ dist_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n1) return;
  const size_t plane = (size_t)splits * n1;
  int best = kEmpty, idx = kNoIdx, second = kMaxDist;
  for (int s0 = 0; s0 < splits; s0 += 4) {  // 4 splits' loads in flight, then their merges
    int3 p[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const size_t o = (size_t)(s0 + u) * n1 + i;
      p[u] = s0 + u < splits ? make_int3(part[o], part[plane + o], part[2 * plane + o])
                             : make_int3(kEmpty, kNoIdx, kMaxDist);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) part_merge(best, idx, second, p[u].x, p[u].y, p[u].z);
  }
  const bool mutual = (uint32_t)col_key[idx] == (uint32_t)i;
  // float32, as `best < ratio * second` is in torch and JAX
  const bool ratio_ok = __int2float_rn(best) < __fmul_rn(ratio, __int2float_rn(second));
  idx_out[i] = idx;
  dist_out[i] = best;
  ok_out[i] = (best <= max_dist) && ratio_ok && mutual;
}

}  // namespace

// a, b: 16-byte aligned (n, 8) 32-bit words; out: (n1, n2) int32; stream: cudaStream_t.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int hamming_matrix_launch(const void* a, const void* b, void* out, int n1,
                                     int n2, void* stream) {
  if (n1 <= 0 || n2 <= 0) return 0;
  const dim3 grid((n2 + kTile - 1) / kTile, (n1 + kTile - 1) / kTile);
  hamming_mma_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(a), static_cast<const uint4*>(b),
      static_cast<int32_t*>(out), n1, n2);
  return static_cast<int>(cudaGetLastError());
}

// The fused match. desc1 (n1, 8) / desc2 (n2, 8): 16-byte aligned 32-bit words;
// valid1 (n1,) / valid2 (n2,): bytes 0 or 1; uv1 (n1, 2), uv2 (n2, 2), radius (n2,):
// float32, all three null for no window. part: (3, part_splits, n1) int32 scratch, where
// part_splits must be ceil(n2 / kMCols) (the caller's sizing is checked, not trusted);
// col_key: (n2,) 64-bit scratch, set here to all ones before the atomics. Outputs idx
// (n1,) int64, ok (n1,) bytes, dist (n1,) int32. n1, n2 >= 1. Returns cudaGetLastError(),
// or cudaErrorInvalidValue before any launch when the sizes do not hold.
extern "C" int mutual_best_match_launch(const void* desc1, const void* valid1,
                                        const void* uv1, const void* desc2,
                                        const void* valid2, const void* uv2,
                                        const void* radius, int n1, int n2, int max_dist,
                                        float ratio, void* part, int part_splits,
                                        void* col_key, void* idx, void* ok, void* dist,
                                        void* stream) {
  const int splits = (n2 + kMCols - 1) / kMCols;
  if (n1 <= 0 || n2 <= 0 || part_splits != splits || splits > 65535)  // grid.y: the splits
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(col_key, 0xff, (size_t)n2 * sizeof(unsigned long long), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n1 + kMRows - 1) / kMRows, splits);
  const auto kernel = uv1 != nullptr ? match_kernel<true> : match_kernel<false>;
  kernel<<<grid, 32 * kMWarps, 0, s>>>(
      static_cast<const uint32_t*>(desc1), static_cast<const uint8_t*>(valid1),
      static_cast<const float2*>(uv1), static_cast<const uint4*>(desc2),
      static_cast<const uint8_t*>(valid2), static_cast<const float2*>(uv2),
      static_cast<const float*>(radius), n1, n2, static_cast<int*>(part),
      static_cast<unsigned long long*>(col_key));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  match_finish_kernel<<<(n1 + 255) / 256, 256, 0, s>>>(
      static_cast<const int*>(part), splits, n1,
      static_cast<const unsigned long long*>(col_key), max_dist, ratio,
      static_cast<int64_t*>(idx), static_cast<uint8_t*>(ok), static_cast<int32_t*>(dist));
  return static_cast<int>(cudaGetLastError());
}
