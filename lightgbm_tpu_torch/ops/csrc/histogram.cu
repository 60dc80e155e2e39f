// Whole-dataset histogram for Hopper (sm_90a): kernel B6.
//
// Replaces the Pallas kernel lightgbm_tpu/ops/histogram.py::histogram_pallas
// (pallas_call at histogram.py:278).  It computes, per (feature, bin), the
// sums of g*w, h*w and w over all rows of a value block [3, n] f32 that the
// caller has already masked ((g, h, 1) * mask): the staged arm's root
// histogram.  On the TPU the kernel kept a [Ft, 3, B] f32 accumulator in
// VMEM across the sequential row-block axis of its grid; on Hopper blocks
// run in no order, so the grid is (row chunk, feature tile), each block
// keeps its own [Ft, 3, B] arena in shared memory and flushes it into the
// output with global atomics.
//
//   histogram_kernel  binned [F, n] u8/i32, vals [3, n] f32
//                     -> hist [3, F, B] int64 (fixed point)
//
// Exact fixed point (fixed_point.cuh, shared with fused.cu): each row's
// three values are quantized once, as llrint(ldexp((double)v, s_c)), and
// summed in int64 arithmetic.  Integer adds are associative, so the result
// is the same bits in any order and equals the plain PyTorch version
// (ops/histogram.py histogram_plain, an int64 index_add_) bit for bit.
// Bins >= B are dropped, as the Pallas one-hot drops them.
//
// What bounds it on the H100.  The bound is bytes: F*n binned bytes, 12*n
// value bytes and the 24*F*B output bytes.  The old design was held back
// by its 64-bit shared atomics, which compile to a compare-and-swap loop
// (ATOMS.CAST.SPIN.64), one per (row, feature, channel), spinning 32 lanes
// deep on a bundle's most frequent bin.  This design:
//   - keeps each arena cell as uint32 hi/lo halves and adds with 32-bit
//     atomics and the exact carry (fixed_point.cuh add_fixed_split), so
//     the shared atomics are native ATOMS.ADD;
//   - gives each thread 4 consecutive rows: one 4-byte load of a
//     feature's uint8 bins (16 bytes for int32 bins) and one float4 a
//     channel (kVec: n % 4 == 0 and 16-byte aligned inputs, else scalar
//     loads), each row quantized once and reused across the tile's
//     features; rows whose three values are 0 add nothing;
//   - tiles the features by ops/planner.py hist_feat_tile (no 1-feature
//     tail tile) and flushes only non-zero cells, with native 64-bit global
//     atomics (REDG.E.ADD.64).
// Not kept: folding a warp's lanes that share a bin before the shared add
// (exact, as integer sums: __reduce_add_sync of the hi word and of the lo
// word's 16-bit halves).  With __match_any_sync over every distinct bin
// it was slower, its reductions serialised group by group; with a ballot
// on one leader lane's bin it gained nothing measurable on the one-hot
// table's bundles and lost on the 28-feature matrix (times in PERF.md).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//        --fmad=false -shared -Xcompiler -fPIC.
// The entry allocates nothing, launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "fixed_point.cuh"

namespace {

constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;
// consecutive rows a thread (ops/planner.py HIST_ROWS_PER_THREAD)
constexpr int kRows = 4;

// the 4 bins of feature row `col` at rows r .. r + 3 (those < r1)
template <typename BinT, bool kVec>
__device__ __forceinline__ void load_bins(const BinT* __restrict__ col,
                                          long long r, long long r1,
                                          int (&b)[kRows]) {
  if (kVec && r + kRows <= r1) {
    if constexpr (sizeof(BinT) == 1) {
      const unsigned w = __ldg(reinterpret_cast<const unsigned*>(col + r));
#pragma unroll
      for (int u = 0; u < kRows; ++u) b[u] = (w >> (8 * u)) & 0xff;
    } else {
      const int4 w = __ldg(reinterpret_cast<const int4*>(col + r));
      b[0] = w.x; b[1] = w.y; b[2] = w.z; b[3] = w.w;
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < kRows; ++u)
    b[u] = r + u < r1 ? static_cast<int>(__ldg(col + r + u)) : -1;
}

// channel c of rows r .. r + 3 (0 past r1)
template <bool kVec>
__device__ __forceinline__ void load_vals(const float* __restrict__ v,
                                          long long r, long long r1,
                                          float (&x)[kRows]) {
  if (kVec && r + kRows <= r1) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(v + r));
    x[0] = w.x; x[1] = w.y; x[2] = w.z; x[3] = w.w;
    return;
  }
#pragma unroll
  for (int u = 0; u < kRows; ++u) x[u] = r + u < r1 ? __ldg(v + r + u) : 0.0f;
}

template <typename BinT, bool kVec>
__global__ void __launch_bounds__(512)
    histogram_kernel(const BinT* __restrict__ binned,
                     const float* __restrict__ vals, int n, int F, int B,
                     int s0, int s1, int s2, int rows_per_chunk,
                     int feat_tile, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned int arena[];  // lo [ft, 3, B], then hi
  const int f0 = blockIdx.y * feat_tile;
  const int ft = min(feat_tile, F - f0);
  const int cells = ft * 3 * B;
  unsigned int* lo_ar = arena;
  unsigned int* hi_ar = arena + cells;
  for (int i = threadIdx.x; i < 2 * cells; i += blockDim.x) arena[i] = 0u;
  __syncthreads();
  const long long c0 = static_cast<long long>(blockIdx.x) * rows_per_chunk;
  const long long c1 = min(static_cast<long long>(n), c0 + rows_per_chunk);
  const int sc[3] = {s0, s1, s2};
  for (long long base = c0; base < c1;
       base += static_cast<long long>(kRows) * blockDim.x) {
    const long long r = base + static_cast<long long>(kRows) * threadIdx.x;
    long long q[kRows][3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float x[kRows];
      load_vals<kVec>(vals + static_cast<size_t>(c) * n, r, c1, x);
#pragma unroll
      for (int u = 0; u < kRows; ++u) q[u][c] = to_fixed(x[u], sc[c]);
    }
    bool live[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u)
      live[u] = (q[u][0] | q[u][1] | q[u][2]) != 0;  // masked rows add nothing
    for (int j = 0; j < ft; ++j) {
      int b[kRows];
      load_bins<BinT, kVec>(binned + static_cast<size_t>(f0 + j) * n, r, c1,
                            b);
      unsigned int* lo_f = lo_ar + j * 3 * B;
      unsigned int* hi_f = hi_ar + j * 3 * B;
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        // the one-hot drops out-of-range bins
        const int key = (live[u] && b[u] >= 0 && b[u] < B) ? b[u] : -1;
        if (key < 0) continue;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          if (q[u][c])
            add_fixed_split(lo_f + c * B + key, hi_f + c * B + key, q[u][c]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const unsigned long long v = join_fixed_split(hi_ar[i], lo_ar[i]);
    if (v == 0ull) continue;
    const int j = i / (3 * B);
    const int rem = i - j * 3 * B;
    const int c = rem / B;
    const int b = rem - c * B;
    atomicAdd(out + (static_cast<size_t>(c) * F + f0 + j) * B + b, v);
  }
}

// histogram_prepare raises the kernels' shared memory limit once a
// device before any launch, so that no launch sets an attribute (as in
// fused.cu); a launch beyond the prepared limit is refused.
constexpr int kMaxDevices = 64;
int g_smem_limit[kMaxDevices] = {0};

cudaError_t check_smem(size_t smem) {
  if (smem <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices ||
      smem > static_cast<size_t>(g_smem_limit[dev]))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

template <typename Kernel>
cudaError_t raise_smem(Kernel kernel, int* limit) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  const int dyn = kMaxSmem - static_cast<int>(a.sharedSizeBytes);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return err;
  if (dyn < *limit) *limit = dyn;
  return cudaSuccess;
}

template <typename BinT, bool kVec>
cudaError_t launch(dim3 grid, int threads, size_t smem, cudaStream_t s,
                   const void* binned, const float* v, int n, int F, int B,
                   int s0, int s1, int s2, int rows_per_chunk, int feat_tile,
                   unsigned long long* o) {
  auto kernel = histogram_kernel<BinT, kVec>;
  const cudaError_t err = check_smem(smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(static_cast<const BinT*>(binned), v, n,
                                     F, B, s0, s1, s2, rows_per_chunk,
                                     feat_tile, o);
  return cudaSuccess;
}

}  // namespace

// Raise every kernel's shared memory limit on the current device; call
// once a device before the first launch.  Idempotent.
extern "C" int histogram_prepare() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidValue;
  int limit = kMaxSmem;
  if ((err = raise_smem(histogram_kernel<uint8_t, true>, &limit)) ||
      (err = raise_smem(histogram_kernel<uint8_t, false>, &limit)) ||
      (err = raise_smem(histogram_kernel<int, true>, &limit)) ||
      (err = raise_smem(histogram_kernel<int, false>, &limit)))
    return err;
  g_smem_limit[dev] = limit;
  return 0;
}

// out [3, F, B] int64 must be zeroed by the caller; bin_bytes is 1 (uint8)
// or 4 (int32).
extern "C" int histogram_build(const void* binned, int bin_bytes,
                               const void* vals, int n, int F, int B, int s0,
                               int s1, int s2, void* out, int row_chunks,
                               int feat_tile, int threads, void* stream) {
  if (n <= 0 || F <= 0) return 0;
  if (B <= 0 || row_chunks <= 0 || feat_tile <= 0 || threads <= 0 ||
      threads > 512 || threads % 32 != 0)
    return cudaErrorInvalidValue;
  const int ft = feat_tile < F ? feat_tile : F;
  const size_t smem = static_cast<size_t>(ft) * 3 * B * 2 * sizeof(unsigned);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  // chunks start on a multiple of kRows rows, so vector loads stay aligned
  int rows_per_chunk = (n + row_chunks - 1) / row_chunks;
  rows_per_chunk = (rows_per_chunk + kRows - 1) / kRows * kRows;
  const dim3 grid((n + rows_per_chunk - 1) / rows_per_chunk,
                  (F + feat_tile - 1) / feat_tile);
  const bool vec = n % kRows == 0 &&
                   reinterpret_cast<uintptr_t>(binned) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vals) % 16 == 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  cudaError_t err;
  if (bin_bytes == 1)
    err = vec ? launch<uint8_t, true>(grid, threads, smem, s, binned, v, n, F,
                                      B, s0, s1, s2, rows_per_chunk,
                                      feat_tile, o)
              : launch<uint8_t, false>(grid, threads, smem, s, binned, v, n,
                                       F, B, s0, s1, s2, rows_per_chunk,
                                       feat_tile, o);
  else if (bin_bytes == 4)
    err = vec ? launch<int, true>(grid, threads, smem, s, binned, v, n, F, B,
                                  s0, s1, s2, rows_per_chunk, feat_tile, o)
              : launch<int, false>(grid, threads, smem, s, binned, v, n, F, B,
                                   s0, s1, s2, rows_per_chunk, feat_tile, o);
  else
    return cudaErrorInvalidValue;
  if (err != cudaSuccess) return err;
  return static_cast<int>(cudaGetLastError());
}
