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
// summed in int64 (shared then global atomics).  Integer adds are
// associative, so the result is the same bits in any order and equals the
// plain PyTorch version (ops/histogram.py histogram_plain, an int64
// index_add_) bit for bit.  Bins >= B are dropped, as the Pallas one-hot
// drops them.
//
// What bounds it on the H100.  The bound is bytes: F*n binned bytes, 12*n
// value bytes and the 24*F*B output bytes.  The kernel is held back by
// 64-bit shared atomics instead: one per (row, feature, channel), and a
// feature whose rows crowd into few bins (a bundle's most frequent bin)
// serialises them.  Every block also flushes its whole arena with global
// atomics (row chunks x F x 3 x B of them at most).  Zero values are
// skipped, as in fused.cu.
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

template <typename BinT>
__global__ void histogram_kernel(const BinT* __restrict__ binned,
                                 const float* __restrict__ vals, int n, int F,
                                 int B, int s0, int s1, int s2,
                                 int rows_per_chunk, int feat_tile,
                                 unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long arena[];  // [ft, 3, B]
  const int f0 = blockIdx.y * feat_tile;
  const int ft = min(feat_tile, F - f0);
  const int cells = ft * 3 * B;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) arena[i] = 0ull;
  __syncthreads();
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_chunk;
  const long long r1 = min(static_cast<long long>(n), r0 + rows_per_chunk);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const long long q0 = to_fixed(vals[r], s0);
    const long long q1 = to_fixed(vals[static_cast<size_t>(n) + r], s1);
    const long long q2 = to_fixed(vals[2 * static_cast<size_t>(n) + r], s2);
    if (!(q0 | q1 | q2)) continue;  // a masked-out row adds nothing
    for (int j = 0; j < ft; ++j) {
      const int b = static_cast<int>(
          binned[static_cast<size_t>(f0 + j) * n + r]);
      if (b < 0 || b >= B) continue;
      unsigned long long* cell = arena + static_cast<size_t>(j) * 3 * B + b;
      // two's complement: unsigned wrap-around adds signed values exactly
      if (q0) atomicAdd(cell, static_cast<unsigned long long>(q0));
      if (q1) atomicAdd(cell + B, static_cast<unsigned long long>(q1));
      if (q2) atomicAdd(cell + 2 * B, static_cast<unsigned long long>(q2));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const unsigned long long v = arena[i];
    if (v == 0ull) continue;
    const int j = i / (3 * B);
    const int rem = i - j * 3 * B;
    const int c = rem / B;
    const int b = rem - c * B;
    atomicAdd(out + (static_cast<size_t>(c) * F + f0 + j) * B + b, v);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

// out [3, F, B] int64 must be zeroed by the caller; bin_bytes is 1 (uint8)
// or 4 (int32).
extern "C" int histogram_build(const void* binned, int bin_bytes,
                               const void* vals, int n, int F, int B, int s0,
                               int s1, int s2, void* out, int row_chunks,
                               int feat_tile, int threads, void* stream) {
  if (n <= 0 || F <= 0) return 0;
  if (B <= 0 || row_chunks <= 0 || feat_tile <= 0 || threads <= 0 ||
      threads > 1024 || threads % 32 != 0)
    return cudaErrorInvalidValue;
  const int ft = feat_tile < F ? feat_tile : F;
  const size_t smem = static_cast<size_t>(ft) * 3 * B * sizeof(long long);
  const int rows_per_chunk = (n + row_chunks - 1) / row_chunks;
  const dim3 grid(row_chunks, (F + feat_tile - 1) / feat_tile);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(vals);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  cudaError_t err;
  if (bin_bytes == 1) {
    if ((err = allow_smem(histogram_kernel<uint8_t>, smem)) != cudaSuccess)
      return err;
    histogram_kernel<uint8_t><<<grid, threads, smem, s>>>(
        static_cast<const uint8_t*>(binned), v, n, F, B, s0, s1, s2,
        rows_per_chunk, feat_tile, o);
  } else if (bin_bytes == 4) {
    if ((err = allow_smem(histogram_kernel<int>, smem)) != cudaSuccess)
      return err;
    histogram_kernel<int><<<grid, threads, smem, s>>>(
        static_cast<const int*>(binned), v, n, F, B, s0, s1, s2,
        rows_per_chunk, feat_tile, o);
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
