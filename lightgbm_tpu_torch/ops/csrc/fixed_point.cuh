// Exact fixed-point arithmetic shared by the histogram kernels
// (histogram.cu, fused.cu), so every kernel quantizes a value and reads a
// sum back the same way as the plain PyTorch versions
// (ops/histogram.py to_fixed, ops/split.py fixed_to_f32).
//
// Channel c of a row's value block enters as llrint(ldexp((double)v, s_c))
// with one power-of-two scale per channel and tree chosen by the caller,
// s_c = 62 - ceil(log2(max|v_c| * n + 1)): the scaling is exact in f64,
// any sum of n such values fits in int64, and the one rounding (to
// nearest, ties to even) costs at most 2^-(s_c+1) per row.  A sum converts
// back as (float)((double)p * m_c) with the channel's multiplier m_c:
// 2^-s_c here, and (g_scale, h_scale, 1) for the integer levels of
// quantized training (fused.cu).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

__device__ __forceinline__ long long to_fixed(float v, int s) {
  return llrint(ldexp(static_cast<double>(v), s));
}

__device__ __forceinline__ float fixed_to_f32(long long p, double mult) {
  return __double2float_rn(__dmul_rn(__ll2double_rn(p), mult));
}

// Adds the int64 fixed-point value q into a cell kept in shared memory as
// two uint32 halves, with 32-bit atomics only (a 64-bit shared atomicAdd
// compiles to the compare-and-swap loop ATOMS.CAST.SPIN.64).  q splits
// exactly as q = hi * 2^32 + lo (hi = q >> 32 arithmetic, lo = q &
// 0xffffffff); lo adds into the lo half, whose old value tells whether
// this add wrapped (old + lo < old), and hi + carry adds into the hi half.
// Then hi_acc * 2^32 + lo_acc == sum q (mod 2^64), the int64 arithmetic of
// the sums themselves, so join_fixed_split gives the exact int64 sum
// whenever the sum fits int64 (the callers' scales make every sum fit).
__device__ __forceinline__ void add_fixed_split(unsigned int* lo_cell,
                                                unsigned int* hi_cell,
                                                long long q) {
  const unsigned int lo = static_cast<unsigned int>(q);
  unsigned int hi = static_cast<unsigned int>(q >> 32);
  if (lo) {
    const unsigned int old = atomicAdd(lo_cell, lo);
    hi += (old + lo < old) ? 1u : 0u;
  }
  if (hi) atomicAdd(hi_cell, hi);
}

__device__ __forceinline__ unsigned long long join_fixed_split(
    unsigned int hi, unsigned int lo) {
  return (static_cast<unsigned long long>(hi) << 32) + lo;
}
