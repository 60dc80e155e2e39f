// Exact fixed-point conversions shared by the histogram kernels
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
