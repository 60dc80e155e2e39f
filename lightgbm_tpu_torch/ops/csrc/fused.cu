// Histogram accumulate and sibling-derive + gain scan for Hopper (sm_90a).
//
// Replaces the Pallas megakernel lightgbm_tpu/ops/fused.py::_fused_call
// (pallas_call at fused.py:329, body _accumulate_tile + _derive_and_scan)
// and its two halves, fused_frontier_accumulate (fused.py:375) and
// fused_sibling_scan (fused.py:403, pallas_call at :512), in both of the
// Pallas kernel's modes: f32 values, and the int8/int32 mode of
// quantized-gradient training.  On the TPU one kernel carried the slot
// arena in VMEM from the last row tile into the scan; on Hopper blocks
// run in no order and nothing carries between them, so the function is
// two kernels launched back to back:
//
//   accumulate_kernel  binned [F, n] u8/i32, slot [n] i32, and either
//                        vals [3, n] f32 -> hist [K, 3, F, B] int64
//                                           (fixed point), or
//                        vals [2, n] int8 -> hist [K, 2, F, B] int32
//                                           (sums of quantized levels)
//   scan_kernel        hist (+ parent of the same layout and small_left
//                      [K] in parent mode) + child sums [3, NC] + meta [F]
//                      -> six [NC, F] per-feature-best tuples
//
// Exact integers in both modes.  f32 mode (fixed_point.cuh, shared with
// histogram.cu): channel c of a row's value block enters as
// llrint(ldexp((double)v, s_c)) with one power-of-two scale per channel
// and tree chosen by the caller, s_c = 62 - ceil(log2(max|v_c| * n + 1)):
// the scaling is exact in f64, any sum of n such values fits in int64,
// and the one rounding costs at most 2^-(s_c+1) per row (dyadic values
// convert exactly).  int8 mode: the values are already integer levels
// (grad in [-31, 31], hess in [0, 63] at most), summed as they are in
// int32, which holds n * 63 for n up to ~34 M rows (the wrapper refuses
// more).  Integer sums are associative, so the histograms, the sibling
// parent - small and the prefix sums over bins are the same bits in any
// order: no unordered f32 atomics, and the plain PyTorch versions
// (ops/histogram.py accumulate_plain, ops/split.py numeric_feature_scan
// and quant_count_hist) give the same bits by construction.
//
// The scan converts each int64 prefix p of channel c to f32 as
// (float)((double)p * m_c): m_c = 2^-s_c in f32 mode; in int8 mode the
// channels are (grad, hess, estimated count) with multipliers (g_scale,
// h_scale, 1), the count channel of bin b being rintf(f32(H_b) * cf),
// cf = cnt / max(f32(sum_b H_b), 1) over the block's own feature (any
// feature's bins partition the child's rows).  From there the gain
// formulas run in f32 with __fadd_rn/__fmul_rn/__fdiv_rn (and
// --fmad=false), in the order of numeric_feature_scan.
//
// What bounds it on the H100.  accumulate: atomic throughput, not bytes.
// A block owns one feature, a block of slots and a chunk of rows; its
// [slots, C, B] arena (int64 with 3 channels, or int32 with 2) lives in
// shared memory and takes one shared atomic per (row, channel) of its
// slots; hot bins (a feature whose rows crowd into few bins) serialise
// there.  Every block re-reads slot[] for its rows, so each row is read
// once per (feature, slot block): K / slots_per_block times more slot
// traffic than the bound, mostly from L2.  The arena is flushed with
// global atomics, which costs (row chunks) x F x K x C x B at most.  The
// int8 mode moves a third of the value bytes and does 32-bit atomics on
// two channels instead of 64-bit ones on three.  scan: one block per
// (child, feature), one thread per bin; a block-wide int64 scan (warp
// shuffles), in int8 mode one more block sum (the hess total), and two
// arg-max reductions; it is bound by launch and latency at these sizes
// (~7k blocks of 256 threads).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//        --fmad=false -shared -Xcompiler -fPIC.
// The entries allocate nothing, launch on the caller's stream, do not
// synchronise, and return cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "fixed_point.cuh"

namespace {

constexpr float kEps = 1e-15f;
constexpr float kTwoEps = 2e-15f;
constexpr int kMissingNone = 0;
constexpr int kMissingZero = 1;
constexpr int kMissingNaN = 2;
constexpr int kDefaultSmem = 48 * 1024;

// the value types of the two modes: channels, the arena's accumulator
// (two's complement, so unsigned wrap-around adds signed values exactly)
// and a row's integer value of channel c
template <typename ValT>
struct ValTraits;

template <>
struct ValTraits<float> {
  static constexpr int kChannels = 3;
  using Acc = unsigned long long;  // int64 fixed point
  __device__ static long long level(float v, int s) { return to_fixed(v, s); }
};

template <>
struct ValTraits<int8_t> {
  static constexpr int kChannels = 2;
  using Acc = unsigned int;  // int32 sums of quantized levels
  __device__ static int level(int8_t v, int) { return v; }
};

template <typename BinT, typename ValT>
__global__ void accumulate_kernel(const BinT* __restrict__ binned,
                                  const ValT* __restrict__ vals,
                                  const int* __restrict__ slot, int n, int F,
                                  int K, int B, int s0, int s1, int s2,
                                  int rows_per_chunk, int slots_per_block,
                                  typename ValTraits<ValT>::Acc* __restrict__ out) {
  using Acc = typename ValTraits<ValT>::Acc;
  constexpr int C = ValTraits<ValT>::kChannels;
  extern __shared__ __align__(8) unsigned char smem[];
  Acc* arena = reinterpret_cast<Acc*>(smem);  // [slots, C, B]
  const int f = blockIdx.y;
  const int k0 = blockIdx.z * slots_per_block;
  const int ns = min(slots_per_block, K - k0);
  const int cells = ns * C * B;
  for (int i = threadIdx.x; i < cells; i += blockDim.x) arena[i] = 0;
  __syncthreads();
  const int sc[3] = {s0, s1, s2};
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_chunk;
  const long long r1 = min(static_cast<long long>(n), r0 + rows_per_chunk);
  const BinT* col = binned + static_cast<size_t>(f) * n;
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int s = slot[r] - k0;
    if (s < 0 || s >= ns) continue;
    const int b = static_cast<int>(col[r]);
    if (b < 0 || b >= B) continue;  // the one-hot drops out-of-range bins
    Acc* cell = arena + static_cast<size_t>(s) * C * B + b;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const auto q = ValTraits<ValT>::level(
          vals[static_cast<size_t>(c) * n + r], sc[c]);
      if (q) atomicAdd(cell + c * B, static_cast<Acc>(q));
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += blockDim.x) {
    const Acc v = arena[i];
    if (v == 0) continue;
    const int s = i / (C * B);
    const int rem = i - s * C * B;
    const int c = rem / B;
    const int b = rem - c * B;
    atomicAdd(out + ((static_cast<size_t>(k0 + s) * C + c) * F + f) * B + b,
              v);
  }
}

// inclusive int64 scan over the block (blockDim a multiple of 32)
__device__ long long block_scan(long long v, long long* warp_tot) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_tot[wid] = v;
  __syncthreads();
  if (wid == 0) {
    const int nw = blockDim.x >> 5;
    long long t = lane < nw ? warp_tot[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += y;
    }
    if (lane < nw) warp_tot[lane] = t;
  }
  __syncthreads();
  if (wid > 0) v += warp_tot[wid - 1];
  __syncthreads();  // warp_tot is reused by the next scan
  return v;
}

// the sum over the block, in every thread
__device__ long long block_sum(long long v, long long* warp_tot,
                               long long* total) {
  const long long inc = block_scan(v, warp_tot);
  if (threadIdx.x == blockDim.x - 1) *total = inc;
  __syncthreads();
  const long long r = *total;
  __syncthreads();
  return r;
}

struct Arg {
  float v;
  int i;
  int ok;  // 0 for padding threads: they never win
};

// kLast: ties go to the larger index (the reverse scan's "last max");
// otherwise to the smaller (jnp.argmax / torch.argmax)
template <bool kLast>
__device__ __forceinline__ bool better(const Arg& a, const Arg& b) {
  if (!a.ok) return false;
  if (!b.ok) return true;
  if (a.v > b.v) return true;
  if (a.v < b.v) return false;
  return kLast ? a.i > b.i : a.i < b.i;
}

template <bool kLast>
__device__ Arg block_argmax(Arg a, Arg* sh) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    Arg b;
    b.v = __shfl_down_sync(0xffffffffu, a.v, o);
    b.i = __shfl_down_sync(0xffffffffu, a.i, o);
    b.ok = __shfl_down_sync(0xffffffffu, a.ok, o);
    if (better<kLast>(b, a)) a = b;
  }
  if (lane == 0) sh[wid] = a;
  __syncthreads();
  if (wid == 0) {
    const int nw = blockDim.x >> 5;
    a = lane < nw ? sh[lane] : Arg{-INFINITY, 0, 0};
    for (int o = 16; o > 0; o >>= 1) {
      Arg b;
      b.v = __shfl_down_sync(0xffffffffu, a.v, o);
      b.i = __shfl_down_sync(0xffffffffu, a.i, o);
      b.ok = __shfl_down_sync(0xffffffffu, a.ok, o);
      if (better<kLast>(b, a)) a = b;
    }
    if (lane == 0) sh[0] = a;
  }
  __syncthreads();
  const Arg r = sh[0];
  __syncthreads();
  return r;
}

struct Hyper {
  int use_l1;
  float l1, l2, min_gain, min_data, min_hess;
};

__device__ __forceinline__ float leaf_gain(float g, float h, const Hyper& hp) {
  float sg = g;
  if (hp.use_l1) {
    const float sign = (g > 0.0f) ? 1.0f : ((g < 0.0f) ? -1.0f : 0.0f);
    float m = __fsub_rn(fabsf(g), hp.l1);
    m = m > 0.0f ? m : 0.0f;
    sg = __fmul_rn(sign, m);
  }
  return __fdiv_rn(__fmul_rn(sg, sg), __fadd_rn(h, hp.l2));
}

struct DirResult {
  float gain, lg, lh, lc;
};

__device__ __forceinline__ DirResult eval_dir(float lg, float lh, float lc,
                                              float sg, float total_h,
                                              float cnt, float mgs,
                                              const Hyper& hp) {
  const float rg = __fsub_rn(sg, lg);
  const float rh = __fsub_rn(total_h, lh);
  const float rc = __fsub_rn(cnt, lc);
  const bool ok = lc >= hp.min_data && rc >= hp.min_data &&
                  lh >= hp.min_hess && rh >= hp.min_hess;
  const float gain = __fadd_rn(leaf_gain(lg, lh, hp), leaf_gain(rg, rh, hp));
  return {(ok && gain > mgs) ? gain : -INFINITY, lg, lh, lc};
}

// one block per (child c, feature f), one thread per bin.  kQuant: the
// histograms hold int32 (grad, hess) levels and the count channel is
// estimated here; otherwise int64 (grad, hess, count) fixed point
template <bool kQuant>
__global__ void scan_kernel(const void* __restrict__ small_v,
                            const void* __restrict__ parent_v,
                            const int* __restrict__ small_left,
                            const float* __restrict__ sums,
                            const int* __restrict__ num_bin,
                            const int* __restrict__ missing_type,
                            const int* __restrict__ default_bin, int K, int F,
                            int B, int NC, double m0, double m1, double m2,
                            Hyper hp, float* __restrict__ out_gain,
                            int* __restrict__ out_thr,
                            int* __restrict__ out_dl,
                            float* __restrict__ out_lg,
                            float* __restrict__ out_lh,
                            float* __restrict__ out_lc) {
  using HistT = std::conditional_t<kQuant, int, long long>;
  constexpr int C = kQuant ? 2 : 3;  // stored channels
  const HistT* small = static_cast<const HistT*>(small_v);
  const HistT* parent = static_cast<const HistT*>(parent_v);
  __shared__ long long warp_tot[32];
  __shared__ long long miss_sh[3];
  __shared__ long long total_sh;
  __shared__ Arg arg_sh[32];
  const int c = blockIdx.x;
  const int f = blockIdx.y;
  const int t = threadIdx.x;
  const bool in = t < B;
  const int nb = num_bin[f];
  const int mt = missing_type[f];
  const bool has_md = mt != kMissingNone && nb > 2;
  int miss_bin = mt == kMissingNaN ? nb - 1
                                   : (mt == kMissingZero ? default_bin[f] : -1);
  if (!has_md) miss_bin = -1;
  const bool is_miss = t == miss_bin;
  const bool valid = t < nb;

  // the child's histogram cell: leaf mode reads it; parent mode derives
  // h_left = small_left ? small : parent - small, h_right = parent - h_left
  const bool pmode = parent != nullptr;
  const int k = (pmode && c >= K) ? c - K : c;
  long long v[3] = {0, 0, 0};
  for (int ch = 0; ch < C; ++ch) {
    long long x = 0;
    if (in) {
      const size_t idx = ((static_cast<size_t>(k) * C + ch) * F + f) * B + t;
      x = small[idx];
      if (pmode) {
        const long long p = parent[idx];
        const long long hl = small_left[k] ? x : p - x;
        x = c < K ? hl : p - hl;
      }
    }
    v[ch] = x;
  }
  const float sg = sums[c];
  const float sh = sums[NC + c];
  const float cnt = sums[2 * NC + c];
  if constexpr (kQuant) {
    // estimated counts (reference feature_histogram.hpp:813, in f32):
    // C_b = round_half_even(f32(H_b) * cnt / max(f32(sum_b H_b), 1))
    const long long tot = block_sum(v[1], warp_tot, &total_sh);
    const float cf = __fdiv_rn(cnt, fmaxf(__ll2float_rn(tot), 1.0f));
    v[2] = in ? static_cast<long long>(
                    rintf(__fmul_rn(__ll2float_rn(v[1]), cf)))
              : 0;
  }
  if (t < 3) miss_sh[t] = 0;
  __syncthreads();
  if (in && is_miss)
    for (int ch = 0; ch < 3; ++ch) miss_sh[ch] = v[ch];
  const bool keep = in && valid && !is_miss;
  long long pre[3];
  for (int ch = 0; ch < 3; ++ch) pre[ch] = block_scan(keep ? v[ch] : 0, warp_tot);

  const double mult[3] = {m0, m1, m2};
  float pf[3], ms[3];
  for (int ch = 0; ch < 3; ++ch) {
    pf[ch] = fixed_to_f32(pre[ch], mult[ch]);
    ms[ch] = fixed_to_f32(miss_sh[ch], mult[ch]);
  }

  const float total_h = __fadd_rn(sh, kTwoEps);
  const float mgs = __fadd_rn(leaf_gain(sg, total_h, hp), hp.min_gain);

  const DirResult dr = eval_dir(pf[0], __fadd_rn(pf[1], kEps), pf[2], sg,
                                total_h, cnt, mgs, hp);
  const DirResult dl = eval_dir(
      __fadd_rn(pf[0], ms[0]), __fadd_rn(__fadd_rn(pf[1], ms[1]), kEps),
      __fadd_rn(pf[2], ms[2]), sg, total_h, cnt, mgs, hp);

  const int na_dir = (has_md && mt == kMissingNaN) ? 1 : 0;
  const bool t_valid = t < nb - 1 - na_dir && valid &&
                       !(mt == kMissingZero && is_miss);
  const float g_r = (t_valid && has_md) ? dr.gain : -INFINITY;
  const float g_l = t_valid ? dl.gain : -INFINITY;

  const Arg best_l = block_argmax<true>(Arg{g_l, t, in ? 1 : 0}, arg_sh);
  const Arg best_r = block_argmax<false>(Arg{g_r, t, in ? 1 : 0}, arg_sh);
  const bool use_left = best_l.v >= best_r.v;
  const int tsel = use_left ? best_l.i : best_r.i;
  if (t == tsel) {
    const size_t o = static_cast<size_t>(c) * F + f;
    const float ng = use_left ? best_l.v : best_r.v;
    out_gain[o] = isfinite(ng) ? __fsub_rn(ng, mgs) : -INFINITY;
    out_thr[o] = tsel;
    out_dl[o] = has_md ? (use_left ? 1 : 0) : (mt != kMissingNaN ? 1 : 0);
    const DirResult& d = use_left ? dl : dr;
    out_lg[o] = d.lg;
    out_lh[o] = __fsub_rn(d.lh, kEps);
    out_lc[o] = d.lc;
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

// out must be zeroed by the caller; bin_bytes is 1 (uint8) or 4 (int32);
// val_bytes 4 takes vals [3, n] f32 and writes int64 [K, 3, F, B] at the
// scales s0-s2, val_bytes 1 takes vals [2, n] int8 and writes int32
// [K, 2, F, B].
extern "C" int fused_accumulate(const void* binned, int bin_bytes,
                                const void* vals, int val_bytes,
                                const void* slot, int n, int F, int K, int B,
                                int s0, int s1, int s2, void* out,
                                int row_chunks, int slots_per_block,
                                int threads, void* stream) {
  if (n <= 0 || K <= 0 || F <= 0) return 0;
  if (B <= 0 || row_chunks <= 0 || slots_per_block <= 0 || threads <= 0 ||
      threads > 1024 || threads % 32 != 0)
    return cudaErrorInvalidValue;
  const int ns = slots_per_block < K ? slots_per_block : K;
  const int rows_per_chunk = (n + row_chunks - 1) / row_chunks;
  const dim3 grid(row_chunks, F, (K + slots_per_block - 1) / slots_per_block);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(slot);
  cudaError_t err;
#define LAUNCH(BinT, ValT)                                                    \
  do {                                                                        \
    using Acc = ValTraits<ValT>::Acc;                                         \
    const size_t smem = static_cast<size_t>(ns) *                             \
                        ValTraits<ValT>::kChannels * B * sizeof(Acc);         \
    if ((err = allow_smem(accumulate_kernel<BinT, ValT>, smem)) !=            \
        cudaSuccess)                                                          \
      return err;                                                             \
    accumulate_kernel<BinT, ValT><<<grid, threads, smem, st>>>(               \
        static_cast<const BinT*>(binned), static_cast<const ValT*>(vals), sl, \
        n, F, K, B, s0, s1, s2, rows_per_chunk, slots_per_block,              \
        static_cast<Acc*>(out));                                              \
  } while (0)
  if (bin_bytes == 1 && val_bytes == 4) {
    LAUNCH(uint8_t, float);
  } else if (bin_bytes == 4 && val_bytes == 4) {
    LAUNCH(int, float);
  } else if (bin_bytes == 1 && val_bytes == 1) {
    LAUNCH(uint8_t, int8_t);
  } else if (bin_bytes == 4 && val_bytes == 1) {
    LAUNCH(int, int8_t);
  } else {
    return cudaErrorInvalidValue;
  }
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// parent == nullptr selects leaf mode (NC == K); otherwise parent mode
// (NC == 2K: children [left 0..K-1, right K..2K-1]).  sums is [3, NC].
// quant == 0: small/parent int64 [K, 3, F, B]; quant == 1: int32
// [K, 2, F, B] levels.  m0-m2 are the channel multipliers (2^-s_c, or
// g_scale, h_scale, 1).
extern "C" int fused_scan(const void* small, const void* parent,
                          const void* small_left, const void* sums,
                          const void* num_bin, const void* missing_type,
                          const void* default_bin, int K, int F, int B,
                          int NC, int quant, double m0, double m1, double m2,
                          int use_l1, float l1, float l2, float min_gain,
                          float min_data, float min_hess, void* gain,
                          void* thr, void* dl, void* lg, void* lh, void* lc,
                          void* stream) {
  if (NC <= 0 || F <= 0) return 0;
  if (B <= 0 || B > 1024) return cudaErrorInvalidValue;
  if (parent != nullptr && (small_left == nullptr || NC != 2 * K))
    return cudaErrorInvalidValue;
  if (parent == nullptr && NC != K) return cudaErrorInvalidValue;
  const int threads = (B + 31) / 32 * 32;
  const Hyper hp{use_l1, l1, l2, min_gain, min_data, min_hess};
  const dim3 grid(NC, F);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARGS                                                                \
  small, parent, static_cast<const int*>(small_left),                       \
      static_cast<const float*>(sums), static_cast<const int*>(num_bin),    \
      static_cast<const int*>(missing_type),                                \
      static_cast<const int*>(default_bin), K, F, B, NC, m0, m1, m2, hp,    \
      static_cast<float*>(gain), static_cast<int*>(thr),                    \
      static_cast<int*>(dl), static_cast<float*>(lg),                       \
      static_cast<float*>(lh), static_cast<float*>(lc)
  if (quant)
    scan_kernel<true><<<grid, threads, 0, st>>>(ARGS);
  else
    scan_kernel<false><<<grid, threads, 0, st>>>(ARGS);
#undef ARGS
  return static_cast<int>(cudaGetLastError());
}
