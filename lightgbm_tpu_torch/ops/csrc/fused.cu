// Histogram accumulate and sibling-derive + gain scan for Hopper (sm_90a).
//
// Replaces the Pallas megakernel lightgbm_tpu/ops/fused.py::_fused_call
// (pallas_call at fused.py:329, body _accumulate_tile + _derive_and_scan)
// and its two halves, fused_frontier_accumulate (fused.py:375) and
// fused_sibling_scan (fused.py:403, pallas_call at :512), in both of the
// Pallas kernel's modes: f32 values, and the int8/int32 mode of
// quantized-gradient training.  On the TPU one kernel carried the slot
// arena in VMEM from the last row tile into the scan; on Hopper blocks
// run in no order and nothing carries between them, so the function is a
// sort, an accumulate and a scan launched back to back:
//
//   slot_count_kernel,   slot [n] i32 -> order [n] (the rows by slot,
//   slot_scan_kernel,      stable), offsets [K + 1], and the slotted
//   slot_scatter_kernel    rows' values in sorted order: int64 fixed
//                          point [n, 3] or int8 levels [n, 2]
//   accumulate_kernel    binned [F, n] u8/i32 + the sorted rows
//                          -> hist [K, 3, F, B] int64 (fixed point),
//                             or [K, 2, F, B] int32 (sums of levels)
//   scan_kernel          hist (+ parent of the same layout and small_left
//                        [K] in parent mode) + child sums [3, NC] + meta [F]
//                        -> six [NC, F] per-feature-best tuples
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
// What bounds it on the H100.  The accumulate's byte bound is the binned
// matrix once plus the values, the slots and the output (~0.02 ms at 1 M
// rows x 28 features).  A first design gave each block a block of 16
// slots and a chunk of ALL rows and skipped the rows of other slots: the
// cost grew as n * F * ceil(K / 16) whatever the slotted rows m, each
// row's slot was read 224 times a launch, the f32 arena took 64-bit
// shared atomics (a compare-and-swap loop on sm_90) and the fixed-point
// conversion ran once per (row, feature, channel).  So B4 now runs in
// two steps (four launches on one stream, no host sync):
//
// 1. A stable counting sort of the rows by slot (K + 1 <= 129 keys at the
//    grower's widths; one radix pass): per-block key counts (a block of
//    32 warps holds 8,192 rows, each warp loads its 256 keys at once),
//    one block's exclusive scan over (key, block), and a stable scatter
//    that also writes each slotted row's values once in sorted order,
//    converted once per (row, channel).  It moves the slots twice, the
//    values once and the order and sorted values once: bytes, ~20 MB at
//    1 M rows.
// 2. The accumulate walks the sorted list: a block owns a segment of at
//    most seg_rows rows of ONE slot and a tile of features, keeps that
//    slot's [ft, C, B] arena in shared memory (B6's layout), gathers each
//    row's bins, and flushes once.  Work grows with m, not n * K / 16,
//    each slot is read once, and a segment that is a whole slot stores
//    its cells without atomics.  What bounds it now is the shared-atomic
//    rate and hot bins (rows that crowd into few bins serialise), and
//    the bin gather: rows of a slot are sparse in [0, n), so each
//    gathered byte is a 32-byte sector, from L2 where the binned matrix
//    fits (28 MB at 1 M x 28).  The f32 mode splits each int64 value
//    into hi/lo 32-bit halves with an exact carry (accumulate_kernel),
//    so every shared atomic is a native 32-bit ATOMS.ADD; the int8 mode
//    adds its levels into int32 on two channels.  Zero values add
//    nothing and are skipped.
//
// scan: one block per (child, feature), one thread per bin; a block-wide
// int64 scan (warp shuffles), in int8 mode one more block sum (the hess
// total), and two arg-max reductions; it is bound by launch and latency
// at these sizes (~7k blocks of 256 threads).  Three optional inputs, a
// null pointer each where the mode is off, give the scan the other
// modes of numeric_feature_scan: mono [F] int32 (monotone constraints:
// the gain from each side's leaf output, clamped and tested against the
// feature's direction, reference feature_histogram.hpp:714-747), bounds
// [2, NC] f32 (each child's output clamp, rows lo and hi) and rand_thr
// [NC, F] int32 (extra trees, leaf mode: the one threshold a (child,
// feature) may take).
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

// the value types of the two modes: channels, a row's integer value of
// channel c as the sort stores it (Q), and the flushed sum's type
template <typename ValT>
struct ValTraits;

template <>
struct ValTraits<float> {
  static constexpr int kChannels = 3;
  using Q = long long;             // int64 fixed point
  using Out = unsigned long long;  // two's complement int64 sums
  __device__ static Q level(float v, int s) { return to_fixed(v, s); }
};

template <>
struct ValTraits<int8_t> {
  static constexpr int kChannels = 2;
  using Q = int8_t;           // the quantized level as it is
  using Out = unsigned int;   // two's complement int32 sums
  __device__ static Q level(int8_t v, int) { return v; }
};

// ---------------------------------------------------------------------
// B4, step 1: a stable counting sort of the rows by slot
// ---------------------------------------------------------------------

// A sort block owns kSortWarps * kWarpRows consecutive rows; each warp
// loads its kWarpRows keys at once (kSteps loads in flight), then walks
// them 32 at a time in row order.
constexpr int kSortWarps = 32;
constexpr int kWarpRows = 256;
constexpr int kSteps = kWarpRows / 32;
constexpr int kSortBlockRows = kSortWarps * kWarpRows;

// a row's sort key: its slot, or K for a dropped row
__device__ __forceinline__ int slot_key(int s, int K) {
  return (s >= 0 && s < K) ? s : K;
}

// this warp's keys (-1 past n) and its per-key counts in cnt [K + 1];
// __match_any_sync groups the lanes of equal keys, so each step adds one
// count per key
__device__ __forceinline__ void warp_keys(const int* __restrict__ slot,
                                          int n, int K, int r0, int lane,
                                          int (&keys)[kSteps], int* cnt) {
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int r = r0 + 32 * u + lane;
    keys[u] = r < n ? slot_key(slot[r], K) : -1;
  }
  for (int k = lane; k <= K; k += 32) cnt[k] = 0;
  __syncwarp();
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const unsigned peers = __match_any_sync(0xffffffffu, keys[u]);
    if (keys[u] >= 0 && lane == __ffs(peers) - 1) cnt[keys[u]] += __popc(peers);
    __syncwarp();
  }
}

// counts[key * nblk + blk] = rows of sort block blk with that key
__global__ void slot_count_kernel(const int* __restrict__ slot, int n, int K,
                                  int nblk, int* __restrict__ counts) {
  extern __shared__ int cnt_sh[];  // [kSortWarps, K + 1]
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int keys[kSteps];
  warp_keys(slot, n, K, blockIdx.x * kSortBlockRows + w * kWarpRows, lane,
            keys, cnt_sh + w * (K + 1));
  __syncthreads();
  for (int k = threadIdx.x; k <= K; k += blockDim.x) {
    int t = 0;
    for (int v = 0; v < kSortWarps; ++v) t += cnt_sh[v * (K + 1) + k];
    counts[static_cast<size_t>(k) * nblk + blockIdx.x] = t;
  }
}

// exclusive scan of a[0, len) in place by the whole block (blockDim a
// multiple of 32): each thread scans a run of ceil(len / blockDim)
// entries; returns the total
__device__ int block_exclusive_scan(int* a, int len, int* warp_sh) {
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wid = t >> 5;
  const int per = (len + T - 1) / T;
  const int b = min(len, t * per);
  const int e = min(len, b + per);
  int s = 0;
#pragma unroll 8
  for (int i = b; i < e; ++i) s += a[i];
  int v = s;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) warp_sh[wid] = v;
  __syncthreads();
  if (wid == 0) {
    const int nw = T >> 5;
    int x = lane < nw ? warp_sh[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    if (lane < nw) warp_sh[lane] = x;
  }
  __syncthreads();
  int run = v - s + (wid > 0 ? warp_sh[wid - 1] : 0);
  const int total = warp_sh[(T >> 5) - 1];
  for (int i = b; i < e; ++i) {
    const int x = a[i];
    a[i] = run;
    run += x;
  }
  __syncthreads();  // a[] and warp_sh are read again by the caller
  return total;
}

// one block: counts -> exclusive prefixes over (key, sort block), so
// counts[key * nblk + blk] is the first sorted position of that block's
// rows with that key; offsets[k] = counts[k * nblk] (k <= K: offsets[K]
// is the number of slotted rows); seg_start[k] = the first accumulate
// segment of slot k, each slot cut into ceil(m_k / acc_rows) segments
// (seg_start[K] = their total)
__global__ void slot_scan_kernel(int* __restrict__ counts, int nblk, int K,
                                 int acc_rows, int* __restrict__ offsets,
                                 int* __restrict__ seg_start) {
  __shared__ int warp_sh[32];
  block_exclusive_scan(counts, (K + 1) * nblk, warp_sh);
  for (int k = threadIdx.x; k <= K; k += blockDim.x)
    offsets[k] = counts[static_cast<size_t>(k) * nblk];
  __syncthreads();
  for (int k = threadIdx.x; k <= K; k += blockDim.x)
    seg_start[k] =
        k < K ? (offsets[k + 1] - offsets[k] + acc_rows - 1) / acc_rows : 0;
  __syncthreads();
  block_exclusive_scan(seg_start, K + 1, warp_sh);
}

// order[pos] = row, stable: each warp counts its keys again, the block
// turns the block's prefix of each key into per-warp prefixes (earlier
// warps hold earlier rows), and each warp walks its rows in order; a
// lane's rank among the equal keys of its step is the popcount of the
// lower peers.  The slotted rows' values land in sorted order too,
// converted once per (row, channel): sv[pos * C + c] (int64 fixed
// point, or the int8 level; a row's channels side by side, one scattered
// write a row).
template <typename ValT>
__global__ void slot_scatter_kernel(const int* __restrict__ slot, int n, int K,
                                    int nblk, const int* __restrict__ counts,
                                    const ValT* __restrict__ vals, int s0,
                                    int s1, int s2,
                                    typename ValTraits<ValT>::Q* __restrict__ sv,
                                    int* __restrict__ order) {
  constexpr int C = ValTraits<ValT>::kChannels;
  extern __shared__ int pos_sh[];  // [kSortWarps, K + 1]
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int r0 = blockIdx.x * kSortBlockRows + w * kWarpRows;
  int keys[kSteps];
  int* next = pos_sh + w * (K + 1);
  warp_keys(slot, n, K, r0, lane, keys, next);
  __syncthreads();
  for (int k = threadIdx.x; k <= K; k += blockDim.x) {
    int run = counts[static_cast<size_t>(k) * nblk + blockIdx.x];
    for (int v = 0; v < kSortWarps; ++v) {
      const int c = pos_sh[v * (K + 1) + k];
      pos_sh[v * (K + 1) + k] = run;
      run += c;
    }
  }
  __syncthreads();
  const int sc[3] = {s0, s1, s2};
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int r = r0 + 32 * u + lane;
    const int key = keys[u];
    const unsigned peers = __match_any_sync(0xffffffffu, key);
    if (key >= 0) {
      const int pos = next[key] + __popc(peers & below);
      order[pos] = r;
      if (key < K) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          sv[static_cast<size_t>(pos) * C + c] = ValTraits<ValT>::level(
              vals[static_cast<size_t>(c) * n + r], sc[c]);
      }
    }
    __syncwarp();
    if (key >= 0 && lane == __ffs(peers) - 1) next[key] += __popc(peers);
    __syncwarp();
  }
}

// ---------------------------------------------------------------------
// B4, step 2: accumulate over the sorted rows
// ---------------------------------------------------------------------

// One block per (segment of one slot's sorted rows, feature tile): it
// keeps the slot's [ft, C, B] arena in shared memory, gathers each row's
// bins binned[f, order[i]] (row ids ascend within a slot, so the gather
// walks forward), and flushes the arena into out[k] once: plain stores
// when the segment is the whole slot (no other block writes those cells),
// global atomics on the non-zero cells otherwise.  Blocks past the
// device-side segment total exit.
//
// f32 mode: no 64-bit shared atomics.  A row's int64 value q splits
// exactly as q = hi * 2^32 + lo (hi = q >> 32 arithmetic, lo = q &
// 0xffffffff); lo adds into a uint32 arena with atomicAdd, whose return
// value tells whether this add wrapped (old + lo < old), and hi + carry
// adds into a second uint32 arena.  Then hi_acc * 2^32 + lo_acc == sum q
// (mod 2^64), the int64 arithmetic of the sums themselves, so the
// recombined value is exact whenever the int64 sum is.  Nor does the hi
// arena wrap at the grower's scales: fixed_point_scales gives |q| <=
// 2^62 / n, so |hi + carry| <= 2^30 / n + 2 per row and a block's sum over
// at most n rows stays within 2^30 + 2n < 2^31 (n < 2^29).
template <typename BinT, typename ValT>
__global__ void accumulate_kernel(
    const BinT* __restrict__ binned, int n, int F, int K, int B,
    const int* __restrict__ order,
    const typename ValTraits<ValT>::Q* __restrict__ sv,
    const int* __restrict__ offsets, const int* __restrict__ seg_start,
    int seg_rows, int feat_tile, typename ValTraits<ValT>::Out* __restrict__ out) {
  using Q = typename ValTraits<ValT>::Q;
  using Out = typename ValTraits<ValT>::Out;
  constexpr int C = ValTraits<ValT>::kChannels;
  constexpr bool kSplit = std::is_same<ValT, float>::value;
  extern __shared__ unsigned int arena[];  // lo [ft, C, B] (+ hi [ft, C, B])
  const int seg = blockIdx.x;
  if (seg >= seg_start[K]) return;
  // the slot of this segment: the last k with seg_start[k] <= seg (a slot
  // with no rows has no segment)
  int lo_k = 0, hi_k = K - 1;
  while (lo_k < hi_k) {
    const int mid = (lo_k + hi_k + 1) >> 1;
    if (seg_start[mid] <= seg) lo_k = mid;
    else hi_k = mid - 1;
  }
  const int k = lo_k;
  const int p0 = offsets[k] + (seg - seg_start[k]) * seg_rows;
  const int p1 = min(offsets[k + 1], p0 + seg_rows);
  const bool whole = seg_start[k + 1] - seg_start[k] == 1;
  const int f0 = blockIdx.y * feat_tile;
  const int ft = min(feat_tile, F - f0);
  const int cells = ft * C * B;
  unsigned int* lo_ar = arena;
  unsigned int* hi_ar = arena + cells;
  for (int i = threadIdx.x; i < (kSplit ? 2 : 1) * cells; i += blockDim.x)
    arena[i] = 0u;
  __syncthreads();
  const BinT* col = binned + static_cast<size_t>(f0) * n;
  for (int i = p0 + threadIdx.x; i < p1; i += blockDim.x) {
    const int r = order[i];
    Q q[C];
#pragma unroll
    for (int c = 0; c < C; ++c) q[c] = sv[static_cast<size_t>(i) * C + c];
    for (int j0 = 0; j0 < ft; j0 += 4) {
      int bb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        bb[u] = j0 + u < ft
                    ? static_cast<int>(col[static_cast<size_t>(j0 + u) * n + r])
                    : -1;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int b = bb[u];
        if (b < 0 || b >= B) continue;  // the one-hot drops out-of-range bins
        const int cell = (j0 + u) * C * B + b;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if constexpr (kSplit) {
            const unsigned int lo = static_cast<unsigned int>(q[c]);
            unsigned int hi = static_cast<unsigned int>(q[c] >> 32);
            if (lo) {
              const unsigned int old = atomicAdd(lo_ar + cell + c * B, lo);
              hi += (old + lo < old) ? 1u : 0u;
            }
            if (hi) atomicAdd(hi_ar + cell + c * B, hi);
          } else {
            if (q[c]) atomicAdd(lo_ar + cell + c * B,
                                static_cast<unsigned int>(static_cast<int>(q[c])));
          }
        }
      }
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < cells; x += blockDim.x) {
    Out v;
    if constexpr (kSplit)
      v = (static_cast<unsigned long long>(hi_ar[x]) << 32) + lo_ar[x];
    else
      v = lo_ar[x];
    const int j = x / (C * B);
    const int rem = x - j * C * B;
    const int c = rem / B;
    const int b = rem - c * B;
    Out* dst = out + ((static_cast<size_t>(k) * C + c) * F + f0 + j) * B + b;
    if (whole) *dst = v;
    else if (v) atomicAdd(dst, v);
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
  float l1, l2, min_gain, min_data, min_hess, max_delta_step;
};

// reference: ThresholdL1 (feature_histogram.hpp:661)
__device__ __forceinline__ float threshold_l1(float g, const Hyper& hp) {
  if (!hp.use_l1) return g;
  const float sign = (g > 0.0f) ? 1.0f : ((g < 0.0f) ? -1.0f : 0.0f);
  float m = __fsub_rn(fabsf(g), hp.l1);
  m = m > 0.0f ? m : 0.0f;
  return __fmul_rn(sign, m);
}

__device__ __forceinline__ float leaf_gain(float g, float h, const Hyper& hp) {
  const float sg = threshold_l1(g, hp);
  return __fdiv_rn(__fmul_rn(sg, sg), __fadd_rn(h, hp.l2));
}

// jnp.clip(x, lo, hi) = minimum(hi, maximum(lo, x)), NaN kept
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  x = x < lo ? lo : x;
  return x > hi ? hi : x;
}

// reference: CalculateSplittedLeafOutput (feature_histogram.hpp:669)
__device__ __forceinline__ float leaf_output(float g, float h,
                                             const Hyper& hp) {
  const float out = __fdiv_rn(-threshold_l1(g, hp), __fadd_rn(h, hp.l2));
  if (hp.max_delta_step > 0.0f)
    return clip(out, -hp.max_delta_step, hp.max_delta_step);
  return out;
}

// reference: GetLeafGainGivenOutput (feature_histogram.hpp:760),
// -(2 sg out + (h + l2) out out) in that order
__device__ __forceinline__ float leaf_gain_given_output(float g, float h,
                                                        float out,
                                                        const Hyper& hp) {
  const float sg = threshold_l1(g, hp);
  const float a = __fmul_rn(__fmul_rn(2.0f, sg), out);
  const float b = __fmul_rn(__fmul_rn(__fadd_rn(h, hp.l2), out), out);
  return -__fadd_rn(a, b);
}

struct DirResult {
  float gain, lg, lh, lc;
};

// mc: the feature's monotone constraint, or kNoMono where the mode is off;
// lo_b/hi_b the child's output bounds (-inf/+inf where none are given)
constexpr int kNoMono = 2;

__device__ __forceinline__ DirResult eval_dir(float lg, float lh, float lc,
                                              float sg, float total_h,
                                              float cnt, float mgs, int mc,
                                              float lo_b, float hi_b,
                                              bool has_bounds,
                                              const Hyper& hp) {
  const float rg = __fsub_rn(sg, lg);
  const float rh = __fsub_rn(total_h, lh);
  const float rc = __fsub_rn(cnt, lc);
  const bool ok = lc >= hp.min_data && rc >= hp.min_data &&
                  lh >= hp.min_hess && rh >= hp.min_hess;
  float gain;
  if (mc == kNoMono) {
    gain = __fadd_rn(leaf_gain(lg, lh, hp), leaf_gain(rg, rh, hp));
  } else {
    float lo = leaf_output(lg, lh, hp);
    float ro = leaf_output(rg, rh, hp);
    if (has_bounds) {
      lo = clip(lo, lo_b, hi_b);
      ro = clip(ro, lo_b, hi_b);
    }
    const bool bad = (mc > 0 && lo > ro) || (mc < 0 && lo < ro);
    gain = __fadd_rn(leaf_gain_given_output(lg, lh, lo, hp),
                     leaf_gain_given_output(rg, rh, ro, hp));
    if (bad) gain = -INFINITY;
  }
  return {(ok && gain > mgs) ? gain : -INFINITY, lg, lh, lc};
}

// one block per (child c, feature f), one thread per bin.  kQuant: the
// histograms hold int32 (grad, hess) levels and the count channel is
// estimated here; otherwise int64 (grad, hess, count) fixed point.
// kModes: any of mono, bounds, rand_thr may be given (each null where
// off); without it the plain scan is compiled alone, the code of the
// plain launches before those inputs existed
template <bool kQuant, bool kModes>
__global__ void scan_kernel(const void* __restrict__ small_v,
                            const void* __restrict__ parent_v,
                            const int* __restrict__ small_left,
                            const float* __restrict__ sums,
                            const int* __restrict__ num_bin,
                            const int* __restrict__ missing_type,
                            const int* __restrict__ default_bin,
                            const int* __restrict__ mono,
                            const float* __restrict__ bounds,
                            const int* __restrict__ rand_thr, int K, int F,
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

  const int mc = kModes && mono != nullptr ? mono[f] : kNoMono;
  const bool has_bounds = kModes && bounds != nullptr;
  const float lo_b = has_bounds ? bounds[c] : -INFINITY;
  const float hi_b = has_bounds ? bounds[NC + c] : INFINITY;
  const DirResult dr = eval_dir(pf[0], __fadd_rn(pf[1], kEps), pf[2], sg,
                                total_h, cnt, mgs, mc, lo_b, hi_b,
                                has_bounds, hp);
  const DirResult dl = eval_dir(
      __fadd_rn(pf[0], ms[0]), __fadd_rn(__fadd_rn(pf[1], ms[1]), kEps),
      __fadd_rn(pf[2], ms[2]), sg, total_h, cnt, mgs, mc, lo_b, hi_b,
      has_bounds, hp);

  const int na_dir = (has_md && mt == kMissingNaN) ? 1 : 0;
  const bool t_valid =
      t < nb - 1 - na_dir && valid && !(mt == kMissingZero && is_miss) &&
      (!kModes || rand_thr == nullptr ||
       t == rand_thr[static_cast<size_t>(c) * F + f]);
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

// B4, step 1: order [n] (slotted rows by slot, ascending row id within a
// slot, dropped rows last), offsets [K + 1] and seg_start [K + 1] (the
// accumulate's segments of acc_rows sorted rows); nblk is the number of
// sort blocks, ceil(n / 8192) (8192 rows a block; any other value is
// refused), and counts int32 scratch of (K + 1) * nblk entries.
// val_bytes 4 takes vals [3, n] f32 and writes sv [n, 3] int64 at the
// scales s0-s2, val_bytes 1 takes vals [2, n] int8 and writes sv [n, 2]
// int8, each slotted row's values at its sorted position.
extern "C" int fused_slot_order(const void* slot, int n, int K, int nblk,
                                const void* vals, int val_bytes, int s0,
                                int s1, int s2, int acc_rows, void* counts,
                                void* order, void* offsets, void* seg_start,
                                void* sv, void* stream) {
  if (n <= 0 || K <= 0) return 0;
  if (acc_rows <= 0 || vals == nullptr || sv == nullptr ||
      nblk != (n + kSortBlockRows - 1) / kSortBlockRows ||
      static_cast<long long>(K + 1) * nblk > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kSortWarps) * (K + 1) * sizeof(int);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(slot);
  int* cn = static_cast<int*>(counts);
  cudaError_t err;
  if ((err = allow_smem(slot_count_kernel, smem)) != cudaSuccess) return err;
  slot_count_kernel<<<nblk, kSortWarps * 32, smem, st>>>(sl, n, K, nblk, cn);
  slot_scan_kernel<<<1, 1024, 0, st>>>(cn, nblk, K, acc_rows,
                                       static_cast<int*>(offsets),
                                       static_cast<int*>(seg_start));
#define SCATTER(ValT)                                                       \
  do {                                                                      \
    if ((err = allow_smem(slot_scatter_kernel<ValT>, smem)) != cudaSuccess) \
      return err;                                                           \
    slot_scatter_kernel<ValT><<<nblk, kSortWarps * 32, smem, st>>>(         \
        sl, n, K, nblk, cn, static_cast<const ValT*>(vals), s0, s1, s2,     \
        static_cast<ValTraits<ValT>::Q*>(sv), static_cast<int*>(order));    \
  } while (0)
  if (val_bytes == 4) {
    SCATTER(float);
  } else if (val_bytes == 1) {
    SCATTER(int8_t);
  } else {
    return cudaErrorInvalidValue;
  }
#undef SCATTER
  return static_cast<int>(cudaGetLastError());
}

// B4, step 2: out must be zeroed by the caller; bin_bytes is 1 (uint8) or
// 4 (int32); val_bytes 4 takes sv [n, 3] int64 and writes int64 [K, 3, F,
// B], val_bytes 1 takes sv [n, 2] int8 and writes int32 [K, 2, F, B].
// The grid's x axis is segs (ops/planner.py acc_segments), which must
// cover any slot layout, ceil(n / seg_rows) + K, so it holds the
// device-side total seg_start[K].
extern "C" int fused_accumulate(const void* binned, int bin_bytes,
                                int val_bytes, const void* order,
                                const void* sv, const void* offsets,
                                const void* seg_start, int n, int F, int K,
                                int B, int seg_rows, int segs, int feat_tile,
                                int threads, void* out, void* stream) {
  if (n <= 0 || K <= 0 || F <= 0) return 0;
  if (B <= 0 || seg_rows <= 0 || feat_tile <= 0 || threads <= 0 ||
      threads > 1024 || threads % 32 != 0 ||
      segs < (static_cast<long long>(n) + seg_rows - 1) / seg_rows + K)
    return cudaErrorInvalidValue;
  const int ft = feat_tile < F ? feat_tile : F;
  const dim3 grid(static_cast<unsigned>(segs), (F + feat_tile - 1) / feat_tile);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* od = static_cast<const int*>(order);
  const int* off = static_cast<const int*>(offsets);
  const int* ss = static_cast<const int*>(seg_start);
  cudaError_t err;
#define LAUNCH(BinT, ValT)                                                    \
  do {                                                                        \
    using Tr = ValTraits<ValT>;                                               \
    const size_t smem = static_cast<size_t>(ft) * Tr::kChannels * B *         \
                        sizeof(unsigned int) *                                \
                        (std::is_same<ValT, float>::value ? 2 : 1);           \
    if ((err = allow_smem(accumulate_kernel<BinT, ValT>, smem)) !=            \
        cudaSuccess)                                                          \
      return err;                                                             \
    accumulate_kernel<BinT, ValT><<<grid, threads, smem, st>>>(               \
        static_cast<const BinT*>(binned), n, F, K, B, od,                     \
        static_cast<const Tr::Q*>(sv), off, ss, seg_rows, feat_tile,          \
        static_cast<Tr::Out*>(out));                                          \
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
// g_scale, h_scale, 1).  mono [F] int32, bounds [2, NC] f32 and rand_thr
// [NC, F] int32 (leaf mode only) may each be null: the mode is off.
extern "C" int fused_scan(const void* small, const void* parent,
                          const void* small_left, const void* sums,
                          const void* num_bin, const void* missing_type,
                          const void* default_bin, const void* mono,
                          const void* bounds, const void* rand_thr, int K,
                          int F, int B, int NC, int quant, double m0,
                          double m1, double m2, int use_l1, float l1,
                          float l2, float min_gain, float min_data,
                          float min_hess, float max_delta_step, void* gain,
                          void* thr, void* dl, void* lg, void* lh, void* lc,
                          void* stream) {
  if (NC <= 0 || F <= 0) return 0;
  if (B <= 0 || B > 1024) return cudaErrorInvalidValue;
  if (parent != nullptr && (small_left == nullptr || NC != 2 * K ||
                            rand_thr != nullptr))
    return cudaErrorInvalidValue;
  if (parent == nullptr && NC != K) return cudaErrorInvalidValue;
  const int threads = (B + 31) / 32 * 32;
  const Hyper hp{use_l1, l1, l2, min_gain, min_data, min_hess,
                 max_delta_step};
  const dim3 grid(NC, F);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ARGS                                                                \
  small, parent, static_cast<const int*>(small_left),                       \
      static_cast<const float*>(sums), static_cast<const int*>(num_bin),    \
      static_cast<const int*>(missing_type),                                \
      static_cast<const int*>(default_bin), static_cast<const int*>(mono),  \
      static_cast<const float*>(bounds), static_cast<const int*>(rand_thr), \
      K, F, B, NC, m0, m1, m2, hp,                                          \
      static_cast<float*>(gain), static_cast<int*>(thr),                    \
      static_cast<int*>(dl), static_cast<float*>(lg),                       \
      static_cast<float*>(lh), static_cast<float*>(lc)
  const bool modes = mono != nullptr || bounds != nullptr ||
                     rand_thr != nullptr;
  if (quant && modes)
    scan_kernel<true, true><<<grid, threads, 0, st>>>(ARGS);
  else if (quant)
    scan_kernel<true, false><<<grid, threads, 0, st>>>(ARGS);
  else if (modes)
    scan_kernel<false, true><<<grid, threads, 0, st>>>(ARGS);
  else
    scan_kernel<false, false><<<grid, threads, 0, st>>>(ARGS);
#undef ARGS
  return static_cast<int>(cudaGetLastError());
}
