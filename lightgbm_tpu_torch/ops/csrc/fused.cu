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
//                        [K] in parent mode), or in leaf mode the staged
//                        arm's group histograms [NC, C, G, Bg] with
//                        feat_group/feat_start [F], + child sums [3, NC] +
//                        meta [F] -> six [NC, F] per-feature-best tuples
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
// scan: a warp per task, kScanWarps tasks of one child a block
// (ops/planner.py scan_plan).  A feature of more than 32 bins is a task
// of its own whose lanes walk its bins in 32-bin chunks, to num_bin and
// never to B, carrying the prefix; narrower features share a task, one
// lane per bin, each a segment of the warp.  Prefixes are segmented
// warp-shuffle scans (int64, or int32 for the int8 levels), each lane
// keeps its own best threshold of each direction over its bins, and one
// segmented warp reduction per direction picks the feature's: no block
// barrier.  The int8 mode first sums the feature's hess row for the
// count estimate.  In leaf mode on the staged arm the kernel reads the
// group histograms themselves: bin b >= 1 of feature f is merged bin
// feat_start[f] + b - 1 of column feat_group[f], bin 0 the child's total
// (group 0's bins, summed once a block) minus the feature's other bins,
// the expansion the grower made before in int64 [NC, C, F, B].  Its byte
// bound counts the cells walked (a 2-bin one-hot column is one lane);
// on the H100 it runs at 2-8x that bound, held by the walk's per-chunk
// work (three int64 segmented scans, the gain's f64 conversions and
// IEEE divisions), not by the loads or the shuffles alone: staging the
// cells with cp.async, prefetching them to L2, and runs of several bins
// a lane through shared memory (a tenth of the shuffles) all measured
// slower (PERF.md).
// Three optional inputs, a null pointer each where the mode is off, give
// the scan the other modes of numeric_feature_scan: mono [F] int32
// (monotone constraints: the gain from each side's leaf output, clamped
// and tested against the feature's direction, reference
// feature_histogram.hpp:714-747), bounds [2, NC] f32 (each child's output
// clamp, rows lo and hi) and rand_thr [NC, F] int32 (extra trees, leaf
// mode: the one threshold a (child, feature) may take).
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
                                    const ValT* __restrict__ vals,
                                    const int* __restrict__ exps,
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
  // the fixed-point exponents from the device (none in the int8 mode)
  int sc[3] = {0, 0, 0};
  if (exps != nullptr) {
#pragma unroll
    for (int c = 0; c < 3; ++c) sc[c] = exps[c];
  }
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
// f32 mode: no 64-bit shared atomics.  A row's int64 value adds into two
// uint32 arenas, the lo and hi halves, with the exact carry
// (fixed_point.cuh add_fixed_split); the flush joins them.  Nor does the
// hi arena wrap at the grower's scales: fixed_point_scales gives |q| <=
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
            add_fixed_split(lo_ar + cell + c * B, hi_ar + cell + c * B, q[c]);
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
      v = join_fixed_split(hi_ar[x], lo_ar[x]);
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

// ---------------------------------------------------------------------
// B5: the gain scan, a warp per task (ops/planner.py scan_plan)
// ---------------------------------------------------------------------

constexpr unsigned kFull = 0xffffffffu;
// warp tasks of one scan block (ops/planner.py SCAN_WARPS)
constexpr int kScanWarps = 4;

// inclusive scan within each lane's segment: lanes [seg, lane] of the warp
template <typename T>
__device__ __forceinline__ T seg_scan(T v, int lane, int seg) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(kFull, v, o);
    if (lane - o >= seg) v += y;
  }
  return v;
}

// the sum over the warp, in every lane
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

struct Arg {
  float v;
  int i;
  int ok;  // 0 for a lane with no candidate: it never wins
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

// the best candidate of each segment [seg, seg_end), in its first lane:
// each lane combines with the lane o above it while that lane is in the
// segment (a suffix reduction, so a segment may start at any lane; the
// order is total, so overlapping ranges give the same result)
template <bool kLast>
__device__ __forceinline__ Arg seg_argmax(Arg a, int lane, int seg_end) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    Arg b;
    b.v = __shfl_down_sync(kFull, a.v, o);
    b.i = __shfl_down_sync(kFull, a.i, o);
    b.ok = __shfl_down_sync(kFull, a.ok, o);
    if (lane + o < seg_end && better<kLast>(b, a)) a = b;
  }
  return a;
}

// A lane's best threshold so far in one direction, with the left sums
// it would output
struct Best {
  Arg a;
  float lg, lh, lc;
};

// B5.  A block runs kScanWarps warp tasks of one child c; a task is one
// feature of more than 32 walked bins (its lanes walk the bins in 32-bin
// chunks, carrying the prefix) or a run of narrower features packed into
// the warp's lanes, one lane per bin (ops/planner.py scan_plan; plan
// holds each lane's f << 5 | first lane of f, -1 for an idle lane).
// Every prefix is a segmented warp-shuffle scan and every arg-max a
// segmented warp reduction: no block barrier, and no lane past
// min(num_bin, B).  kQuant: int32 (grad, hess) level cells, the count
// channel estimated here; otherwise int64 (grad, hess, count) fixed
// point.  kModes: any of mono, bounds, rand_thr may be given (each null
// where off); without it the plain scan is compiled alone.  kGrouped
// (leaf mode): small is the staged arm's group histograms [NC, C, G, Bg];
// bin b >= 1 of feature f is merged bin feat_start[f] + b - 1 of column
// feat_group[f], and bin 0 is the child's total (group 0's bins, summed
// once a block) minus the feature's other bins.
template <bool kQuant, bool kModes, bool kGrouped>
__global__ void __launch_bounds__(kScanWarps * 32)
    scan_kernel(const void* __restrict__ small_v,
                const void* __restrict__ parent_v,
                const int* __restrict__ small_left,
                const int* __restrict__ feat_group,
                const int* __restrict__ feat_start,
                const int* __restrict__ plan, int tasks,
                const float* __restrict__ sums,
                const int* __restrict__ num_bin,
                const int* __restrict__ missing_type,
                const int* __restrict__ default_bin,
                const int* __restrict__ mono,
                const float* __restrict__ bounds,
                const int* __restrict__ rand_thr, int K, int F, int B, int G,
                int Bg, int NC, const void* __restrict__ scales, Hyper hp,
                float* __restrict__ out_gain, int* __restrict__ out_thr,
                int* __restrict__ out_dl, float* __restrict__ out_lg,
                float* __restrict__ out_lh, float* __restrict__ out_lc) {
  // int32 levels (their sums and prefixes fit: the wrapper caps the rows)
  // or int64 fixed point
  using HistT = std::conditional_t<kQuant, int, long long>;
  constexpr int C = kQuant ? 2 : 3;  // stored channels
  const HistT* small = static_cast<const HistT*>(small_v);
  const HistT* parent = static_cast<const HistT*>(parent_v);
  const int nblk = (tasks + kScanWarps - 1) / kScanWarps;
  const int c = blockIdx.x / nblk;
  const int task = (blockIdx.x - c * nblk) * kScanWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;

  __shared__ HistT tot_sh[3];
  if constexpr (kGrouped) {
    // the child's totals: every group column holds one bin per row
    for (int ch = threadIdx.x >> 5; ch < C; ch += kScanWarps) {
      const HistT* row = small + (static_cast<size_t>(c) * C + ch) * G * Bg;
      HistT s = 0;
      for (int b = lane; b < Bg; b += 32) s += row[b];
      s = warp_sum(s);
      if (lane == 0) tot_sh[ch] = s;
    }
    __syncthreads();
  }
  if (task >= tasks) return;  // warp-uniform

  const int e = plan[task * 32 + lane];
  const bool mine = e >= 0;
  // an idle lane takes lane 0's feature and a segment of its own
  const int f = (mine ? e : plan[task * 32]) >> 5;
  const int seg = mine ? (e & 31) : lane;
  const int nb = num_bin[f];
  const int nbw = max(min(nb, B), 1);  // bins walked (bin 0 at least)
  const bool wide = nbw > 32;
  const int seg_end = mine ? (wide ? 32 : seg + nbw) : lane + 1;
  const int chunks = wide ? (nbw + 31) / 32 : 1;  // uniform over the task
  const int mt = missing_type[f];
  const bool has_md = mt != kMissingNone && nb > 2;
  int miss_bin = mt == kMissingNaN ? nb - 1
                                   : (mt == kMissingZero ? default_bin[f] : -1);
  if (!has_md) miss_bin = -1;
  const bool pmode = parent != nullptr;
  const int k = (pmode && c >= K) ? c - K : c;
  int fg = 0, fs = 0;
  if constexpr (kGrouped) {
    fg = feat_group[f];
    fs = feat_start[f];
  }

  // bin b of feature ff of the child, channel ch, from the [K, C, F, B]
  // layout (parent mode: h_left = small_left ? small : parent - small,
  // h_right = parent - h_left); 0 outside [0, B)
  auto cell = [&](int ff, int ch, int b) -> HistT {
    if (b < 0 || b >= B) return 0;
    const size_t idx = ((static_cast<size_t>(k) * C + ch) * F + ff) * B + b;
    HistT x = small[idx];
    if (pmode) {
      const HistT p = parent[idx];
      const HistT hl = small_left[k] ? x : p - x;
      x = c < K ? hl : p - hl;
    }
    return x;
  };
  // bin b of this lane's feature from the group histograms, bins 1..nb-1
  auto gcell = [&](int ch, int b) -> HistT {
    if (b < 1 || b >= nb || b >= B) return 0;
    return small[((static_cast<size_t>(c) * C + ch) * G + fg) * Bg + fs + b -
                 1];
  };

  // first pass.  Grouped: the feature's bins 1..nb-1 (bin 0 is the total
  // minus them).  Quantized: the feature's hess total for the count
  // estimate (grouped: the child's total, as the rebuilt bin 0 makes it;
  // otherwise the sum over all B bins of the feature's row)
  HistT rest[C];
#pragma unroll
  for (int ch = 0; ch < C; ++ch) rest[ch] = 0;
  long long htot = 0;
  if constexpr (kGrouped) {
    for (int kc = 0; kc < chunks; ++kc) {
      const int b = kc * 32 + lane - seg;
      if (mine && b < nbw) {
#pragma unroll
        for (int ch = 0; ch < C; ++ch) rest[ch] += gcell(ch, b);
      }
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      rest[ch] = __shfl_sync(kFull, seg_scan(rest[ch], lane, seg), seg_end - 1);
    if constexpr (kQuant) htot = tot_sh[1];
  } else if constexpr (kQuant) {
    unsigned starts = __ballot_sync(kFull, mine && lane == seg);
    while (starts) {
      const int s = __ffs(starts) - 1;
      starts &= starts - 1;
      const int fe = __shfl_sync(kFull, f, s);
      long long part = 0;
      for (int b = lane; b < B; b += 32) part += cell(fe, 1, b);
      part = warp_sum(part);
      if (seg == s) htot = part;
    }
  }
  // the child's bin b of this lane's feature, stored channel ch (the
  // missing bin's cell; the walk reads its chunks itself)
  auto value = [&](int ch, int b) -> HistT {
    if constexpr (kGrouped)
      return b == 0 ? tot_sh[ch] - rest[ch] : gcell(ch, b);
    else
      return cell(f, ch, b);
  };

  const float sg = sums[c];
  const float sh = sums[NC + c];
  const float cnt = sums[2 * NC + c];
  // estimated counts (reference feature_histogram.hpp:813, in f32):
  // C_b = round_half_even(f32(H_b) * cnt / max(f32(sum_b H_b), 1))
  float cf = 0.0f;
  if constexpr (kQuant) cf = __fdiv_rn(cnt, fmaxf(__ll2float_rn(htot), 1.0f));
  auto count = [&](HistT h) -> HistT {
    return static_cast<HistT>(
        rintf(__fmul_rn(__ll2float_rn(static_cast<long long>(h)), cf)));
  };

  // the missing bin's cell, read before the walk
  HistT mv[3] = {0, 0, 0};
  if (mine && miss_bin >= 0 && miss_bin < B) {
#pragma unroll
    for (int ch = 0; ch < C; ++ch) mv[ch] = value(ch, miss_bin);
    if constexpr (kQuant) mv[2] = count(mv[1]);
  }
  // the channel multipliers, read from the device: 2^-s_c from the
  // int32 exponents, or (g_scale, h_scale, 1) from the f64 scales
  double mult[3];
  if constexpr (kQuant) {
    const double* q = static_cast<const double*>(scales);
    mult[0] = q[0];
    mult[1] = q[1];
    mult[2] = 1.0;
  } else {
    // 2^-s_c built from its bits (exact; |s_c| < 1022 at any scale
    // fixed_point_scales gives), no ldexp call
    const int* e = static_cast<const int*>(scales);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      mult[ch] = __longlong_as_double(static_cast<long long>(1023 - e[ch])
                                      << 52);
  }
  float ms[3];
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) ms[ch] = fixed_to_f32(mv[ch], mult[ch]);

  const float total_h = __fadd_rn(sh, kTwoEps);
  const float mgs = __fadd_rn(leaf_gain(sg, total_h, hp), hp.min_gain);
  const int mc = kModes && mono != nullptr ? mono[f] : kNoMono;
  const bool has_bounds = kModes && bounds != nullptr;
  const float lo_b = has_bounds ? bounds[c] : -INFINITY;
  const float hi_b = has_bounds ? bounds[NC + c] : INFINITY;
  const bool use_rt = kModes && rand_thr != nullptr;
  const int rt = use_rt ? rand_thr[static_cast<size_t>(c) * F + f] : -1;
  const int na_dir = (has_md && mt == kMissingNaN) ? 1 : 0;

  // the walk: each lane keeps its own best of each direction (the reverse
  // scan's last maximum, the forward scan's first) over its bins.  Only a
  // finite gain is a candidate: where every threshold of a direction is
  // -inf, the reverse scan's pick is bin B - 1 (below) and the forward
  // scan's is never output, so neither needs the lane that held it.  A
  // chunk's cells are loaded while the one before is scanned.
  HistT carry[3] = {0, 0, 0};
  Best bl{{-INFINITY, 0, 0}, 0.0f, 0.0f, 0.0f};
  Best br = bl;
  for (int kc = 0; kc < chunks; ++kc) {
    const int b = kc * 32 + lane - seg;
    const bool inb = mine && b < nbw;
    const bool keep = inb && b < nb && b != miss_bin;
    HistT x[3] = {0, 0, 0};
    if (keep) {
#pragma unroll
      for (int ch = 0; ch < C; ++ch) {
        if constexpr (kGrouped) {
          x[ch] = b == 0 ? tot_sh[ch] - rest[ch] : gcell(ch, b);
        } else {
          const size_t idx =
              ((static_cast<size_t>(k) * C + ch) * F + f) * B + b;
          x[ch] = small[idx];
          if (pmode) {
            const HistT q = parent[idx];
            const HistT hl = small_left[k] ? x[ch] : q - x[ch];
            x[ch] = c < K ? hl : q - hl;
          }
        }
      }
      if constexpr (kQuant) x[2] = count(x[1]);
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      x[ch] = seg_scan(x[ch], lane, seg) + carry[ch];
      carry[ch] = __shfl_sync(kFull, x[ch], seg_end - 1);
    }
    const bool t_valid = inb && b < nb - 1 - na_dir &&
                         !(mt == kMissingZero && b == miss_bin) &&
                         (!use_rt || b == rt);
    if (t_valid) {
      float pf[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) pf[ch] = fixed_to_f32(x[ch], mult[ch]);
      const DirResult dl = eval_dir(
          __fadd_rn(pf[0], ms[0]), __fadd_rn(__fadd_rn(pf[1], ms[1]), kEps),
          __fadd_rn(pf[2], ms[2]), sg, total_h, cnt, mgs, mc, lo_b, hi_b,
          has_bounds, hp);
      if (dl.gain > -INFINITY && (!bl.a.ok || dl.gain >= bl.a.v))
        bl = Best{{dl.gain, b, 1}, dl.lg, dl.lh, dl.lc};
      if (has_md) {
        const DirResult dr = eval_dir(pf[0], __fadd_rn(pf[1], kEps), pf[2],
                                      sg, total_h, cnt, mgs, mc, lo_b, hi_b,
                                      has_bounds, hp);
        if (dr.gain > -INFINITY && (!br.a.ok || dr.gain > br.a.v))
          br = Best{{dr.gain, b, 1}, dr.lg, dr.lh, dr.lc};
      }
    }
  }

  const Arg best_l = seg_argmax<true>(bl.a, lane, seg_end);
  const Arg best_r = seg_argmax<false>(br.a, lane, seg_end);
  const float lv = __shfl_sync(kFull, best_l.v, seg);
  const int li = __shfl_sync(kFull, best_l.i, seg);
  const float rv = __shfl_sync(kFull, best_r.v, seg);
  const int ri = __shfl_sync(kFull, best_r.i, seg);
  const bool use_left = lv >= rv;
  // no valid threshold either way: the reverse scan's last maximum over
  // all B bins is bin B - 1, whose prefix is the walk's total (bins from
  // min(num_bin, B) on are never kept)
  const bool none = use_left && lv == -INFINITY;
  const int tsel = none ? B - 1 : (use_left ? li : ri);
  const Arg own = use_left ? bl.a : br.a;
  if (mine && (none ? lane == seg : (own.ok && own.i == tsel))) {
    const size_t o = static_cast<size_t>(c) * F + f;
    const float ng = use_left ? lv : rv;
    out_gain[o] = isfinite(ng) ? __fsub_rn(ng, mgs) : -INFINITY;
    out_thr[o] = tsel;
    out_dl[o] = has_md ? (use_left ? 1 : 0) : (mt != kMissingNaN ? 1 : 0);
    if (none) {
      float pf[3];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) pf[ch] = fixed_to_f32(carry[ch], mult[ch]);
      out_lg[o] = __fadd_rn(pf[0], ms[0]);
      out_lh[o] = __fsub_rn(__fadd_rn(__fadd_rn(pf[1], ms[1]), kEps), kEps);
      out_lc[o] = __fadd_rn(pf[2], ms[2]);
    } else {
      out_lg[o] = use_left ? bl.lg : br.lg;
      out_lh[o] = __fsub_rn(use_left ? bl.lh : br.lh, kEps);
      out_lc[o] = use_left ? bl.lc : br.lc;
    }
  }
}

// The dynamic shared memory a launch of this file may take beyond the
// default 48 KiB: fused_prepare raises every kernel's limit to the
// card's opt-in maximum once a device, before any launch, so that no
// launch sets an attribute (a launch captured into a CUDA graph must
// not); a launch asking for more than the prepared limit is refused.
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
cudaError_t raise_smem(Kernel kernel, int optin, int* limit) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  const int dyn = optin - static_cast<int>(a.sharedSizeBytes);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return err;
  if (dyn < *limit) *limit = dyn;
  return cudaSuccess;
}

}  // namespace

// Raise the shared memory limit of every kernel that takes more than
// 48 KiB on the current device; call once a device before the first
// launch (and so before any graph capture).  Idempotent.
extern "C" int fused_prepare() {
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidValue;
  err = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  int limit = optin;
#define RAISE(K)                                                \
  do {                                                          \
    if ((err = raise_smem(K, optin, &limit)) != cudaSuccess)    \
      return err;                                               \
  } while (0)
  RAISE(slot_count_kernel);
  RAISE(slot_scatter_kernel<float>);
  RAISE(slot_scatter_kernel<int8_t>);
  RAISE((accumulate_kernel<uint8_t, float>));
  RAISE((accumulate_kernel<int, float>));
  RAISE((accumulate_kernel<uint8_t, int8_t>));
  RAISE((accumulate_kernel<int, int8_t>));
#undef RAISE
  g_smem_limit[dev] = limit;
  return 0;
}

// B4, step 1: order [n] (slotted rows by slot, ascending row id within a
// slot, dropped rows last), offsets [K + 1] and seg_start [K + 1] (the
// accumulate's segments of acc_rows sorted rows); nblk is the number of
// sort blocks, ceil(n / 8192) (8192 rows a block; any other value is
// refused), and counts int32 scratch of (K + 1) * nblk entries.
// val_bytes 4 takes vals [3, n] f32 and writes sv [n, 3] int64 at the
// scales s0-s2, val_bytes 1 takes vals [2, n] int8 and writes sv [n, 2]
// int8, each slotted row's values at its sorted position.  exps is the
// f32 mode's exponents s0-s2, int32 [3] on the device (read by the
// kernel, so one captured launch serves every tree's scales); null in
// the int8 mode.
extern "C" int fused_slot_order(const void* slot, int n, int K, int nblk,
                                const void* vals, int val_bytes,
                                const void* exps, int acc_rows, void* counts,
                                void* order, void* offsets, void* seg_start,
                                void* sv, void* stream) {
  if (n <= 0 || K <= 0) return 0;
  if (acc_rows <= 0 || vals == nullptr || sv == nullptr ||
      (val_bytes == 4 && exps == nullptr) ||
      nblk != (n + kSortBlockRows - 1) / kSortBlockRows ||
      static_cast<long long>(K + 1) * nblk > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(kSortWarps) * (K + 1) * sizeof(int);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* sl = static_cast<const int*>(slot);
  int* cn = static_cast<int*>(counts);
  cudaError_t err;
  if ((err = check_smem(smem)) != cudaSuccess) return err;
  slot_count_kernel<<<nblk, kSortWarps * 32, smem, st>>>(sl, n, K, nblk, cn);
  slot_scan_kernel<<<1, 1024, 0, st>>>(cn, nblk, K, acc_rows,
                                       static_cast<int*>(offsets),
                                       static_cast<int*>(seg_start));
#define SCATTER(ValT)                                                       \
  do {                                                                      \
    slot_scatter_kernel<ValT><<<nblk, kSortWarps * 32, smem, st>>>(         \
        sl, n, K, nblk, cn, static_cast<const ValT*>(vals),                 \
        static_cast<const int*>(exps),                                      \
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
    if ((err = check_smem(smem)) != cudaSuccess) return err;                  \
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

// B5.  parent == nullptr selects leaf mode (NC == K); otherwise parent
// mode (NC == 2K: children [left 0..K-1, right K..2K-1]).  sums is [3, NC].
// quant == 0: int64 cells, quant == 1: int32 levels.  small (and parent)
// [K, C, F, B]; or, with feat_group and feat_start [F] int32 (leaf mode
// only), the group histograms [NC, C, G, Bg].  plan: tasks x 32 lane
// entries (ops/planner.py scan_plan for num_bin and B).  scales, on the
// device, gives the channel multipliers: the exponents s_c, int32 [3]
// (2^-s_c), or with quant the f64 [2] (g_scale, h_scale) (and 1 for the
// count); the kernel reads them, so one captured launch serves every
// tree's scales.  mono [F] int32,
// bounds [2, NC] f32 and rand_thr [NC, F] int32 (leaf mode only) may each
// be null: the mode is off.
extern "C" int fused_scan(const void* small, const void* parent,
                          const void* small_left, const void* feat_group,
                          const void* feat_start, const void* plan, int tasks,
                          const void* sums, const void* num_bin,
                          const void* missing_type, const void* default_bin,
                          const void* mono, const void* bounds,
                          const void* rand_thr, int K, int F, int B, int G,
                          int Bg, int NC, int quant, const void* scales,
                          int use_l1, float l1, float l2,
                          float min_gain, float min_data, float min_hess,
                          float max_delta_step, void* gain, void* thr,
                          void* dl, void* lg, void* lh, void* lc,
                          void* stream) {
  if (NC <= 0 || F <= 0) return 0;
  if (B <= 0 || tasks <= 0 || plan == nullptr || scales == nullptr)
    return cudaErrorInvalidValue;
  const bool grouped = feat_group != nullptr;
  if (grouped && (feat_start == nullptr || parent != nullptr || G <= 0 ||
                  Bg <= 0))
    return cudaErrorInvalidValue;
  if (parent != nullptr && (small_left == nullptr || NC != 2 * K ||
                            rand_thr != nullptr))
    return cudaErrorInvalidValue;
  if (parent == nullptr && NC != K) return cudaErrorInvalidValue;
  const long long blocks =
      static_cast<long long>(NC) * ((tasks + kScanWarps - 1) / kScanWarps);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Hyper hp{use_l1, l1, l2, min_gain, min_data, min_hess,
                 max_delta_step};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool modes = mono != nullptr || bounds != nullptr ||
                     rand_thr != nullptr;
#define LAUNCH(Q, M, GR)                                                      \
  scan_kernel<Q, M, GR><<<static_cast<unsigned>(blocks), kScanWarps * 32, 0, \
                          st>>>(                                              \
      small, parent, static_cast<const int*>(small_left),                     \
      static_cast<const int*>(feat_group),                                    \
      static_cast<const int*>(feat_start), static_cast<const int*>(plan),     \
      tasks, static_cast<const float*>(sums),                                 \
      static_cast<const int*>(num_bin),                                       \
      static_cast<const int*>(missing_type),                                  \
      static_cast<const int*>(default_bin), static_cast<const int*>(mono),    \
      static_cast<const float*>(bounds), static_cast<const int*>(rand_thr),   \
      K, F, B, G, Bg, NC, scales, hp, static_cast<float*>(gain),              \
      static_cast<int*>(thr), static_cast<int*>(dl), static_cast<float*>(lg), \
      static_cast<float*>(lh), static_cast<float*>(lc))
#define BY_GROUPED(Q, M)      \
  do {                        \
    if (grouped)              \
      LAUNCH(Q, M, true);     \
    else                      \
      LAUNCH(Q, M, false);    \
  } while (0)
  if (quant && modes)
    BY_GROUPED(true, true);
  else if (quant)
    BY_GROUPED(true, false);
  else if (modes)
    BY_GROUPED(false, true);
  else
    BY_GROUPED(false, false);
#undef BY_GROUPED
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
