// Forest traversal for Hopper (sm_90a): every row descends every tree.
//
// Replaces the Pallas kernel lightgbm_tpu/ops/predict_kernels.py::
// fused_traverse (body _traverse_kernel, step decide_step).  It computes
// what decide_step computes, not what the TPU grid did step by step:
//
//   leaves mode  X [n, F] f32 -> leaf ids [T, n] int32 (~node)
//   scores mode  X [n, F] f32 -> raw scores [K, n] f32, tree t adding its
//                leaf value into class t % K, t ascending, plain f32 adds
//                (the pinned iteration-major order of the Pallas kernel)
//
// Routing, exactly as decide_step:
//   NaN -> 0 unless missing type is NaN (2); zero-missing is |v| <= 1e-35f;
//   fz <= thr is an f32 compare; a categorical node truncates the value
//   (NaN -> -1), is valid only for 0 <= iv < nw*32 and tests bit iv % 32 of
//   word co + min(iv / 32, max(nw - 1, 0)); the single-leaf sentinel node
//   (left = right = -1, thr = +inf) routes to leaf 0.
//
// What bounds it on the H100: not bytes.  At 500 trees x 254 nodes the
// nine int32/f32 node planes are 4.6 MB and stay in the 50 MB L2; each
// level of a descent is a chain of dependent loads (node -> feature value
// -> threshold compare -> child), so a thread waits on L2 latency once or
// twice per level.  The design hides that latency with many threads in
// flight, not with bandwidth:
//   - one thread per row; the block's [rows, F] X tile is staged in shared
//     memory with coalesced loads, so only the node planes go to L2;
//   - leaves mode spreads trees over a second grid axis (kTreesPerBlock
//     trees per block), so a small serving batch still fills many SMs;
//     leaf ids are written coalesced along rows;
//   - scores mode walks all trees in order in one thread per row, because
//     the pinned order allows no tree-parallel reduction;
//   - a thread stops at its leaf instead of running max_depth trips (the
//     step is idempotent on a leaf, so the result is the same).
// Packed node records, tensor cores and TMA are left for later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//        --fmad=false -shared -Xcompiler -fPIC (no --use_fast_math: isnan,
//        the 1e-35 compare and denormal inputs need IEEE behaviour).
// The entry allocates nothing, launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTreesPerBlock = 8;
constexpr float kZeroThreshold = 1e-35f;
// largest f32 below 2^31: the categorical value is clamped to
// [-1, kCatMax] before the int cast, so the cast is always defined
constexpr float kCatMax = 2147483520.0f;
constexpr int kDefaultSmem = 48 * 1024;

struct Planes {
  const int* sf;
  const float* thr;
  const int* left;
  const int* right;
  const int* mt;
  const int* dl;
  const int* ic;
  const int* co;
  const int* cn;
  const uint32_t* cw;
  int W;  // bitset words
  int I;  // node slots per tree
};

template <bool kHasCat>
__device__ __forceinline__ int descend(const Planes& p, const float* x,
                                       int t, int depth) {
  const int base = t * p.I;
  int node = 0;
  for (int d = 0; d < depth && node >= 0; ++d) {
    const int j = base + node;
    const float v = x[p.sf[j]];
    const bool nan = isnan(v);
    const int m = p.mt[j];
    const float fz = (nan && m != 2) ? 0.0f : v;
    const bool missing = (m == 1 && fabsf(fz) <= kZeroThreshold) ||
                         (m == 2 && nan);
    bool go_left = missing ? (p.dl[j] != 0) : (fz <= p.thr[j]);
    if (kHasCat && p.ic[j] != 0) {
      const float tv = fminf(fmaxf(truncf(nan ? -1.0f : v), -1.0f), kCatMax);
      const int iv = static_cast<int>(tv);
      const int nw = p.cn[j];
      const bool valid = iv >= 0 && iv < nw * 32;
      const int ivc = iv < 0 ? 0 : iv;
      int widx = p.co[j] + min(ivc >> 5, max(nw - 1, 0));
      widx = min(max(widx, 0), p.W - 1);
      go_left = valid && ((p.cw[widx] >> (ivc & 31)) & 1u);
    }
    node = go_left ? p.left[j] : p.right[j];
  }
  return node;
}

// Stage the block's [rows, F] X tile in shared memory; returns rows.
__device__ __forceinline__ int stage_tile(const float* __restrict__ X, int n,
                                          int F, float* xs) {
  const int R = blockDim.x;
  const int r0 = blockIdx.x * R;
  const int rows = min(R, n - r0);
  const float* src = X + static_cast<size_t>(r0) * F;
  for (int i = threadIdx.x; i < rows * F; i += R) xs[i] = src[i];
  __syncthreads();
  return rows;
}

template <bool kHasCat>
__global__ void leaves_kernel(const float* __restrict__ X, int n, int F,
                              Planes p, int T, int depth,
                              int* __restrict__ out) {
  extern __shared__ float xs[];
  const int rows = stage_tile(X, n, F, xs);
  const int r = threadIdx.x;
  if (r >= rows) return;
  const float* x = xs + r * F;
  const size_t row = static_cast<size_t>(blockIdx.x) * blockDim.x + r;
  const int t0 = blockIdx.y * kTreesPerBlock;
  const int t1 = min(t0 + kTreesPerBlock, T);
  for (int t = t0; t < t1; ++t)
    out[static_cast<size_t>(t) * n + row] = ~descend<kHasCat>(p, x, t, depth);
}

template <bool kHasCat>
__global__ void scores_kernel(const float* __restrict__ X, int n, int F,
                              Planes p, int T, int depth,
                              const float* __restrict__ leaf_value, int L,
                              int K, float* __restrict__ out) {
  extern __shared__ float xs[];
  const int rows = stage_tile(X, n, F, xs);
  const int r = threadIdx.x;
  if (r >= rows) return;
  const float* x = xs + r * F;
  const size_t row = static_cast<size_t>(blockIdx.x) * blockDim.x + r;
  if (K == 1) {
    float acc = 0.0f;
    for (int t = 0; t < T; ++t) {
      const int leaf = ~descend<kHasCat>(p, x, t, depth);
      acc = __fadd_rn(acc, leaf_value[static_cast<size_t>(t) * L + leaf]);
    }
    out[row] = acc;
    return;
  }
  // K > 1: the row's K accumulators live in its own output column
  for (int k = 0; k < K; ++k) out[static_cast<size_t>(k) * n + row] = 0.0f;
  for (int t = 0; t < T; ++t) {
    const int leaf = ~descend<kHasCat>(p, x, t, depth);
    float* o = out + static_cast<size_t>(t % K) * n + row;
    *o = __fadd_rn(*o, leaf_value[static_cast<size_t>(t) * L + leaf]);
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

// leaf_value == nullptr selects leaves mode (out is int32 [T, n]);
// otherwise scores mode (out is f32 [K, n], T a multiple of K).
extern "C" int traverse_forest(
    const void* X, int n, int F,
    const void* sf, const void* thr, const void* left, const void* right,
    const void* mt, const void* dl, const void* ic, const void* co,
    const void* cn, const void* cw, int W, int T, int I, int depth,
    int has_cat, const void* leaf_value, int L, int K, int tile_rows,
    void* out, void* stream) {
  if (n <= 0 || T <= 0) return 0;
  if (tile_rows <= 0 || tile_rows > 1024 || W <= 0) return cudaErrorInvalidValue;
  Planes p{static_cast<const int*>(sf),    static_cast<const float*>(thr),
           static_cast<const int*>(left),  static_cast<const int*>(right),
           static_cast<const int*>(mt),    static_cast<const int*>(dl),
           static_cast<const int*>(ic),    static_cast<const int*>(co),
           static_cast<const int*>(cn),    static_cast<const uint32_t*>(cw),
           W, I};
  const float* x = static_cast<const float*>(X);
  const size_t smem = static_cast<size_t>(tile_rows) * F * sizeof(float);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned row_tiles = (n + tile_rows - 1) / tile_rows;
  cudaError_t err;
  if (leaf_value == nullptr) {
    const dim3 grid(row_tiles, (T + kTreesPerBlock - 1) / kTreesPerBlock);
    int* o = static_cast<int*>(out);
    if (has_cat) {
      if ((err = allow_smem(leaves_kernel<true>, smem)) != cudaSuccess) return err;
      leaves_kernel<true><<<grid, tile_rows, smem, s>>>(x, n, F, p, T, depth, o);
    } else {
      if ((err = allow_smem(leaves_kernel<false>, smem)) != cudaSuccess) return err;
      leaves_kernel<false><<<grid, tile_rows, smem, s>>>(x, n, F, p, T, depth, o);
    }
  } else {
    if (K <= 0 || T % K != 0) return cudaErrorInvalidValue;
    const float* lv = static_cast<const float*>(leaf_value);
    float* o = static_cast<float*>(out);
    if (has_cat) {
      if ((err = allow_smem(scores_kernel<true>, smem)) != cudaSuccess) return err;
      scores_kernel<true><<<row_tiles, tile_rows, smem, s>>>(x, n, F, p, T, depth, lv, L, K, o);
    } else {
      if ((err = allow_smem(scores_kernel<false>, smem)) != cudaSuccess) return err;
      scores_kernel<false><<<row_tiles, tile_rows, smem, s>>>(x, n, F, p, T, depth, lv, L, K, o);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
