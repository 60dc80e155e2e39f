// Forest traversal for Hopper (sm_90a): kernel B1.
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
// The node records (ops/predict_kernels.py pack_nodes, built once per
// DeviceForest): one 16-byte int4 a node,
//   x = feature | missing type << 28 | default left << 30 | categorical << 31
//   y = the f32 threshold's bits, z = left child, w = right child,
// so a level of a descent is one vector load; a categorical node's
// (cat_offset, cat_nwords) sit in a second int2 plane, read only when the
// record's sign bit says so.
//
// What bounds it on the H100: not bytes.  Each level of a descent is a
// chain of dependent loads (record -> feature value -> compare -> child).
// The old design walked a row through 8 (leaves) or all T (scores) trees
// in one thread: T x depth L2 round trips in a row, and in scores mode with
// K > 1 a global read-modify-write of the output per tree.  This design:
//   - descends trees in parallel: a block takes R rows x G trees, one
//     thread a (row, tree) pair at a time, rows fastest (so leaf ids and
//     values are written coalesced along rows); a lane that reaches its
//     leaf takes its next pair at once, so a warp's lanes stay busy
//     whatever the depths of their pairs;
//   - copies the block's X tile, and where they fit its G trees' records,
//     into shared memory with cp.async (every copy in flight at once), so
//     the dependent loads of a descent hit shared memory instead of L2; a
//     block of a large batch walks P row tiles with its trees staged once;
//   - separates descent from sum in scores mode, which keeps the pinned
//     order: the descents write each (tree, row)'s leaf value into a
//     [T, n] f32 scratch, then ordered_sum_kernel gives one thread to each
//     (class, row), which adds its trees' values in t order with
//     __fadd_rn into an f32 accumulator (loads running 16 ahead), the same
//     sequence of adds as pinned_leaf_sum; no output is read back per
//     tree.  (One block a row tile walking every tree in chunks, its leaf
//     values in shared memory, was slower at every size measured, 65,536
//     rows included.)
//   - stops a descent at its leaf instead of running max_depth trips (the
//     step is idempotent on a leaf, so the result is the same).
// ops/planner.py traverse_plan picks R, G, P, the threads and whether the
// records are staged: at a 65,536-row chunk of 255-leaf trees the bytes
// of 30 trees a block exceed what keeps the SM's occupancy, and the
// records are read through L1 from global memory instead.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//        --fmad=false -shared -Xcompiler -fPIC (no --use_fast_math: isnan,
//        the 1e-35 compare and denormal inputs need IEEE behaviour).
// The entry allocates nothing (the wrapper passes the scratch), launches on
// the caller's stream, does not synchronise, and returns cudaGetLastError().

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kZeroThreshold = 1e-35f;
// largest f32 below 2^31: the categorical value is clamped to
// [-1, kCatMax] before the int cast, so the cast is always defined
constexpr float kCatMax = 2147483520.0f;
constexpr int kFeatureMask = 0x0fffffff;
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxSmem = 227 * 1024;

struct Forest {
  const int4* nodes;    // [T * I] packed records
  const int2* cats;     // [T * I] (cat_offset, cat_nwords)
  const uint32_t* cw;   // [W] bitset words
  int W;
  int T;
  int I;                // node slots a tree
  int depth;
};

// One level of a descent: the child that node `node` of a tree whose
// records start at `nodes` (and `cats`) routes `x` to; the records are in
// shared memory when kStage, else in global memory.
template <bool kHasCat, bool kStage>
__device__ __forceinline__ int step(const int4* nodes, const int2* cats,
                                    const uint32_t* __restrict__ cw, int W,
                                    const float* x, int node) {
  const int4 rec = kStage ? nodes[node] : __ldg(nodes + node);
  const int m = (rec.x >> 28) & 3;
  const float v = x[rec.x & kFeatureMask];
  const bool nan = isnan(v);
  const float fz = (nan && m != 2) ? 0.0f : v;
  const bool missing = (m == 1 && fabsf(fz) <= kZeroThreshold) ||
                       (m == 2 && nan);
  bool go_left = missing ? ((rec.x >> 30) & 1) != 0
                         : (fz <= __int_as_float(rec.y));
  if (kHasCat && rec.x < 0) {
    const int2 c = kStage ? cats[node] : __ldg(cats + node);
    const float tv = fminf(fmaxf(truncf(nan ? -1.0f : v), -1.0f), kCatMax);
    const int iv = static_cast<int>(tv);
    const int nw = c.y;
    const bool valid = iv >= 0 && iv < nw * 32;
    const int ivc = iv < 0 ? 0 : iv;
    int widx = c.x + min(ivc >> 5, max(nw - 1, 0));
    widx = min(max(widx, 0), W - 1);
    go_left = valid && ((__ldg(cw + widx) >> (ivc & 31)) & 1u);
  }
  return go_left ? rec.z : rec.w;
}

// The block's (row, tree) pairs p = threadIdx.x, + blockDim.x, ... of
// rows x g (tree j = p / rows of the block's trees from t0, row r = p %
// rows of its tile), each descended from the root until it reaches a leaf
// (or depth levels), then emit(j, r, leaf id).  A lane that reaches its
// leaf takes its next pair at once, so the lanes of a warp stay busy on
// the same loop body whatever the depths of their pairs.
template <bool kHasCat, bool kStage, typename Emit>
__device__ __forceinline__ void descend_pairs(const Forest& f,
                                              const int4* s_nodes,
                                              const int2* s_cats,
                                              const float* xs, int F,
                                              int rows, int g, int t0,
                                              Emit emit) {
  const int total = rows * g;
  int p = threadIdx.x;
  if (p >= total) return;
  int j = p / rows;
  int r = p - j * rows;
  size_t tb = kStage ? static_cast<size_t>(j) * f.I
                     : static_cast<size_t>(t0 + j) * f.I;
  int node = 0;
  int d = 0;
  for (;;) {
    node = step<kHasCat, kStage>((kStage ? s_nodes : f.nodes) + tb,
                                 (kStage ? s_cats : f.cats) + tb, f.cw, f.W,
                                 xs + r * F, node);
    if (node >= 0 && ++d < f.depth) continue;
    emit(j, r, ~node);
    p += blockDim.x;
    if (p >= total) return;
    j = p / rows;
    r = p - j * rows;
    tb = kStage ? static_cast<size_t>(j) * f.I
                : static_cast<size_t>(t0 + j) * f.I;
    node = 0;
    d = 0;
  }
}

// a += p[0], p[stride], ... (count terms) in order, with __fadd_rn; the
// loads run kU ahead of the adds
template <int kU>
__device__ __forceinline__ float add_in_order(float a, const float* p,
                                              int count, int stride) {
  int i = 0;
  for (; i + kU <= count; i += kU) {
    float v[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) v[u] = p[(i + u) * stride];
#pragma unroll
    for (int u = 0; u < kU; ++u) a = __fadd_rn(a, v[u]);
  }
  for (; i < count; ++i) a = __fadd_rn(a, p[i * stride]);
  return a;
}

// Stage the block's X rows and (when kStage) its trees' records in shared
// memory with asynchronous copies (cp.async: every copy in flight at once,
// none through registers); the caller waits and syncs (wait_staged).
__device__ __forceinline__ void stage_rows(const float* __restrict__ X,
                                           int F, int r0, int rows,
                                           float* xs) {
  const float* src = X + static_cast<size_t>(r0) * F;
  for (int i = threadIdx.x; i < rows * F; i += blockDim.x)
    __pipeline_memcpy_async(xs + i, src + i, sizeof(float));
}

template <bool kHasCat>
__device__ __forceinline__ void stage_trees(const Forest& f, int t0, int g,
                                            int4* nodes, int2* cats) {
  const size_t base = static_cast<size_t>(t0) * f.I;
  for (int i = threadIdx.x; i < g * f.I; i += blockDim.x) {
    __pipeline_memcpy_async(nodes + i, f.nodes + base + i, sizeof(int4));
    if (kHasCat)
      __pipeline_memcpy_async(cats + i, f.cats + base + i, sizeof(int2));
  }
}

__device__ __forceinline__ void wait_staged() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
}

// Block (x, y) takes trees [y G, y G + G), their records
// staged once (kStage), through row tiles x P, ..., x P + P - 1 of R rows
// each; writes ~leaf (int32) or, with kValues, the leaf's value (f32) at
// [t, row] of a [T, n] output.
template <bool kHasCat, bool kStage, bool kValues>
__global__ void descend_kernel(const float* __restrict__ X, int n, int F,
                               Forest f, int R, int G, int P,
                               const float* __restrict__ leaf_value, int L,
                               void* __restrict__ out) {
  // shared memory: [G * I] records (+ [G * I] cat records) when staged,
  // then the [R, F] X tile
  extern __shared__ int4 nodes[];
  int2* cats = reinterpret_cast<int2*>(nodes + (kStage ? G * f.I : 0));
  float* xs =
      reinterpret_cast<float*>(cats + (kStage && kHasCat ? G * f.I : 0));
  const int t0 = blockIdx.y * G;
  const int g = min(G, f.T - t0);
  if (kStage) stage_trees<kHasCat>(f, t0, g, nodes, cats);
  const int tile1 = min((n + R - 1) / R, (blockIdx.x + 1) * P);
  for (int tile = blockIdx.x * P; tile < tile1; ++tile) {
    const int r0 = tile * R;
    const int rows = min(R, n - r0);
    __syncthreads();  // the previous tile's descents are done with its rows
    stage_rows(X, F, r0, rows, xs);
    wait_staged();
    descend_pairs<kHasCat, kStage>(
        f, nodes, cats, xs, F, rows, g, t0, [&](int j, int r, int leaf) {
          const size_t t = static_cast<size_t>(t0 + j);
          const size_t o = t * n + r0 + r;
          if (kValues)
            static_cast<float*>(out)[o] = leaf_value[t * L + leaf];
          else
            static_cast<int*>(out)[o] = leaf;
        });
  }
}

// The pinned sum: vals [T, n] f32 -> out [K, n]; block x takes
// rows [x R, x R + R), stages C trees' values at a time in shared memory,
// and thread (k, r) adds trees k, k + K, ... in ascending order.
__global__ void ordered_sum_kernel(const float* __restrict__ vals, int n,
                                   int T, int K, int R, int C,
                                   float* __restrict__ out) {
  extern __shared__ float sm[];
  float* acc = sm;            // [K, R]
  float* tile = sm + K * R;   // [C, R]
  const int r0 = blockIdx.x * R;
  const int rows = min(R, n - r0);
  for (int j = threadIdx.x; j < K * R; j += blockDim.x) acc[j] = 0.0f;
  for (int c0 = 0; c0 < T; c0 += C) {
    const int c = min(C, T - c0);
    __syncthreads();  // the previous chunk's sums are done with the tile
    for (int i = threadIdx.x; i < c * rows; i += blockDim.x) {
      const int j = i / rows;
      const int r = i - j * rows;
      __pipeline_memcpy_async(tile + j * R + r,
                              vals + static_cast<size_t>(c0 + j) * n + r0 + r,
                              sizeof(float));
    }
    wait_staged();
    // thread (k, r): the chunk's trees of class k, t ascending
    for (int j = threadIdx.x; j < K * R; j += blockDim.x) {
      const int k = j / R;
      const int r = j - k * R;
      if (r >= rows) continue;
      const int first = (k - c0 % K + K) % K;   // first tree of class k
      const int count = first < c ? (c - first + K - 1) / K : 0;
      acc[j] = add_in_order<16>(acc[j], tile + first * R + r, count, K * R);
    }
  }
  // each acc[j] is read and written by one thread only: no barrier
  for (int j = threadIdx.x; j < K * R; j += blockDim.x) {
    const int k = j / R;
    const int r = j - k * R;
    if (r < rows) out[static_cast<size_t>(k) * n + r0 + r] = acc[j];
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool kHasCat, bool kStage, bool kValues>
cudaError_t launch_descend(dim3 grid, int threads, size_t smem,
                           cudaStream_t s, const float* x, int n, int F,
                           const Forest& f, int R, int G, int P,
                           const float* lv, int L, void* out) {
  auto kernel = descend_kernel<kHasCat, kStage, kValues>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, s>>>(x, n, F, f, R, G, P, lv, L, out);
  return cudaSuccess;
}

template <bool kHasCat, bool kStage>
cudaError_t dispatch(bool values, dim3 grid, int threads, size_t smem,
                     cudaStream_t s, const float* x, int n, int F,
                     const Forest& f, int R, int G, int P, const float* lv,
                     int L, void* out) {
  return values ? launch_descend<kHasCat, kStage, true>(
                      grid, threads, smem, s, x, n, F, f, R, G, P, lv, L, out)
                : launch_descend<kHasCat, kStage, false>(
                      grid, threads, smem, s, x, n, F, f, R, G, P, lv, L,
                      out);
}

}  // namespace

// leaf_value == nullptr selects leaves mode: out int32 [T, n].  Otherwise
// scores mode: the descents write leaf values into scratch f32 [T, n],
// then the ordered sum (sum_rows rows a block, sum_trees trees a staged
// chunk) writes out f32 [K, n]; T must be a multiple of K.  A descent
// block takes rows x trees pairs and walks row_tiles tiles of rows rows;
// stage puts its trees' records in shared memory.
extern "C" int traverse_forest(
    const void* X, int n, int F, const void* nodes, const void* cats,
    const void* cw, int W, int T, int I, int depth, int has_cat,
    const void* leaf_value, int L, int K, int rows, int trees, int row_tiles,
    int threads, int stage, int sum_rows, int sum_trees, void* scratch,
    void* out, void* stream) {
  if (n <= 0 || T <= 0) return 0;
  if (rows <= 0 || trees <= 0 || row_tiles <= 0 || threads <= 0 ||
      threads > 1024 || threads % 32 != 0 || W <= 0 || I <= 0 || F <= 0)
    return cudaErrorInvalidValue;
  const bool scores = leaf_value != nullptr;
  if (scores && (K <= 0 || T % K != 0 || sum_rows <= 0 || sum_trees <= 0 ||
                 scratch == nullptr))
    return cudaErrorInvalidValue;
  const Forest f{static_cast<const int4*>(nodes),
                 static_cast<const int2*>(cats),
                 static_cast<const uint32_t*>(cw), W, T, I, depth};
  const size_t rec = stage ? (has_cat ? 24 : 16) : 0;
  const size_t smem = static_cast<size_t>(trees) * I * rec +
                      static_cast<size_t>(rows) * F * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const int tiles = (n + rows - 1) / rows;
  const dim3 grid((tiles + row_tiles - 1) / row_tiles,
                  (T + trees - 1) / trees);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(X);
  const float* lv = static_cast<const float*>(leaf_value);
  void* dst = scores ? scratch : out;
  cudaError_t err;
  if (has_cat)
    err = stage ? dispatch<true, true>(scores, grid, threads, smem, s, x, n,
                                       F, f, rows, trees, row_tiles, lv, L,
                                       dst)
                : dispatch<true, false>(scores, grid, threads, smem, s, x, n,
                                        F, f, rows, trees, row_tiles, lv, L,
                                        dst);
  else
    err = stage ? dispatch<false, true>(scores, grid, threads, smem, s, x, n,
                                        F, f, rows, trees, row_tiles, lv, L,
                                        dst)
                : dispatch<false, false>(scores, grid, threads, smem, s, x, n,
                                         F, f, rows, trees, row_tiles, lv, L,
                                         dst);
  if (err != cudaSuccess) return err;
  if (scores) {
    const size_t sum_smem =
        (static_cast<size_t>(K) + sum_trees) * sum_rows * sizeof(float);
    if (sum_smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
    if ((err = allow_smem(ordered_sum_kernel, sum_smem)) != cudaSuccess)
      return err;
    const unsigned blocks = (n + sum_rows - 1) / sum_rows;
    ordered_sum_kernel<<<blocks, 256, sum_smem, s>>>(
        static_cast<const float*>(scratch), n, T, K, sum_rows, sum_trees,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
