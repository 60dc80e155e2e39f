// Row binning (bucketize + EFB fold) for Hopper (sm_90a).
//
// Replaces the Pallas kernel lightgbm_tpu/ops/ingest.py::DeviceBinner._run
// (pallas_call at ingest.py:249, body _ingest_kernel at :166).  It computes
// what _ingest_kernel computes, byte for byte the host BinMapper
// value_to_bin + Dataset._bin_block path for f32 input:
//
//   X [n, F] f32 row-major -> binned [G, n] (uint8, or int32 where a group
//   has more than 256 bins), written FEATURE-MAJOR, the layout the trainer
//   keeps on the card, so no transpose follows.
//
//   numerical  bin = count(bounds < v) after NaN -> 0, by binary search
//              over the feature's directed-rounded f32 bounds (the same
//              count as the Pallas kernel's compare-and-sum over the
//              +inf-padded row); NaN -> num_bin - 1 where the feature
//              keeps a NaN bin
//   categorical NaN or |v| >= 2^31 -> no category; else iv = (int)truncf(v)
//              matches a code of the feature (iv >= 0): the bin is the
//              code's first index in the feature's code row, found by
//              a search over the (code, index) pairs ordered by code;
//              no match -> num_bin - 1
//   EFB fold   members of a group in ascending used-feature order,
//              col = bin != 0 ? start + bin - 1 : col (a singleton group is
//              the start == 1 case)
//
// What bounds it on the H100: bytes (4 n F read, n G written; ~0.04 ms
// at 1 M x 28).  A first design ran one thread per row over every member
// in series, each lookup a chain of dependent global/L1 reads (the member
// record, then ~8 binary-search steps in the +inf-padded bound row), and
// it staged X with a row stride of F words (4-way bank conflicts at F =
// 28); it reached 14% of the byte bound.  What holds this design back is
// the search (shared-memory latency and the deeper levels' bank
// conflicts), not the bytes.  It:
//
// - stages a group chunk's tables in shared memory ONCE per block: the
//   member records, the group pointers and one ragged table of 32-bit
//   words holding each feature's own bounds (f32) or its (code, index)
//   pairs, not rows padded to the widest feature; blocks are persistent
//   (a few per SM, each walks row tiles), so the staging is paid a few
//   hundred times, not once per tile;
// - searches in shared memory, each feature's run laid out as a perfect
//   search tree in BFS order (padded to 2^h - 1 words): a fixed number
//   of warp-uniform steps, and no bank conflicts in the first five
//   levels, where a bisection of a sorted row conflicts up to 32-way;
//   a lane's rows descend level by level together, one load a row in
//   flight (one descent after another left the search latency-bound);
// - stages each row tile of X (a contiguous run of rows * F floats) in
//   shared memory with float4 loads, four in flight a thread, the next
//   tile's first ones issued before this tile is binned, as a
//   column-major [F, rows + 4] tile whose 4-row groups are permuted by
//   column (xpos), so the transposing stores spread over the banks;
// - a warp bins a tile of 32 LR rows (LR = 4, 2 or 1 as the tile is 128,
//   64 or 32 rows; wide tables leave room only for the 32-row tile,
//   which at LR = 4 left 24 of 32 lanes idle): lane q takes rows LR q ..
//   LR q + LR - 1, reads them with one shared load (a warp's reads are
//   contiguous: no bank conflict), runs their LR descents level by level
//   together, and stores the LR bins at once (128 rows: one 32-bit word
//   a lane, int32 output one int4), so a warp writes its rows in one
//   store; element stores only at a ragged or unaligned edge (staging a
//   row-strided warp's bytes in shared memory to pack words cost more
//   than it saved);
// - the 8 or 16 warps of a block split the chunk's members evenly, not its
//   groups: at 674 one-hot features one EFB group holds 230 of 531
//   members, and one warp a group would leave that warp walking 230
//   members while the others wait.  A group shared by several warps is
//   folded from their partial bins in shared memory, in member order.
//
// Tables larger than a block's shared memory (many features, many bins)
// are cut by ops/planner.py into group chunks whose tables fit: grid.y
// walks the chunks, and each chunk re-reads the X tiles.  Up to about
// 1,500 features every chunk stages whole rows of X (all F columns, the
// float4 path above).  Wider, a chunk stages only the C distinct
// columns its members read, [C, rows + 4], gathered with scalar loads
// through its column list (one more table in shared memory): the tile
// no longer grows with F, so no width is refused.  A group whose tables
// exceed one chunk is cut into member parts, each its own chunk of a
// later launch on the same stream: the first part bins every row, a
// later part (overlay) stores only the rows where one of its members has
// a non-zero bin, so the parts fold in member order like the members of
// one chunk.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//        --fmad=false -shared -Xcompiler -fPIC (no fast math: NaN tests).
// The entry allocates nothing, launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// member record: column, start, flags, num_bin, word offset, tree depth
constexpr int kMemberInts = 6;
// chunk record: groups [g0, g1), members [m0, m1), words [w0, w1),
// columns [c0, c1) (ops/planner.py CHUNK_INTS)
constexpr int kChunkInts = 8;
// a launch's mode (the kernel's template argument, one for all its
// chunks): every chunk stages whole rows of X (all F columns, read as
// float4), or gathers its own columns, or gathers them as a later part
// of split groups (overlay: only non-zero bins are stored)
constexpr int kWholeRows = 0;
constexpr int kGathered = 1;
constexpr int kOverlay = 2;
constexpr int kFlagCat = 1;
constexpr int kFlagNanLast = 2;
constexpr float kCatHuge = 2147483648.0f;
constexpr int kDefaultSmem = 48 * 1024;
// at most kMaxThreads a block, and registers for kMinBlocks such blocks
// an SM (ops/planner.py INGEST_THREADS, INGEST_SM_THREADS)
constexpr int kMaxThreads = 512;
constexpr int kMinBlocks = 2;

// The tables are perfect binary search trees of depth h in BFS
// (Eytzinger) order: 2^h - 1 words, node i (1-based) at tab[i - 1], its
// children at 2i and 2i + 1, the in-order walk the sorted run padded at
// its end.  A descent takes exactly h steps whatever the value, and at
// step k a warp's lanes read within the 2^k words of one tree level:
// contiguous, so up to level 5 the reads hit 32 distinct banks (a
// bisection of a sorted row of 2^h words sends every lane of step k to
// addresses 2^(h - k) apart, all in one bank).

// count of bounds < v (NaN -> 0) for a lane's LR rows at once: the leaf
// each descent reaches, minus 2^h (the +inf padding is never < v); the
// descents advance level by level together, LR shared loads in flight
template <int LR>
__device__ __forceinline__ void numeric_bins(const int* tab, int h,
                                             const float (&v)[LR], int flags,
                                             int num_bin, int (&bin)[LR]) {
  float fz[LR];
  int node[LR];
#pragma unroll
  for (int i = 0; i < LR; ++i) {
    fz[i] = v[i] != v[i] ? 0.0f : v[i];
    node[i] = 1;
  }
  for (int k = 0; k < h; ++k) {
#pragma unroll
    for (int i = 0; i < LR; ++i)
      node[i] = 2 * node[i] + (__int_as_float(tab[node[i] - 1]) < fz[i]);
  }
#pragma unroll
  for (int i = 0; i < LR; ++i)
    bin[i] = ((flags & kFlagNanLast) && v[i] != v[i]) ? num_bin - 1
                                                       : node[i] - (1 << h);
}

// tab holds the codes' tree (INT_MAX padding, above any truncated f32
// below 2^31), then each node's index in the code row: the lower bound
// is the last node the descent left to the left
__device__ __forceinline__ int categorical_bin(const int* tab, int h,
                                               float v, int num_bin) {
  const bool miss = v != v || fabsf(v) >= kCatHuge;
  const int iv = miss ? -1 : static_cast<int>(truncf(v));
  if (iv < 0) return num_bin - 1;
  int i = 1, cand = 0;
  for (int k = 0; k < h; ++k) {
    if (tab[i - 1] < iv) {
      i = 2 * i + 1;
    } else {
      cand = i;
      i = 2 * i;
    }
  }
  return (cand && tab[cand - 1] == iv) ? tab[(1 << h) - 1 + cand - 1]
                                       : num_bin - 1;
}

constexpr int kVec = 4;  // float4 loads in flight per thread

// float4 [base + threadIdx.x + u * blockDim.x] of the tile's flat run
__device__ __forceinline__ void load_chunk(const float* __restrict__ X,
                                           long long tile, int tile_rows,
                                           long long n, int F, int base,
                                           float4 (&v)[kVec]) {
  const long long r0 = tile * tile_rows;
  const int total4 =
      static_cast<int>(min(static_cast<long long>(tile_rows), n - r0)) * F >> 2;
  const float4* src = reinterpret_cast<const float4*>(X + r0 * F);
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const int i = base + threadIdx.x + u * blockDim.x;
    if (i < total4) v[u] = __ldg(src + i);
  }
}

// where row r of column c sits in the tile: column-major [F, stride],
// each column's rows in 4-row groups whose order is permuted by the
// column (group (r / 4) XOR (c / 8), within the tile's groups), so the
// stores of a warp's consecutive floats, which walk the columns, spread
// over the banks (2-way at 28 features, 4-way at 674, against 4- and
// 15-way unpermuted); a lane's LR <= 4 rows stay contiguous and aligned
__device__ __forceinline__ int xpos(int r, int c, int stride, int gmask) {
  return c * stride + ((((r >> 2) ^ (c >> 3)) & gmask) << 2) + (r & 3);
}

// the same float4 into the tile
__device__ __forceinline__ void store_chunk(float* xs, int stride, int gmask,
                                            int F, int total4, int base,
                                            const float4 (&v)[kVec]) {
#pragma unroll
  for (int u = 0; u < kVec; ++u) {
    const int i = base + threadIdx.x + u * blockDim.x;
    if (i >= total4) continue;
    int r = (4 * i) / F;
    int c = 4 * i - r * F;
    const float f[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      xs[xpos(r, c, stride, gmask)] = f[j];
      if (++c == F) {
        c = 0;
        ++r;
      }
    }
  }
}

// a lane's LR consecutive floats of a tile column, one 4-, 8- or 16-byte
// shared load (the tile's stride, rows + 4, keeps them aligned)
template <int LR>
__device__ __forceinline__ void load_lane(const float* p, float (&v)[LR]) {
  if constexpr (LR == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  } else if constexpr (LR == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    v[0] = x.x;
    v[1] = x.y;
  } else {
    v[0] = *p;
  }
}

// a lane's LR bins as one store (a warp's 32 * LR rows in one
// instruction); false where dst is not aligned for it
template <int LR>
__device__ __forceinline__ bool store_lane(uint8_t* dst, const int (&col)[LR]) {
  if (reinterpret_cast<uintptr_t>(dst) & (LR - 1)) return false;
  unsigned int w = 0;
#pragma unroll
  for (int i = 0; i < LR; ++i)
    w |= static_cast<unsigned int>(col[i] & 255) << (8 * i);
  if constexpr (LR == 4) *reinterpret_cast<unsigned int*>(dst) = w;
  else if constexpr (LR == 2) *reinterpret_cast<unsigned short*>(dst) = w;
  else *dst = static_cast<uint8_t>(w);
  return true;
}

template <int LR>
__device__ __forceinline__ bool store_lane(int* dst, const int (&col)[LR]) {
  if (reinterpret_cast<uintptr_t>(dst) & (4 * LR - 1)) return false;
  if constexpr (LR == 4)
    *reinterpret_cast<int4*>(dst) = make_int4(col[0], col[1], col[2], col[3]);
  else if constexpr (LR == 2)
    *reinterpret_cast<int2*>(dst) = make_int2(col[0], col[1]);
  else
    *dst = col[0];
  return true;
}

// a lane's LR bins of one group (avail of its rows inside the tile, > 0),
// one store where whole and aligned; col[i] < 0 is no member's non-zero
// bin: 0, or, in an overlay launch, left as an earlier launch wrote it
template <typename OutT, int LR, bool kOverlayStore>
__device__ __forceinline__ void store_rows(OutT* dst, int avail,
                                           int (&col)[LR]) {
  if constexpr (kOverlayStore) {
#pragma unroll
    for (int i = 0; i < LR; ++i)
      if (i < avail && col[i] >= 0) dst[i] = static_cast<OutT>(col[i]);
  } else {
#pragma unroll
    for (int i = 0; i < LR; ++i) col[i] = max(col[i], 0);
    if (LR <= avail && store_lane<LR>(dst, col)) return;
#pragma unroll
    for (int i = 0; i < LR; ++i)
      if (i < avail) dst[i] = static_cast<OutT>(col[i]);
  }
}

// the last group g in [0, ng) with gp[g] <= m
__device__ __forceinline__ int group_of(const int* gp, int ng, int m) {
  int lo = 0, hi = ng - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (gp[mid] <= m) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// LR = tile_rows / 32: a lane bins LR consecutive rows, so every lane of
// a warp works whatever tile the planner picks; kMode: kWholeRows,
// kGathered or kOverlay
template <typename OutT, int LR, int kMode>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
    ingest_kernel(const float* __restrict__ X, long long n, int F,
                  int tile_rows, const int* __restrict__ group_ptr,
                  const int* __restrict__ members,
                  const int* __restrict__ words,
                  const int* __restrict__ chunks,
                  const int* __restrict__ columns, OutT* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = tile_rows + 4;  // column-major [C, R + 4]
  const int gmask = tile_rows / 4 - 1;
  const int warps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  // this block's group chunk: groups [g0, g1), members [m0, m1), words
  // [w0, w1), columns [c0, c1) of the column lists; a member's column is
  // its index in the chunk's list (the raw column in kWholeRows)
  constexpr bool kGather = kMode != kWholeRows;
  const int* ch = chunks + kChunkInts * blockIdx.y;
  const int g0 = ch[0], m0 = ch[2], w0 = ch[4];
  const int ng = ch[1] - g0, nm = ch[3] - m0, nw = ch[5] - w0;
  const int c0 = kGather ? ch[6] : 0;
  const int nc = kGather ? ch[7] - c0 : F;
  float* xs = reinterpret_cast<float*>(smem);                 // [C, stride]
  int* part = reinterpret_cast<int*>(xs + nc * stride);  // [warps, 2, R]
  int* mem_sh = part + 2 * warps * tile_rows;
  int* gp_sh = mem_sh + kMemberInts * nm;                      // [ng + 1]
  int* tab_sh = gp_sh + ng + 1;                                // [nw]
  int* col_sh = tab_sh + nw;                      // [nc], gathered chunks
  for (int i = threadIdx.x; i < nm * kMemberInts; i += blockDim.x) {
    int x = members[kMemberInts * m0 + i];
    if (i % kMemberInts == 4) x -= w0;
    mem_sh[i] = x;
  }
  // a part of a split group holds some of its group's members: [0, nm)
  // (whole-row chunks hold whole groups; the clamp there pushed the
  // 28-feature kernel over its 64 registers into a spill)
  for (int i = threadIdx.x; i <= ng; i += blockDim.x)
    gp_sh[i] = kGather ? min(max(group_ptr[g0 + i] - m0, 0), nm)
                       : group_ptr[g0 + i] - m0;
  for (int i = threadIdx.x; i < nw; i += blockDim.x) tab_sh[i] = words[w0 + i];
  if constexpr (kGather)
    for (int i = threadIdx.x; i < nc; i += blockDim.x)
      col_sh[i] = columns[c0 + i];
  __syncthreads();

  // This warp bins members [mb, me) of the chunk, an equal share, so a
  // group of many members (an EFB bundle of one-hot columns: 230 of 531
  // members in one group) spreads over several warps instead of holding
  // one warp while the others wait.  The fold keeps the LAST member with
  // a non-zero bin, so a group wholly inside [mb, me) is stored
  // directly; a warp that shares a group keeps its partial (-1 where no
  // member of its share had a non-zero bin) in part[wid][0] (the group
  // it starts in) or part[wid][1] (the group it ends in), and the warp
  // where that group starts folds the partials in warp order and stores.
  const int mb = static_cast<int>(static_cast<long long>(wid) * nm / warps);
  const int me =
      static_cast<int>(static_cast<long long>(wid + 1) * nm / warps);
  const int g_first = mb < me ? group_of(gp_sh, ng, mb) : 0;
  const int g_last = mb < me ? group_of(gp_sh, ng, me - 1) : 0;
  const bool merges =
      mb < me && gp_sh[g_last] >= mb && gp_sh[g_last + 1] > me;
  // the warp that holds the group's last member
  const int w_end =
      merges ? static_cast<int>((static_cast<long long>(gp_sh[g_last + 1]) *
                                     warps + nm - 1) / nm) - 1
             : wid;

  // X tiles are contiguous runs of rows * F floats: loaded as float4,
  // kVec a thread at once, the next tile's first kVec float4 in flight
  // while this tile is binned (a misaligned X takes scalar loads)
  const long long tiles = (n + tile_rows - 1) / tile_rows;
  const bool vec = !kGather && (reinterpret_cast<uintptr_t>(X) & 15) == 0;
  float4 pre[kVec];
  long long tile = blockIdx.x;
  if (vec && tile < tiles)
    load_chunk(X, tile, tile_rows, n, F, 0, pre);
  for (; tile < tiles; tile += gridDim.x) {
    const long long r0 = tile * tile_rows;
    const int rows = static_cast<int>(min(static_cast<long long>(tile_rows),
                                          n - r0));
    const int total = rows * F;
    __syncthreads();  // the tables are staged; the last tile is done
    if constexpr (kGather) {
      // the chunk's own columns, gathered: a row's columns are read by
      // neighbouring threads, so a run of adjacent columns is coalesced
      for (int e = threadIdx.x; e < rows * nc; e += blockDim.x) {
        const int r = e / nc;
        const int c = e - r * nc;
        xs[xpos(r, c, stride, gmask)] = __ldg(X + (r0 + r) * F + col_sh[c]);
      }
    } else if (vec) {
      const int total4 = total >> 2;
      store_chunk(xs, stride, gmask, F, total4, 0, pre);
      for (int base = kVec * blockDim.x; base < total4;
           base += kVec * blockDim.x) {
        load_chunk(X, tile, tile_rows, n, F, base, pre);
        store_chunk(xs, stride, gmask, F, total4, base, pre);
      }
      for (int e = 4 * total4 + threadIdx.x; e < total; e += blockDim.x) {
        const int r = e / F;
        xs[xpos(r, e - r * F, stride, gmask)] = X[r0 * F + e];
      }
    } else {
      for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int r = e / F;
        xs[xpos(r, e - r * F, stride, gmask)] = X[r0 * F + e];
      }
    }
    __syncthreads();
    if (vec && tile + gridDim.x < tiles)
      load_chunk(X, tile + gridDim.x, tile_rows, n, F, 0, pre);
    // lane q bins rows LR q .. LR q + LR - 1 of the tile (rows past the
    // tile's end read stale words of the tile and are never stored)
    const int q = lane;
    const int avail = rows - LR * q;
    int m = mb;
    for (int g = g_first; m < me; ++g) {
      const int gend = min(gp_sh[g + 1], me);
      int col[LR];
#pragma unroll
      for (int i = 0; i < LR; ++i) col[i] = -1;
      for (; m < gend; ++m) {
        const int* rec = mem_sh + kMemberInts * m;
        const int column = rec[0], start = rec[1], flags = rec[2];
        const int num_bin = rec[3];
        const int* tab = tab_sh + rec[4];
        const int depth = rec[5];
        float v[LR];
        load_lane<LR>(xs + xpos(LR * q, column, stride, gmask), v);
        int bin[LR];
        if (flags & kFlagCat) {
#pragma unroll
          for (int i = 0; i < LR; ++i)
            bin[i] = categorical_bin(tab, depth, v[i], num_bin);
        } else {
          numeric_bins<LR>(tab, depth, v, flags, num_bin, bin);
        }
#pragma unroll
        for (int i = 0; i < LR; ++i)
          if (bin[i] != 0) col[i] = start + bin[i] - 1;
      }
      const bool head = gp_sh[g] < mb;      // earlier warps hold members
      const bool tail = gp_sh[g + 1] > me;  // later warps hold members
      if (head || tail) {
#pragma unroll
        for (int i = 0; i < LR; ++i) {
          if (head) part[(2 * wid) * tile_rows + LR * q + i] = col[i];
          if (tail) part[(2 * wid + 1) * tile_rows + LR * q + i] = col[i];
        }
      } else if (avail > 0) {
        store_rows<OutT, LR, kMode == kOverlay>(
            out + static_cast<size_t>(g0 + g) * n + r0 + LR * q, avail, col);
      }
    }
    __syncthreads();  // every warp's partials are in part
    if (merges && avail > 0) {
      int col[LR];
#pragma unroll
      for (int i = 0; i < LR; ++i) col[i] = kMode == kOverlay ? -1 : 0;
      for (int w = wid; w <= w_end; ++w) {
        if (static_cast<long long>(w) * nm / warps ==
            static_cast<long long>(w + 1) * nm / warps)
          continue;  // a warp with no members
        const int* p =
            part + (2 * w + (w == wid ? 1 : 0)) * tile_rows + LR * q;
#pragma unroll
        for (int i = 0; i < LR; ++i)
          if (p[i] >= 0) col[i] = p[i];
      }
      store_rows<OutT, LR, kMode == kOverlay>(
          out + static_cast<size_t>(g0 + g_last) * n + r0 + LR * q, avail,
          col);
    }
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

// out_bytes is 1 (uint8 out) or 4 (int32 out); out is [G, n].  members
// [M, 6] (column index in its chunk's list, start, flags, num_bin, word
// offset, tree depth), group_ptr [G + 1] and words [W] are the ragged
// tables; chunks [nchunks, 8] holds this launch's chunk records (groups,
// members, words, columns) and columns the chunks' column lists; mode is
// kWholeRows (0), kGathered (1) or kOverlay (2); smem_bytes covers the
// largest chunk's X tile, partials and tables (ops/planner.py
// ingest_plan).  A binning whose plan has several launches makes them in
// order on one stream.
extern "C" int ingest_bin(const void* X, long long n, int F,
                          const void* group_ptr, const void* members,
                          const void* words, const void* chunks, int nchunks,
                          const void* columns, int mode, int G,
                          int out_bytes, int tile_rows, int grid_x,
                          int threads, int smem_bytes, void* out,
                          void* stream) {
  if (n <= 0 || G <= 0) return 0;
  if ((tile_rows != 32 && tile_rows != 64 && tile_rows != 128) ||
      nchunks <= 0 || grid_x <= 0 || threads <= 0 ||
      threads > kMaxThreads || threads % 32 != 0 || smem_bytes <= 0 ||
      mode < kWholeRows || mode > kOverlay)
    return cudaErrorInvalidValue;
  const dim3 grid(grid_x, nchunks);
  const size_t smem = static_cast<size_t>(smem_bytes);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(X);
  const int* gp = static_cast<const int*>(group_ptr);
  const int* mb = static_cast<const int*>(members);
  const int* wd = static_cast<const int*>(words);
  const int* ch = static_cast<const int*>(chunks);
  const int* cl = static_cast<const int*>(columns);
  cudaError_t err;
#define LAUNCH(OutT, LR, M)                                                  \
  do {                                                                       \
    if ((err = allow_smem(ingest_kernel<OutT, LR, M>, smem)) != cudaSuccess) \
      return err;                                                            \
    ingest_kernel<OutT, LR, M><<<grid, threads, smem, s>>>(                  \
        x, n, F, tile_rows, gp, mb, wd, ch, cl, static_cast<OutT*>(out));    \
  } while (0)
#define BY_MODE(OutT, LR)                 \
  do {                                    \
    if (mode == kWholeRows)               \
      LAUNCH(OutT, LR, kWholeRows);       \
    else if (mode == kGathered)           \
      LAUNCH(OutT, LR, kGathered);        \
    else                                  \
      LAUNCH(OutT, LR, kOverlay);         \
  } while (0)
#define BY_TILE(OutT)               \
  do {                              \
    if (tile_rows == 128)           \
      BY_MODE(OutT, 4);             \
    else if (tile_rows == 64)       \
      BY_MODE(OutT, 2);             \
    else                            \
      BY_MODE(OutT, 1);             \
  } while (0)
  if (out_bytes == 1) {
    BY_TILE(uint8_t);
  } else if (out_bytes == 4) {
    BY_TILE(int);
  } else {
    return cudaErrorInvalidValue;
  }
#undef BY_TILE
#undef BY_MODE
#undef LAUNCH
  return static_cast<int>(cudaGetLastError());
}
