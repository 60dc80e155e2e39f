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
//   numerical  bin = count(bounds[row] < v) after NaN -> 0, by binary
//              search over the +inf-padded, directed-rounded f32 bound row
//              (the same count as the Pallas kernel's compare-and-sum);
//              NaN -> num_bin - 1 where the feature keeps a NaN bin
//   categorical NaN or |v| >= 2^31 -> no category; else iv = (int)truncf(v)
//              matches a code in the feature's row (iv >= 0); no match ->
//              num_bin - 1
//   EFB fold   members of a group in ascending used-feature order,
//              col = bin != 0 ? start + bin - 1 : col (a singleton group is
//              the start == 1 case)
//
// One thread per (row, group): the block stages its [rows, F] f32 tile in
// shared memory with coalesced loads, then each thread folds every group
// of its row and writes out[g, row], coalesced along rows.  Ragged tails
// are masked, never padded.
//
// What bounds it on the H100: bytes.  It must read 4 n F bytes and write
// n G bytes; each bound lookup is ~8 dependent shared/L1 reads (the bound
// rows, 28 x 255 f32 at HIGGS width, stay in L1/L2).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17
//        --fmad=false -shared -Xcompiler -fPIC (no fast math: NaN tests).
// The entry allocates nothing, launches on the caller's stream, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMemberInts = 6;  // column, start, is_cat, num_bin, row, nan_as_last
constexpr float kCatHuge = 2147483648.0f;
constexpr int kDefaultSmem = 48 * 1024;

template <typename OutT>
__global__ void ingest_kernel(const float* __restrict__ X, long long n, int F,
                              const float* __restrict__ bounds, int bw,
                              const int* __restrict__ cats, int cw,
                              const int* __restrict__ group_ptr,
                              const int* __restrict__ members, int G,
                              OutT* __restrict__ out) {
  extern __shared__ float xs[];
  const int R = blockDim.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  const int rows = static_cast<int>(min(static_cast<long long>(R), n - r0));
  const float* src = X + r0 * F;
  for (int i = threadIdx.x; i < rows * F; i += R) xs[i] = src[i];
  __syncthreads();
  const int r = threadIdx.x;
  if (r >= rows) return;
  const float* x = xs + r * F;
  for (int g = 0; g < G; ++g) {
    int col = 0;
    for (int m = group_ptr[g]; m < group_ptr[g + 1]; ++m) {
      const int* sp = members + kMemberInts * m;
      const float v = x[sp[0]];
      const bool nan = v != v;
      int bin;
      if (sp[2]) {
        bin = sp[3] - 1;
        const bool miss = nan || fabsf(v) >= kCatHuge;
        const int iv = miss ? -1 : static_cast<int>(truncf(v));
        if (iv >= 0) {
          const int* row = cats + static_cast<size_t>(sp[4]) * cw;
          for (int j = 0; j < cw; ++j) {
            if (row[j] == iv) {
              bin = j;
              break;
            }
          }
        }
      } else {
        const float fz = nan ? 0.0f : v;
        const float* row = bounds + static_cast<size_t>(sp[4]) * bw;
        int lo = 0, hi = bw;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (row[mid] < fz) lo = mid + 1;
          else hi = mid;
        }
        bin = lo;
        if (sp[5] && nan) bin = sp[3] - 1;
      }
      if (bin != 0) col = sp[1] + bin - 1;
    }
    out[static_cast<size_t>(g) * n + r0 + r] = static_cast<OutT>(col);
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

// out_bytes is 1 (uint8 out) or 4 (int32 out); out is [G, n].
extern "C" int ingest_bin(const void* X, long long n, int F,
                          const void* bounds, int bw, const void* cats,
                          int cw, const void* group_ptr, const void* members,
                          int G, int out_bytes, int tile_rows, void* out,
                          void* stream) {
  if (n <= 0 || G <= 0) return 0;
  if (tile_rows <= 0 || tile_rows > 1024 || bw <= 0 || cw <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(tile_rows) * F * sizeof(float);
  const unsigned grid = static_cast<unsigned>((n + tile_rows - 1) / tile_rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(X);
  const float* b = static_cast<const float*>(bounds);
  const int* c = static_cast<const int*>(cats);
  const int* gp = static_cast<const int*>(group_ptr);
  const int* mb = static_cast<const int*>(members);
  cudaError_t err;
  if (out_bytes == 1) {
    if ((err = allow_smem(ingest_kernel<uint8_t>, smem)) != cudaSuccess) return err;
    ingest_kernel<uint8_t><<<grid, tile_rows, smem, s>>>(
        x, n, F, b, bw, c, cw, gp, mb, G, static_cast<uint8_t*>(out));
  } else if (out_bytes == 4) {
    if ((err = allow_smem(ingest_kernel<int>, smem)) != cudaSuccess) return err;
    ingest_kernel<int><<<grid, tile_rows, smem, s>>>(
        x, n, F, b, bw, c, cw, gp, mb, G, static_cast<int*>(out));
  } else {
    return cudaErrorInvalidValue;
  }
  return static_cast<int>(cudaGetLastError());
}
