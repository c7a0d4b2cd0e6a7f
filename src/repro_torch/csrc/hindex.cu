// Row-masked h-index sweep for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_hindex_kernel` / `h_index_pallas`
// (src/repro/kernels/hindex.py, search in `_bisect_h`): per row,
// out = max h <= min(est, W) with #{valid entries >= h} >= h. Exact integer
// arithmetic, no sort; equal to the sort-based `h_index_ref` bit for bit.
//
// What bounds it on the H100: memory. Each row is read once from HBM
// (R * W * 5 bytes with the validity mask, plus est and out); the search
// probes the row about log2(W) times, but after the first probe the row
// sits in L1, and a probe is one compare per entry.
//
// Design: one warp per row. A probe at threshold `mid` counts the row's
// entries >= mid 32 at a time with __ballot_sync + __popc, so the count is
// the same in every lane and the binary search on (lo, hi) stays
// warp-uniform without a reduction. The count stops early once it reaches
// `mid` (the probe already succeeded), and the search stops when lo == hi,
// which is the fixed point the TPU kernel's W.bit_length() unrolled steps
// reach. Invalid entries never count, so the hub tier's wide, mostly empty
// rows cost only their reads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per 256-thread block
constexpr unsigned kFull = 0xffffffffu;

__global__ void h_index_kernel(const int32_t* __restrict__ vals,
                               const uint8_t* __restrict__ valid,
                               const int32_t* __restrict__ est,
                               int32_t* __restrict__ out, int64_t r, int w) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= r) return;
  const int32_t* v = vals + row * w;
  const uint8_t* m = valid + row * w;
  int lo = 0;
  int hi = min(max(est[row], 0), w);
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    int cnt = 0;
    for (int j0 = 0; j0 < w && cnt < mid; j0 += 32) {
      const int j = j0 + lane;
      const bool ge = j < w && m[j] != 0 && v[j] >= mid;
      cnt += __popc(__ballot_sync(kFull, ge));
    }
    if (cnt >= mid) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  if (lane == 0) out[row] = lo;
}

}  // namespace

// Returns the cudaError_t of the launch.
extern "C" int h_index_launch(const void* vals, const void* valid,
                              const void* est, void* out, long long r, int w,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (r <= 0) return 0;
  const dim3 grid((unsigned)((r + kWarps - 1) / kWarps));
  const dim3 block(32 * kWarps);
  h_index_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(vals), static_cast<const uint8_t*>(valid),
      static_cast<const int32_t*>(est), static_cast<int32_t*>(out), r, w);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
