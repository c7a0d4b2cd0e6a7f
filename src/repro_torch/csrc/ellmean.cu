// ELL neighbour mean for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_ell_mean_kernel` / `ell_mean_pallas`
// (src/repro/kernels/ellmean.py): out[i] = mean over valid j of
// emb[idx[i, j]], rows with no valid entry give 0, fp32 accumulation, the
// result stored in emb's type. The (N, L, D) gather is never materialised.
//
// What bounds it on the H100: memory. Every valid entry pulls one D-wide row
// of `emb` (a random gather), so the bytes are about
// sum(cnt) * D * s + N * L * 5 + N * D * s and the one add per gathered
// element is noise next to them.
//
// Design: one warp per destination row. The warp reads 32 (idx, valid)
// slots at a time, one per lane, and walks the set bits of the ballot of
// `valid`, so invalid slots cost nothing and there is no left-pack pass (the
// TPU path's argsort). For each valid neighbour the lanes span D, with
// 16-byte float4 loads for fp32 rows whose width is a multiple of 4 and
// scalar loads otherwise. The TPU kernel's double-buffered per-row DMA
// becomes many resident warps hiding each other's gather latency.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // rows per 256-thread block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStrip = 4;  // columns (or float4s) per lane per strip

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Generic path: any D, fp32 or bf16, scalar loads.
template <typename T>
__global__ void ell_mean_scalar(const int32_t* __restrict__ idx,
                                const uint8_t* __restrict__ valid,
                                const T* __restrict__ emb, T* __restrict__ out,
                                int64_t n, int l, int d) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const int32_t* ri = idx + row * l;
  const uint8_t* rv = valid + row * l;
  for (int c0 = 0; c0 < d; c0 += 32 * kStrip) {
    float acc[kStrip] = {0.f, 0.f, 0.f, 0.f};
    int cnt = 0;
    for (int j0 = 0; j0 < l; j0 += 32) {
      const int j = j0 + lane;
      const bool ok = j < l && rv[j] != 0;
      const int32_t my = ok ? ri[j] : 0;
      unsigned mask = __ballot_sync(kFull, ok);
      cnt += __popc(mask);
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const T* e = emb + (int64_t)__shfl_sync(kFull, my, src) * d;
#pragma unroll
        for (int u = 0; u < kStrip; ++u) {
          const int c = c0 + u * 32 + lane;
          if (c < d) acc[u] += to_f32(e[c]);
        }
      }
    }
    const float denom = fmaxf((float)cnt, 1.f);
#pragma unroll
    for (int u = 0; u < kStrip; ++u) {
      const int c = c0 + u * 32 + lane;
      if (c < d) put(out + row * d + c, acc[u] / denom);
    }
  }
}

// fp32 rows whose width is a multiple of 4: 16-byte loads and stores.
__global__ void ell_mean_f32x4(const int32_t* __restrict__ idx,
                               const uint8_t* __restrict__ valid,
                               const float* __restrict__ emb,
                               float* __restrict__ out, int64_t n, int l,
                               int d) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const int d4 = d >> 2;
  const int32_t* ri = idx + row * l;
  const uint8_t* rv = valid + row * l;
  float4* o = reinterpret_cast<float4*>(out + row * d);
  for (int c0 = 0; c0 < d4; c0 += 32 * kStrip) {
    float4 acc[kStrip];
#pragma unroll
    for (int u = 0; u < kStrip; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    int cnt = 0;
    for (int j0 = 0; j0 < l; j0 += 32) {
      const int j = j0 + lane;
      const bool ok = j < l && rv[j] != 0;
      const int32_t my = ok ? ri[j] : 0;
      unsigned mask = __ballot_sync(kFull, ok);
      cnt += __popc(mask);
      while (mask) {
        const int src = __ffs(mask) - 1;
        mask &= mask - 1;
        const float4* e = reinterpret_cast<const float4*>(
            emb + (int64_t)__shfl_sync(kFull, my, src) * d);
#pragma unroll
        for (int u = 0; u < kStrip; ++u) {
          const int c = c0 + u * 32 + lane;
          if (c < d4) {
            const float4 v = __ldg(e + c);
            acc[u].x += v.x;
            acc[u].y += v.y;
            acc[u].z += v.z;
            acc[u].w += v.w;
          }
        }
      }
    }
    const float denom = fmaxf((float)cnt, 1.f);
#pragma unroll
    for (int u = 0; u < kStrip; ++u) {
      const int c = c0 + u * 32 + lane;
      if (c < d4) {
        o[c] = make_float4(acc[u].x / denom, acc[u].y / denom,
                           acc[u].z / denom, acc[u].w / denom);
      }
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int ell_mean_launch(const void* idx, const void* valid,
                               const void* emb, void* out, long long n, int l,
                               int d, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0 || d <= 0) return 0;
  const dim3 grid((unsigned)((n + kWarps - 1) / kWarps));
  const dim3 block(32 * kWarps);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  if (dtype == 0 && d % 4 == 0) {
    ell_mean_f32x4<<<grid, block, 0, s>>>(
        i, v, static_cast<const float*>(emb), static_cast<float*>(out), n, l, d);
  } else if (dtype == 0) {
    ell_mean_scalar<float><<<grid, block, 0, s>>>(
        i, v, static_cast<const float*>(emb), static_cast<float*>(out), n, l, d);
  } else if (dtype == 1) {
    ell_mean_scalar<__nv_bfloat16><<<grid, block, 0, s>>>(
        i, v, static_cast<const __nv_bfloat16*>(emb),
        static_cast<__nv_bfloat16*>(out), n, l, d);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
