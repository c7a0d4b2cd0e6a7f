// Fused SGNS loss forward and backward for Hopper (sm_90a), hand-written
// CUDA C++.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` / `sgns_loss_fwd_pallas` and
// `_bwd_kernel` / `sgns_loss_bwd_pallas` (src/repro/kernels/sgns.py). Per
// example b, with c = center[b], x = ctx[b] and n_k = neg[b, k]:
//   pos = <c, x>, negl_k = <n_k, c>,
//   loss = softplus(-pos) + sum_k softplus(negl_k)              (forward)
//   dpos = (sigmoid(pos) - 1) d, dneg_k = sigmoid(negl_k) d,    (backward)
//   dc = dpos x + sum_k dneg_k n_k, dx = dpos c, dn_k = dneg_k c
// with d = dout[b]. Inputs are fp32 or bf16; the dots accumulate in fp32;
// the loss is fp32 and each gradient comes back in its input's type. The
// backward recomputes the logits from the inputs: nothing is kept from the
// forward, as in the JAX package's custom_vjp.
//
// What bounds it on the H100: memory. Each example is one GEMV of K + 1
// rows of width D against c (2 FLOP per element read), far below the
// ~20 FLOP/byte the card needs before fp32 FFMA, let alone the tensor cores,
// is the limit. The forward reads (2 + K) B D elements and writes B floats;
// the backward reads as much again plus dout and writes (2 + K) B D.
//
// Design: one warp per example, eight examples per 256-thread block. Lanes
// stride D (D = 150 at the paper's width is not a multiple of 32, and
// nothing is padded to 128 as the TPU wrapper does), with fp32 FFMA and a
// butterfly shuffle reduction per dot. The K negative logits of a warp sit
// in shared memory (K floats per warp), so the backward's second pass over
// D can weight every n_k row without holding them in registers; that pass
// re-reads c, x and the n_k rows, which the L1/L2 still hold from the first.
// Any B: the last block's spare warps exit (no TPU block divisibility).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // examples per 256-thread block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 48 * 1024;  // static limit without an opt-in

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;  // every lane holds the sum
}

// Stable softplus(z) = log(1 + e^z) = max(z, 0) + log1p(e^-|z|).
__device__ __forceinline__ float softplus(float z) {
  return fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)));
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

// The warp's logits for one example: returns pos (in every lane) and leaves
// negl_0..negl_{k-1} in `negl` (shared memory, visible to the whole warp).
template <typename T>
__device__ __forceinline__ float logits(const T* __restrict__ c,
                                        const T* __restrict__ x,
                                        const T* __restrict__ n, int d, int k,
                                        int lane, float* negl) {
  float p = 0.f;
  for (int j = lane; j < d; j += 32) p = fmaf(to_f32(c[j]), to_f32(x[j]), p);
  p = warp_sum(p);
  for (int q = 0; q < k; ++q) {
    const T* nq = n + (int64_t)q * d;
    float s = 0.f;
    for (int j = lane; j < d; j += 32) {
      s = fmaf(to_f32(nq[j]), to_f32(c[j]), s);
    }
    s = warp_sum(s);
    if (lane == 0) negl[q] = s;
  }
  __syncwarp();
  return p;
}

template <typename T>
__global__ void sgns_fwd(const T* __restrict__ center,
                         const T* __restrict__ ctx, const T* __restrict__ neg,
                         float* __restrict__ loss, int64_t b, int d, int k) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= b) return;  // warp-uniform
  float* negl = smem + warp * k;
  const float pos = logits(center + row * d, ctx + row * d,
                           neg + row * k * (int64_t)d, d, k, lane, negl);
  if (lane == 0) {
    float l = softplus(-pos);
    for (int q = 0; q < k; ++q) l += softplus(negl[q]);
    loss[row] = l;
  }
}

template <typename T>
__global__ void sgns_bwd(const T* __restrict__ center,
                         const T* __restrict__ ctx, const T* __restrict__ neg,
                         const float* __restrict__ dout, T* __restrict__ dc,
                         T* __restrict__ dx, T* __restrict__ dn, int64_t b,
                         int d, int k) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= b) return;  // warp-uniform
  float* w = smem + warp * k;
  const T* c = center + row * d;
  const T* x = ctx + row * d;
  const T* n = neg + row * k * (int64_t)d;
  const float pos = logits(c, x, n, d, k, lane, w);
  const float g = dout[row];
  const float dpos = (sigmoid(pos) - 1.f) * g;
  for (int q = lane; q < k; q += 32) w[q] = sigmoid(w[q]) * g;  // dneg_q
  __syncwarp();
  T* dcr = dc + row * d;
  T* dxr = dx + row * d;
  T* dnr = dn + row * k * (int64_t)d;
  for (int j = lane; j < d; j += 32) {
    const float cj = to_f32(c[j]);
    float acc = dpos * to_f32(x[j]);
    for (int q = 0; q < k; ++q) {
      const float wq = w[q];
      acc = fmaf(wq, to_f32(n[(int64_t)q * d + j]), acc);
      put(dnr + (int64_t)q * d + j, wq * cj);
    }
    put(dcr + j, acc);
    put(dxr + j, dpos * cj);
  }
}

int shape_error(long long b, int d, int k) {
  if (b < 0 || d < 0 || k < 0) return (int)cudaErrorInvalidValue;
  if ((size_t)kWarps * k * sizeof(float) > (size_t)kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (all three inputs alike). Returns the
// cudaError_t of the launch.
extern "C" int sgns_fwd_launch(const void* center, const void* ctx,
                               const void* neg, void* loss, long long b, int d,
                               int k, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (int e = shape_error(b, d, k)) return e;
  if (b == 0) return 0;
  const dim3 grid((unsigned)((b + kWarps - 1) / kWarps));
  const dim3 block(32 * kWarps);
  const size_t smem = (size_t)kWarps * k * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(loss);
  if (dtype == 0) {
    sgns_fwd<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(center), static_cast<const float*>(ctx),
        static_cast<const float*>(neg), l, b, d, k);
  } else if (dtype == 1) {
    sgns_fwd<__nv_bfloat16><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(center),
        static_cast<const __nv_bfloat16*>(ctx),
        static_cast<const __nv_bfloat16*>(neg), l, b, d, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int sgns_bwd_launch(const void* center, const void* ctx,
                               const void* neg, const void* dout, void* dc,
                               void* dx, void* dn, long long b, int d, int k,
                               int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (int e = shape_error(b, d, k)) return e;
  if (b == 0) return 0;
  const dim3 grid((unsigned)((b + kWarps - 1) / kWarps));
  const dim3 block(32 * kWarps);
  const size_t smem = (size_t)kWarps * k * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(dout);
  if (dtype == 0) {
    sgns_bwd<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(center), static_cast<const float*>(ctx),
        static_cast<const float*>(neg), g, static_cast<float*>(dc),
        static_cast<float*>(dx), static_cast<float*>(dn), b, d, k);
  } else if (dtype == 1) {
    sgns_bwd<__nv_bfloat16><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(center),
        static_cast<const __nv_bfloat16*>(ctx),
        static_cast<const __nv_bfloat16*>(neg), g,
        static_cast<__nv_bfloat16*>(dc), static_cast<__nv_bfloat16*>(dx),
        static_cast<__nv_bfloat16*>(dn), b, d, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
