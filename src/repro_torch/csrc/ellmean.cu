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
// Design, two paths, both deterministic (fixed summation order, no atomics):
// * Many rows (the warp-per-row kernels): one warp per destination row,
//   8 rows to a block. The warp reads 32 (idx, valid) slots at a time, one
//   per lane, and walks the set bits of the ballot of `valid`, so invalid
//   slots cost nothing and there is no left-pack pass (the TPU path's
//   argsort). For each valid neighbour the lanes span D, with 16-byte
//   float4 loads for fp32 rows whose width is a multiple of 4 and scalar
//   loads otherwise. The TPU kernel's double-buffered per-row DMA becomes
//   many resident warps hiding each other's gather latency.
// * Few long rows (the row-split kernel): one 256-thread block per row.
//   In passes of 2,048 slots, each of the 8 warps loads the (idx, valid)
//   slots of its 256 at once and lists the valid ones in shared memory
//   (ballot and prefix count, in slot order). Then the pass's entries are
//   dealt to the warps in turn, lanes across D, each warp loading up to 4
//   neighbour rows at once: the few valid entries of a flush row, which
//   sit at its start, are gathered by all 8 warps and not by the one whose
//   slots hold them. Each warp adds its entries in list order; the warps'
//   partial sums are added in warp order through shared memory.
// * The rule (`row_split`): the warp-per-row kernels start ceil(N / 8)
//   blocks. When that is fewer blocks than the card has SMs, and a row has
//   at least one 32-slot group for each of the 8 warps (L >= 256), the
//   row-split kernel runs instead: its 8 N warps then fit the card in about
//   one wave, where the warp-per-row kernels would leave SMs idle and walk
//   every row's L / 32 groups one after another. Otherwise the
//   warp-per-row kernels run.

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

// Few long rows: one block per row. VEC: fp32 rows whose width is a
// multiple of 4, read as float4 units; else one element a unit. STRIP:
// units per lane per pass over the row (1 for rows of up to 32 units, to
// keep the registers few, else 4).
template <typename T, bool VEC, int STRIP>
__global__ void __launch_bounds__(32 * kWarps)
    ell_mean_rows(const int32_t* __restrict__ idx,
                  const uint8_t* __restrict__ valid,
                  const T* __restrict__ emb, T* __restrict__ out, int l,
                  int d) {
  constexpr int W = VEC ? 4 : 1;      // elements per unit
  constexpr int kUnits = 32 * STRIP;  // units per strip
  constexpr int kBatch = 8;           // 32-slot groups a warp scans at once
  constexpr int kRun = 32 * kBatch;   // slots a warp scans per pass
  constexpr int kGather = 4;          // neighbour rows a warp loads at once
  __shared__ int32_t list[kWarps][kRun];  // a pass's valid neighbours
  __shared__ int list_n[kWarps];
  __shared__ float part[kWarps][kUnits * W];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int64_t row = blockIdx.x;
  const int32_t* ri = idx + row * l;
  const uint8_t* rv = valid + row * l;
  const int du = d / W;
  for (int c0 = 0; c0 < du; c0 += kUnits) {
    float acc[STRIP][W];
#pragma unroll
    for (int u = 0; u < STRIP; ++u) {
#pragma unroll
      for (int w = 0; w < W; ++w) acc[u][w] = 0.f;
    }
    int total = 0;
    for (int p0 = 0; p0 < l; p0 += kWarps * kRun) {
      // scan: warp w lists the valid slots of its run, in slot order
      const int j0 = p0 + warp * kRun;
      bool ok[kBatch];
      int32_t my[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {  // all loads issued before any use
        const int j = j0 + 32 * b + lane;
        const bool in = j < l;
        ok[b] = in ? rv[j] != 0 : false;
        my[b] = in ? ri[j] : 0;
      }
      int n = 0;
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const unsigned mask = __ballot_sync(kFull, ok[b]);
        if (ok[b]) list[warp][n + __popc(mask & below)] = my[b];
        n += __popc(mask);
      }
      if (lane == 0) list_n[warp] = n;
      __syncthreads();
      // gather: entry e of the lists, taken in warp order, goes to warp
      // e % 8, which loads up to kGather rows at once and adds them in order
      int off[kWarps + 1];
      off[0] = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) off[w + 1] = off[w] + list_n[w];
      const int np = off[kWarps];
      for (int e0 = warp; e0 < np; e0 += kWarps * kGather) {
        int32_t src[kGather];
        bool has[kGather];
#pragma unroll
        for (int h = 0; h < kGather; ++h) {
          const int e = e0 + h * kWarps;
          has[h] = e < np;  // warp-uniform
          src[h] = 0;
          if (has[h]) {  // its list: compile-time indices into off[]
            int w = 0, first = 0;
#pragma unroll
            for (int x = 1; x < kWarps; ++x) {
              if (e >= off[x]) {
                w = x;
                first = off[x];
              }
            }
            src[h] = list[w][e - first];
          }
        }
        float val[kGather][STRIP][W];
#pragma unroll
        for (int h = 0; h < kGather; ++h) {
#pragma unroll
          for (int u = 0; u < STRIP; ++u) {
            const int c = c0 + u * 32 + lane;
            if (has[h] && c < du) {
              if constexpr (VEC) {
                const float4 x = __ldg(reinterpret_cast<const float4*>(
                                           emb + (int64_t)src[h] * d) +
                                       c);
                val[h][u][0] = x.x;
                val[h][u][1] = x.y;
                val[h][u][2] = x.z;
                val[h][u][3] = x.w;
              } else {
                val[h][u][0] = to_f32(emb[(int64_t)src[h] * d + c]);
              }
            } else {
#pragma unroll
              for (int w = 0; w < W; ++w) val[h][u][w] = 0.f;
            }
          }
        }
#pragma unroll
        for (int h = 0; h < kGather; ++h) {
          if (has[h]) {
#pragma unroll
            for (int u = 0; u < STRIP; ++u) {
#pragma unroll
              for (int w = 0; w < W; ++w) acc[u][w] += val[h][u][w];
            }
          }
        }
      }
      total += np;
      __syncthreads();  // the lists are rewritten by the next pass
    }
#pragma unroll
    for (int u = 0; u < STRIP; ++u) {
#pragma unroll
      for (int w = 0; w < W; ++w) {
        part[warp][(u * 32 + lane) * W + w] = acc[u][w];
      }
    }
    __syncthreads();
    const float denom = fmaxf((float)total, 1.f);
    const int ne = min(kUnits, du - c0) * W;
    for (int e = threadIdx.x; e < ne; e += 32 * kWarps) {
      float a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += part[w][e];
      put(out + row * d + (int64_t)c0 * W + e, a / denom);
    }
    __syncthreads();  // part is rewritten by the next strip
  }
}

// The path rule (see the header): true for the row-split kernel.
bool row_split(long long n, int l, int sms) {
  return (n + kWarps - 1) / kWarps < sms && l >= 32 * kWarps;
}

template <typename T, bool VEC>
void launch_rows(const int32_t* i, const uint8_t* v, const T* e, T* o,
                 long long n, int l, int d, cudaStream_t s) {
  const int du = VEC ? d / 4 : d;
  const dim3 grid((unsigned)n);
  const dim3 block(32 * kWarps);
  if (du <= 32) {
    ell_mean_rows<T, VEC, 1><<<grid, block, 0, s>>>(i, v, e, o, l, d);
  } else {
    ell_mean_rows<T, VEC, 4><<<grid, block, 0, s>>>(i, v, e, o, l, d);
  }
}

int sm_count(int device, int* sms) {
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     device);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the launch.
extern "C" int ell_mean_launch(const void* idx, const void* valid,
                               const void* emb, void* out, long long n, int l,
                               int d, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (n <= 0 || d <= 0) return 0;
  int sms = 0;
  const int bad = sm_count(device, &sms);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  if (row_split(n, l, sms)) {
    if (dtype == 0 && d % 4 == 0) {
      launch_rows<float, true>(i, v, static_cast<const float*>(emb),
                               static_cast<float*>(out), n, l, d, s);
    } else if (dtype == 0) {
      launch_rows<float, false>(i, v, static_cast<const float*>(emb),
                                static_cast<float*>(out), n, l, d, s);
    } else {
      launch_rows<__nv_bfloat16, false>(
          i, v, static_cast<const __nv_bfloat16*>(emb),
          static_cast<__nv_bfloat16*>(out), n, l, d, s);
    }
    return (int)cudaGetLastError();
  }
  const dim3 grid((unsigned)((n + kWarps - 1) / kWarps));
  const dim3 block(32 * kWarps);
  if (dtype == 0 && d % 4 == 0) {
    ell_mean_f32x4<<<grid, block, 0, s>>>(
        i, v, static_cast<const float*>(emb), static_cast<float*>(out), n, l, d);
  } else if (dtype == 0) {
    ell_mean_scalar<float><<<grid, block, 0, s>>>(
        i, v, static_cast<const float*>(emb), static_cast<float*>(out), n, l, d);
  } else {
    ell_mean_scalar<__nv_bfloat16><<<grid, block, 0, s>>>(
        i, v, static_cast<const __nv_bfloat16*>(emb),
        static_cast<__nv_bfloat16*>(out), n, l, d);
  }
  return (int)cudaGetLastError();
}

// 1 if a launch with these sizes takes the row-split kernel, 0 if the
// warp-per-row kernels (written to *path); launches nothing.
extern "C" int ell_mean_path(long long n, int l, int device, int* path) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  const int bad = sm_count(device, &sms);
  if (bad) return bad;
  *path = n > 0 && row_split(n, l, sms) ? 1 : 0;
  return 0;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
