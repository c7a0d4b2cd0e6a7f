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
// forward, as in the JAX package's custom_vjp. Any B, D and K: no shared
// memory holds per-K state.
//
// What bounds it on the H100: memory. Each example is one GEMV of K + 1
// rows of width D against c (2 FLOP per element read), far below the
// ~20 FLOP/byte the card needs before fp32 FFMA, let alone the tensor cores,
// is the limit. The forward reads (2 + K) B D elements and writes B floats;
// the backward reads (2 + K) B D elements plus dout (B floats) and writes
// (2 + K) B D.
//
// Forward: one warp per example, eight examples per 256-thread block; lanes
// stride D (D = 150 at the paper's width is not a multiple of 32), with
// fp32 FFMA and a butterfly shuffle reduction per dot. Every lane adds
// softplus(negl_q) to the loss as each dot is reduced, in the order
// q = 0..K-1, so any K needs no shared memory.
//
// Backward. The first design (a warp per example, as the forward) was
// latency-bound at 2.4x its byte bound: its K + 1 dots ran one after the
// other, each a chain of scalar loads strided over D and a 5-step
// butterfly, and a second pass re-read c, x and every n_k (from L1/L2) to
// form the gradients. The whole batch fit about one wave, so the kernel
// took one warp's chain. This design:
//
// * One pass over each example, each input element read from memory once
//   and each output element written once. A lane group holds its
//   example's c, and x only until pos = <c, x> is known, in registers;
//   dx = dpos c is written, and dc starts as dpos x. The negatives come in
//   chunks of kChunk rows (a runtime tail, so any K): the chunk's rows are
//   loaded, their dots with c formed and reduced, and for each q in order
//   dn_q = dneg_q c is written and dc += dneg_q n_q accumulated in
//   registers. dc is then written. No atomics: a second call gives the
//   same bits. dc is summed in the order q = 0..K-1 from dpos x, each add
//   compensated (Kahan): a plain fp32 running sum drifts by about sqrt(K)
//   ulps of its partial sums (at K = 2,048 an uncompensated dc element of
//   0.1 came out 1.4e-5 off the plain version on an H100), which the
//   compensation removes for any K. dx and dn move only by the logits,
//   whose fp32 sums now run in another order (ulps).
// * Several examples to a warp. A lane group of G in {8, 16, 32} lanes
//   takes an example: the smallest G at which a lane holds at most 12
//   elements of a row (D = 150 fp32: G = 16, 10 elements; D = 256: G =
//   32). A lane holds the vectors j = l, l + G, l + 2G, ... of the row
//   (consecutive lanes on consecutive vectors: coalesced). Rows up to
//   32 x 32 = 1024 elements wide that need G = 32 and more than 12 elements
//   a lane take a variant that holds 32; wider rows take the fallback below.
// * Every load of an example (c, x, dout), or of a chunk (its kChunk rows),
//   is issued before its first reduction, and the kChunk butterflies of a
//   chunk are interleaved step by step, so their chains overlap.
// * Vector loads and stores where the pointers and D allow: 16 bytes (4
//   fp32 or 8 bf16) when D is a multiple of that many elements, else 8
//   bytes, else 4 bytes (bf16), else one element.
// * A persistent grid, sized from the kernel's occupancy on the card,
//   strides over the examples, so every resident block stays busy to the
//   end of the batch.
// * Fallback for D > 1024: a warp per example, lanes striding D; the K
//   dneg values go to a (B, K) fp32 scratch in device memory (the wrapper
//   allocates it), then one pass over D forms dc, dx and dn, re-reading
//   c and the n_k rows from the L1/L2.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // examples per forward block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxDevices = 64;
constexpr int kLaneElems = 12;  // elements of a row a lane holds, at most
constexpr int kWideElems = 32;  // ... in the variant for rows up to 1024
constexpr int kMaxRegWidth = 32 * kWideElems;  // wider: the fallback
// negative rows loaded together: with the compensated dc, 2 took 0.1729 ms
// at B=65536 K=5 D=256 bf16 against 0.1886 for 4 and 0.1840 for 8 (their
// registers), and all three 0.029-0.032 ms at B=8192 K=5 D=150 fp32 (H100)
constexpr int kChunk = 2;

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

// dc's running sum over q, compensated (Kahan): acc += w n with the
// rounding error of each add carried in err, so the error of dc does not
// grow with K.
__device__ __forceinline__ void kahan_fma(float w, float n, float& acc,
                                          float& err) {
  const float y = fmaf(w, n, -err);
  const float t = acc + y;
  err = (t - acc) - y;
  acc = t;
}

// One vector of V elements of T at p (V * sizeof(T) bytes, aligned to
// that) to or from fp32 registers.
template <typename T, int V>
struct Io;

template <int V>
struct Io<float, V> {
  static __device__ __forceinline__ void load(const float* p, float* f) {
    if constexpr (V == 4) {
      const float4 u = *reinterpret_cast<const float4*>(p);
      f[0] = u.x, f[1] = u.y, f[2] = u.z, f[3] = u.w;
    } else if constexpr (V == 2) {
      const float2 u = *reinterpret_cast<const float2*>(p);
      f[0] = u.x, f[1] = u.y;
    } else {
      f[0] = *p;
    }
  }
  static __device__ __forceinline__ void store(float* p, const float* f) {
    if constexpr (V == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
    } else {
      *p = f[0];
    }
  }
};

// bf16: two elements to a 32-bit word, the lower address in the low half.
__device__ __forceinline__ void unpack2(unsigned w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned pack2(const float* f) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16(f[0])) |
         (unsigned)__bfloat16_as_ushort(__float2bfloat16(f[1])) << 16;
}

template <int V>
struct Io<__nv_bfloat16, V> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    if constexpr (V == 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      unpack2(u.x, f), unpack2(u.y, f + 2), unpack2(u.z, f + 4),
          unpack2(u.w, f + 6);
    } else if constexpr (V == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      unpack2(u.x, f), unpack2(u.y, f + 2);
    } else if constexpr (V == 2) {
      unpack2(*reinterpret_cast<const unsigned*>(p), f);
    } else {
      f[0] = __bfloat162float(*p);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* f) {
    if constexpr (V == 8) {
      *reinterpret_cast<uint4*>(p) =
          make_uint4(pack2(f), pack2(f + 2), pack2(f + 4), pack2(f + 6));
    } else if constexpr (V == 4) {
      *reinterpret_cast<uint2*>(p) = make_uint2(pack2(f), pack2(f + 2));
    } else if constexpr (V == 2) {
      *reinterpret_cast<unsigned*>(p) = pack2(f);
    } else {
      *p = __float2bfloat16(f[0]);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    sgns_fwd(const T* __restrict__ center, const T* __restrict__ ctx,
             const T* __restrict__ neg, float* __restrict__ loss, int64_t b,
             int d, int k) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= b) return;  // warp-uniform
  const T* c = center + row * d;
  const T* x = ctx + row * d;
  const T* n = neg + row * k * (int64_t)d;
  float p = 0.f;
  for (int j = lane; j < d; j += 32) p = fmaf(to_f32(c[j]), to_f32(x[j]), p);
  float l = softplus(-warp_sum(p));
  for (int q = 0; q < k; ++q) {
    const T* nq = n + (int64_t)q * d;
    float s = 0.f;
    for (int j = lane; j < d; j += 32) {
      s = fmaf(to_f32(nq[j]), to_f32(c[j]), s);
    }
    l += softplus(warp_sum(s));  // every lane: the same sum, in q order
  }
  if (lane == 0) loss[row] = l;
}

// The backward, rows of up to 32 x kElems elements. T: the element type;
// V: elements a vector access moves; kElems: elements of a row a lane holds
// at most (kElems / V vectors). A group of G = 1 << g_log2 lanes takes an
// example; d % V == 0 and every pointer is aligned to V elements.
template <typename T, int V, int kElems>
__global__ void __launch_bounds__(kThreads)
    sgns_bwd(const T* __restrict__ center, const T* __restrict__ ctx,
             const T* __restrict__ neg, const float* __restrict__ dout,
             T* __restrict__ dc, T* __restrict__ dx, T* __restrict__ dn,
             int64_t b, int d, int k, int g_log2) {
  constexpr int kVecs = kElems / V > 0 ? kElems / V : 1;
  using IO = Io<T, V>;
  const int lane = threadIdx.x & 31;
  const int group_lanes = 1 << g_log2;
  const int sub = lane & (group_lanes - 1);
  const int per_warp = 32 >> g_log2;  // examples a warp takes at once
  const int nvec = d / V;
  const int64_t warp = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int64_t stride = (int64_t)gridDim.x * kWarps * per_warp;
  // every lane of a warp runs the same iterations (the shuffles need the
  // whole warp); a group past the batch's end loads and stores nothing
  for (int64_t first = warp * per_warp; first < b; first += stride) {
    const int64_t row = first + (lane >> g_log2);
    const bool live = row < b;
    float c[kVecs][V], acc[kVecs][V];  // acc holds x, then dc
    float err[kVecs][V];  // dc's compensation
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int v = sub + i * group_lanes;
      if (live && v < nvec) {
        IO::load(center + row * d + v * V, c[i]);
        IO::load(ctx + row * d + v * V, acc[i]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) c[i][e] = acc[i][e] = 0.f;
      }
    }
    const float g = live ? dout[row] : 0.f;
    float pos = 0.f;
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
#pragma unroll
      for (int e = 0; e < V; ++e) pos = fmaf(c[i][e], acc[i][e], pos);
    for (int o = group_lanes >> 1; o > 0; o >>= 1)
      pos += __shfl_xor_sync(kFull, pos, o);
    const float dpos = (sigmoid(pos) - 1.f) * g;
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int v = sub + i * group_lanes;
      float o[V];
#pragma unroll
      for (int e = 0; e < V; ++e) {
        o[e] = dpos * c[i][e];
        acc[i][e] = dpos * acc[i][e];
        err[i][e] = 0.f;
      }
      if (live && v < nvec) IO::store(dx + row * d + v * V, o);
    }
    const T* nrow = neg + row * k * (int64_t)d;
    T* dnrow = dn + row * k * (int64_t)d;
    for (int q0 = 0; q0 < k; q0 += kChunk) {
      float nv[kChunk][kVecs][V];
#pragma unroll
      for (int u = 0; u < kChunk; ++u)
#pragma unroll
        for (int i = 0; i < kVecs; ++i) {
          const int v = sub + i * group_lanes;
          if (live && q0 + u < k && v < nvec) {
            IO::load(nrow + (int64_t)(q0 + u) * d + v * V, nv[u][i]);
          } else {
#pragma unroll
            for (int e = 0; e < V; ++e) nv[u][i][e] = 0.f;
          }
        }
      float s[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        s[u] = 0.f;
#pragma unroll
        for (int i = 0; i < kVecs; ++i)
#pragma unroll
          for (int e = 0; e < V; ++e) s[u] = fmaf(nv[u][i][e], c[i][e], s[u]);
      }
      for (int o = group_lanes >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int u = 0; u < kChunk; ++u)
          s[u] += __shfl_xor_sync(kFull, s[u], o);
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        if (q0 + u >= k) break;  // the chunk's tail (uniform)
        const float w = sigmoid(s[u]) * g;  // dneg_q
#pragma unroll
        for (int i = 0; i < kVecs; ++i) {
          const int v = sub + i * group_lanes;
          float o[V];
#pragma unroll
          for (int e = 0; e < V; ++e) {
            o[e] = w * c[i][e];
            kahan_fma(w, nv[u][i][e], acc[i][e], err[i][e]);
          }
          if (live && v < nvec)
            IO::store(dnrow + (int64_t)(q0 + u) * d + v * V, o);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int v = sub + i * group_lanes;
      if (live && v < nvec) IO::store(dc + row * d + v * V, acc[i]);
    }
  }
}

// The backward for rows wider than kMaxRegWidth: a warp per example, the
// dneg values through the (B, K) fp32 scratch `w`.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    sgns_bwd_wide(const T* __restrict__ center, const T* __restrict__ ctx,
                  const T* __restrict__ neg, const float* __restrict__ dout,
                  T* __restrict__ dc, T* __restrict__ dx, T* __restrict__ dn,
                  float* __restrict__ scratch, int64_t b, int d, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kWarps;
  for (int64_t row = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       row < b; row += stride) {  // warp-uniform
    const T* c = center + row * d;
    const T* x = ctx + row * d;
    const T* n = neg + row * k * (int64_t)d;
    float* w = scratch + row * k;
    const float g = dout[row];
    float p = 0.f;
    for (int j = lane; j < d; j += 32)
      p = fmaf(to_f32(c[j]), to_f32(x[j]), p);
    const float dpos = (sigmoid(warp_sum(p)) - 1.f) * g;
    for (int q = 0; q < k; ++q) {
      const T* nq = n + (int64_t)q * d;
      float s = 0.f;
      for (int j = lane; j < d; j += 32)
        s = fmaf(to_f32(nq[j]), to_f32(c[j]), s);
      s = warp_sum(s);
      if (lane == 0) w[q] = sigmoid(s) * g;
    }
    __syncwarp();  // w[] written by lane 0 is visible to the warp
    T* dcr = dc + row * d;
    T* dxr = dx + row * d;
    T* dnr = dn + row * k * (int64_t)d;
    for (int j = lane; j < d; j += 32) {
      const float cj = to_f32(c[j]);
      float acc = dpos * to_f32(x[j]), err = 0.f;
      for (int q = 0; q < k; ++q) {
        const float wq = w[q];
        kahan_fma(wq, to_f32(n[(int64_t)q * d + j]), acc, err);
        put(dnr + (int64_t)q * d + j, wq * cj);
      }
      put(dcr + j, acc);
      put(dxr + j, dpos * cj);
    }
  }
}

// Resident blocks (occupancy x SMs) of `kern` on `device`.
template <typename K>
cudaError_t resident(K kern, int device, int* out) {
  int per_sm = 0, sms = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  return cudaSuccess;
}

// Blocks for `work` units of kThreads threads, at most the resident ones
// (kept per device for each kernel instantiation by the caller's static).
template <typename K>
cudaError_t grid_for(K kern, int device, int* cache, int64_t work,
                     unsigned* blocks) {
  if (!cache[device]) {
    cudaError_t err = resident(kern, device, &cache[device]);
    if (err != cudaSuccess) return err;
  }
  *blocks = (unsigned)(work < cache[device] ? work : cache[device]);
  return cudaSuccess;
}

struct BwdArgs {
  const void *center, *ctx, *neg;
  const float* dout;
  void *dc, *dx, *dn;
  int64_t b;
  int d, k, device;
  cudaStream_t stream;
};

template <typename T, int V, int kElems>
cudaError_t launch_bwd(const BwdArgs& a, int g_log2) {
  static int cache[kMaxDevices];
  auto kern = sgns_bwd<T, V, kElems>;
  const int64_t per_block = (int64_t)kWarps * (32 >> g_log2);
  unsigned blocks = 0;
  cudaError_t err = grid_for(kern, a.device, cache,
                             (a.b + per_block - 1) / per_block, &blocks);
  if (err != cudaSuccess) return err;
  kern<<<blocks, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.center), static_cast<const T*>(a.ctx),
      static_cast<const T*>(a.neg), a.dout, static_cast<T*>(a.dc),
      static_cast<T*>(a.dx), static_cast<T*>(a.dn), a.b, a.d, a.k, g_log2);
  return cudaGetLastError();
}

// The lane-group rule: the smallest G in {8, 16, 32} at which a lane holds
// at most kLaneElems elements of a row, else G = 32 with up to kWideElems.
template <typename T, int V>
cudaError_t dispatch_bwd(const BwdArgs& a) {
  const int nvec = a.d / V;
  for (int g_log2 = 3; g_log2 <= 5; ++g_log2) {
    const int per_lane = ((nvec + (1 << g_log2) - 1) >> g_log2) * V;
    if (per_lane <= kLaneElems)
      return launch_bwd<T, V, kLaneElems>(a, g_log2);
  }
  return launch_bwd<T, V, kWideElems>(a, 5);
}

// Elements a vector access moves: the widest of 16, 8, 4 (bf16) bytes that
// divides D and aligns every row pointer.
template <typename T>
cudaError_t dispatch_vec(const BwdArgs& a) {
  const uintptr_t addr =
      reinterpret_cast<uintptr_t>(a.center) |
      reinterpret_cast<uintptr_t>(a.ctx) | reinterpret_cast<uintptr_t>(a.neg) |
      reinterpret_cast<uintptr_t>(a.dc) | reinterpret_cast<uintptr_t>(a.dx) |
      reinterpret_cast<uintptr_t>(a.dn);
  constexpr int es = sizeof(T);
  auto fits = [&](int bytes) {
    return a.d % (bytes / es) == 0 && addr % bytes == 0;
  };
  if (fits(16)) return dispatch_bwd<T, 16 / es>(a);
  if (fits(8)) return dispatch_bwd<T, 8 / es>(a);
  if constexpr (es == 2) {
    if (fits(4)) return dispatch_bwd<T, 2>(a);
  }
  return dispatch_bwd<T, 1>(a);
}

template <typename T>
cudaError_t launch_bwd_wide(const BwdArgs& a, float* scratch) {
  static int cache[kMaxDevices];
  auto kern = sgns_bwd_wide<T>;
  unsigned blocks = 0;
  cudaError_t err =
      grid_for(kern, a.device, cache, (a.b + kWarps - 1) / kWarps, &blocks);
  if (err != cudaSuccess) return err;
  kern<<<blocks, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.center), static_cast<const T*>(a.ctx),
      static_cast<const T*>(a.neg), a.dout, static_cast<T*>(a.dc),
      static_cast<T*>(a.dx), static_cast<T*>(a.dn), scratch, a.b, a.d, a.k);
  return cudaGetLastError();
}

int shape_error(long long b, int d, int k, int device) {
  if (b < 0 || d < 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// The widest row the backward keeps in registers; wider rows need the
// (B, K) fp32 scratch of sgns_bwd_launch.
extern "C" int sgns_bwd_max_reg_width() { return kMaxRegWidth; }

// dtype: 0 = float32, 1 = bfloat16 (all three inputs alike). Returns the
// cudaError_t of the launch.
extern "C" int sgns_fwd_launch(const void* center, const void* ctx,
                               const void* neg, void* loss, long long b, int d,
                               int k, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (int e = shape_error(b, d, k, device)) return e;
  if (b == 0) return 0;
  const dim3 grid((unsigned)((b + kWarps - 1) / kWarps));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(loss);
  if (dtype == 0) {
    sgns_fwd<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(center), static_cast<const float*>(ctx),
        static_cast<const float*>(neg), l, b, d, k);
  } else if (dtype == 1) {
    sgns_fwd<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(center),
        static_cast<const __nv_bfloat16*>(ctx),
        static_cast<const __nv_bfloat16*>(neg), l, b, d, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// scratch: B x K floats when d > sgns_bwd_max_reg_width(), else unused.
extern "C" int sgns_bwd_launch(const void* center, const void* ctx,
                               const void* neg, const void* dout, void* dc,
                               void* dx, void* dn, void* scratch, long long b,
                               int d, int k, int dtype, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (int e = shape_error(b, d, k, device)) return e;
  if (b == 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const BwdArgs a{center, ctx, neg, static_cast<const float*>(dout),
                  dc, dx, dn, b, d, k, device,
                  static_cast<cudaStream_t>(stream)};
  if (d > kMaxRegWidth) {
    if (scratch == nullptr && k > 0) return (int)cudaErrorInvalidValue;
    float* w = static_cast<float*>(scratch);
    err = dtype == 0 ? launch_bwd_wide<float>(a, w)
                     : launch_bwd_wide<__nv_bfloat16>(a, w);
  } else {
    err = dtype == 0 ? dispatch_vec<float>(a) : dispatch_vec<__nv_bfloat16>(a);
  }
  return (int)err;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
