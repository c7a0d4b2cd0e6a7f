// Single-token GQA decode attention (flash-decode) for Hopper (sm_90a),
// hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_decode_kernel` / `decode_attention_pallas`
// (src/repro/kernels/flash_decode.py). For batch row b and query head h,
// with G = H / Hkv and cache head c = h / G:
//   logit_s = (q[b, h] . k[b, s, c]) / sqrt(Dh), then
//             softcap * tanh(logit_s / softcap) when softcap > 0,
//   out[b, h] = sum_s softmax(logit)_s v[b, s, c]
// over the visible positions win_lo[b] <= s < min(len[b], S). The loop stops
// at S even when a length runs past it (a finished row that keeps decoding
// has its writes dropped; its length still grows). Accumulation is fp32
// whatever the cache type; an int8 cache is dequantised with its per-
// (b, s, c) fp32 scales as each row is read; the output has q's type. A row
// with no visible position returns 0, as the Pallas kernel does.
//
// What bounds it on the H100: memory. Each cache row is read once and used
// for G dot products and G axpys of width Dh: 4 G Dh FLOP per 2 Dh elements,
// 2-4 FLOP per byte in bf16 at the repo's G, far below what would make the
// FP32 units the limit. The bound is the bytes of the visible K and V rows.
//
// Design (simple, exact; a first version): one 256-thread block per
// (b, c, tile of up to 8 query rows; 4 when Dh = 256). It reads the cache in
// its own (B, S, Hkv, Dh) layout (the TPU wrapper swaps axes to
// (B, Hkv, S, Dh), a copy of the cache in XLA; here positions are simply a
// stride of Hkv * Dh apart). Lanes split Dh (Dh / 32 consecutive elements
// each, read as one vector load); the 8 warps stride over the visible
// positions, 4 positions per warp per iteration so that 8 row loads are in
// flight per warp; each warp keeps an online softmax (max, sum, fp32
// accumulator) for each of its query rows, the dot products reduced by a
// butterfly shuffle. The warps are combined once at the end through shared
// memory. Left on the table: at B = 8, Hkv = 8 only 64 blocks start on 132
// SMs, and each SM has 8 warps of loads in flight, so the kernel cannot
// reach the card's memory rate; splitting S across blocks with a combine
// pass (flash-decoding), TMA loads into a ring of shared-memory stages, and
// tensor-core dot products for large G are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;  // positions per warp per iteration
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1.0e30f;  // the masked logit of the Pallas kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
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

template <int B> struct Chunk;  // the widest load that fits B bytes
template <> struct Chunk<1> { using type = uint8_t; };
template <> struct Chunk<2> { using type = uint16_t; };
template <> struct Chunk<4> { using type = uint32_t; };
template <> struct Chunk<8> { using type = uint2; };
template <> struct Chunk<16> { using type = uint4; };

// N consecutive elements at p as floats; p is aligned to min(16, N * size)
// bytes (the wrapper checks 16-byte base pointers and Dh % 32 == 0).
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[N]) {
  constexpr int kBytes = static_cast<int>(sizeof(T)) * N;
  constexpr int kWidth = kBytes < 16 ? kBytes : 16;
  static_assert(kBytes % kWidth == 0, "row slice must split into loads");
  using C = typename Chunk<kWidth>::type;
  C raw[kBytes / kWidth];
#pragma unroll
  for (int i = 0; i < kBytes / kWidth; ++i) {
    raw[i] = reinterpret_cast<const C*>(p)[i];
  }
  const T* e = reinterpret_cast<const T*>(raw);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
}

// TQ: type of q and out; TKV: type of the cache; DPL = Dh / 32 elements per
// lane; GT: query rows per block; QUANT: int8 cache with fp32 scales.
template <typename TQ, typename TKV, int DPL, int GT, bool QUANT>
__global__ void __launch_bounds__(kThreads)
    flash_decode(const TQ* __restrict__ q, const TKV* __restrict__ k,
                 const TKV* __restrict__ v, const float* __restrict__ ks,
                 const float* __restrict__ vs, const int* __restrict__ lens,
                 const int* __restrict__ los, TQ* __restrict__ out, int S,
                 int H, int Hkv, float scale, float softcap) {
  constexpr int Dh = 32 * DPL;
  __shared__ float sm_acc[kWarps][Dh];
  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x / Hkv;
  const int c = blockIdx.x % Hkv;
  const int G = H / Hkv;
  const int g0 = blockIdx.y * GT;
  const int gn = min(GT, G - g0);  // block-uniform
  const int end = min(lens[b], S);
  const int start = max(los[b], 0);
  const int64_t head0 = (int64_t)b * H + (int64_t)c * G + g0;

  float qr[GT][DPL], acc[GT][DPL], m[GT], l[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < gn) {
      load_vec(q + (head0 + g) * Dh + lane * DPL, qr[g]);
    } else {
#pragma unroll
      for (int i = 0; i < DPL; ++i) qr[g][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
    m[g] = kNegInf;
    l[g] = 0.f;
  }

  const int64_t step = (int64_t)Hkv * Dh;  // elements between positions
  const int64_t base = ((int64_t)b * S * Hkv + c) * Dh + lane * DPL;
  const TKV* kb = k + base;
  const TKV* vb = v + base;
  const int64_t sbase = (int64_t)b * S * Hkv + c;

  for (int s0 = start + warp * kUnroll; s0 < end; s0 += kWarps * kUnroll) {
    float kr[kUnroll][DPL], vr[kUnroll][DPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u;
      if (s < end) {
        load_vec(kb + s * step, kr[u]);
        load_vec(vb + s * step, vr[u]);
        if constexpr (QUANT) {
          const float a = ks[sbase + (int64_t)s * Hkv];
          const float z = vs[sbase + (int64_t)s * Hkv];
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            kr[u][i] *= a;
            vr[u][i] *= z;
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) kr[u][i] = vr[u][i] = 0.f;
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g < gn) {
        float logit[kUnroll];
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float d = 0.f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) d = fmaf(qr[g][i], kr[u][i], d);
          d = warp_sum(d) * scale;
          if (softcap > 0.f) d = softcap * tanhf(d / softcap);
          logit[u] = s0 + u < end ? d : kNegInf;
          mx = fmaxf(mx, logit[u]);
        }
        const float alpha = expf(m[g] - mx);
        float p[kUnroll];
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          p[u] = s0 + u < end ? expf(logit[u] - mx) : 0.f;
          psum += p[u];
        }
        l[g] = l[g] * alpha + psum;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          float a = acc[g][i] * alpha;
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) a = fmaf(p[u], vr[u][i], a);
          acc[g][i] = a;
        }
        m[g] = mx;
      }
    }
  }

  // combine the warps' partial softmaxes, one query row at a time
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < gn) {
#pragma unroll
      for (int i = 0; i < DPL; ++i) sm_acc[warp][lane * DPL + i] = acc[g][i];
      if (lane == 0) {
        sm_m[warp] = m[g];
        sm_l[warp] = l[g];
      }
      __syncthreads();
      if (threadIdx.x < Dh) {
        float mx = kNegInf;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
        float tot = 0.f, a = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          const float f = expf(sm_m[w] - mx);
          tot = fmaf(sm_l[w], f, tot);
          a = fmaf(sm_acc[w][threadIdx.x], f, a);
        }
        put(out + (head0 + g) * Dh + threadIdx.x, a / fmaxf(tot, 1e-30f));
      }
      __syncthreads();
    }
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const int* lens;
  const int* los;
  void* out;
  int S, H, Hkv;
  float scale, softcap;
};

template <typename TQ, typename TKV, int DPL, bool QUANT>
void launch_dpl(const Args& a, int B, cudaStream_t s) {
  constexpr int GT = DPL == 8 ? 4 : 8;  // registers: Dh = 256 holds 4 rows
  const int G = a.H / a.Hkv;
  const dim3 grid((unsigned)(B * a.Hkv), (unsigned)((G + GT - 1) / GT));
  flash_decode<TQ, TKV, DPL, GT, QUANT><<<grid, kThreads, 0, s>>>(
      static_cast<const TQ*>(a.q), static_cast<const TKV*>(a.k),
      static_cast<const TKV*>(a.v), a.ks, a.vs, a.lens, a.los,
      static_cast<TQ*>(a.out), a.S, a.H, a.Hkv, a.scale, a.softcap);
}

template <typename TQ, typename TKV, bool QUANT>
int launch_typed(const Args& a, int B, int dh, cudaStream_t s) {
  switch (dh) {
    case 32: launch_dpl<TQ, TKV, 1, QUANT>(a, B, s); break;
    case 64: launch_dpl<TQ, TKV, 2, QUANT>(a, B, s); break;
    case 128: launch_dpl<TQ, TKV, 4, QUANT>(a, B, s); break;
    case 256: launch_dpl<TQ, TKV, 8, QUANT>(a, B, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q: (B, H, Dh); k, v: (B, S, Hkv, Dh); k_scale, v_scale: (B, S, Hkv) fp32
// (int8 cache only, else null); lens, win_lo: (B,) int32; out: (B, H, Dh).
// q_dtype: 0 = float32, 1 = bfloat16 (q and out); kv_dtype: 0 / 1 the same
// as q_dtype, or 2 = int8. Returns the cudaError_t of the launch.
extern "C" int flash_decode_launch(const void* q, const void* k,
                                   const void* v, const void* k_scale,
                                   const void* v_scale, const void* lens,
                                   const void* win_lo, void* out, int B, int S,
                                   int H, int Hkv, int Dh, int q_dtype,
                                   int kv_dtype, float softcap, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B < 0 || S < 0 || H < 0 || Hkv <= 0 || H % Hkv) {
    return (int)cudaErrorInvalidValue;
  }
  const bool quant = kv_dtype == 2;
  if (quant && (k_scale == nullptr || v_scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (!quant && kv_dtype != q_dtype) return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0) return 0;
  const Args a{q, k, v, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(lens), static_cast<const int*>(win_lo),
               out, S, H, Hkv,
               static_cast<float>(1.0 / sqrt(static_cast<double>(Dh))),
               softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0) {
    return quant ? launch_typed<float, int8_t, true>(a, B, Dh, s)
                 : launch_typed<float, float, false>(a, B, Dh, s);
  }
  if (q_dtype == 1) {
    return quant ? launch_typed<__nv_bfloat16, int8_t, true>(a, B, Dh, s)
                 : launch_typed<__nv_bfloat16, __nv_bfloat16, false>(a, B,
                                                                     Dh, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
