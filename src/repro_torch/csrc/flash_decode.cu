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
// (b, s, c) fp32 scales as it leaves shared memory (the K scale multiplies
// the finished dot product, the V scale the softmax weight); the output has
// q's type. A row with no visible position returns 0, as the Pallas kernel
// does.
//
// What bounds it on the H100: memory. Each cache row is read once and used
// for G dot products and G axpys of width Dh: 4 G Dh FLOP per 2 Dh elements,
// 2-4 FLOP per byte in bf16 at the repo's G, far below what would make the
// FP32 units the limit. The bound is the bytes of the visible K and V rows.
//
// Design (flash-decoding):
// * Split S. The grid is (split x (b, c), tile of up to 8 query rows). The
//   visible range of row b is cut into `nsplit` runs of whole 32-position
//   tiles, one per block, so that even B * Hkv = 64 pairs fill the card.
//   (Up to 4 query rows per block at Dh = 256, for the registers.) The
//   blocks of one (b, c) form a thread-block cluster; each keeps an online
//   softmax (m, l, acc[G][Dh] in fp32) over its run, and after a cluster
//   barrier every block combines a share of the outputs from all the
//   splits' partials, read through distributed shared memory in split
//   order. One launch, no scratch in device memory, no atomics: two calls
//   on the same inputs give the same bits. An empty split holds m = -1e30,
//   l = 0, acc = 0 and drops out of the combine (its weight exp(-1e30 - m)
//   is 0); a row with no visible position at all ends at 0 / max(0, 1e-30).
//   Splitting rule (`splits_for`): enough splits that the grid holds two
//   waves of resident blocks, nsplit = ceil(2 * resident / (B * Hkv *
//   gtiles)), resident = blocks per SM (occupancy) x SMs, clamped to
//   [1, 8] (8 is the portable cluster size) and to at most one split per
//   two tiles of the longest possible visible range, S (the wrapper reads
//   no length back from the card).
// * Tiles in shared memory. 128 threads stream 32-position tiles of K and V
//   through 2-3 `cp.async` stages (positions past the run are zero-filled).
//   Rows are padded so that the reads below are free of bank conflicts.
//   Each warp owns 8 positions of a tile; the warps are combined through
//   shared memory at the end, in warp order.
// * bf16 queries (the LM path; bf16 or int8 cache): tensor cores. Per warp
//   and tile, S = Q K^T with `mma.sync` m16n8k16 (the block's up to 8 query
//   rows padded to 16, q held as A fragments in registers, K fragments by
//   `ldmatrix`; int8 rows converted to bf16 pairs as they are read, exactly),
//   then the online softmax on the fragments (2 shuffle rounds per row per
//   tile), then O += P V with m16n8k8 (V fragments by `ldmatrix.trans`). P
//   is split into bf16 hi + lo parts that fill the A fragment's rows 0-7
//   and 8-15, the rows that padding would waste, so one mma accumulates
//   both and P V keeps about 16 bits more than a bf16 P: the result stays
//   within a bf16 ulp of the fp32 plain version.
// * fp32 queries (fp32 or int8 cache): fp32 FMAs, exact to 2e-5. 4 lanes
//   share a position and each forms a quarter of its G dot products from
//   shared memory (q is staged there once as fp32), so a position costs 2
//   shuffle rounds per query row, not 5; the warp's online softmax over its
//   8 positions takes 3 rounds per row per tile; then each lane accumulates
//   P.V for Dh / 32 columns over the warp's 8 rows.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;                    // positions per tile
constexpr int kRowsPerWarp = kTile / kWarps;  // 8 positions, 4 lanes each
constexpr int kMaxSplits = 8;                // portable cluster size
constexpr int kMaxDevices = 64;
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

template <int B> struct Chunk;  // the widest load that fits B bytes
template <> struct Chunk<1> { using type = uint8_t; };
template <> struct Chunk<2> { using type = uint16_t; };
template <> struct Chunk<4> { using type = uint32_t; };
template <> struct Chunk<8> { using type = uint2; };
template <> struct Chunk<16> { using type = uint4; };

// N consecutive elements at p (shared memory, aligned to min(16, N * size)
// bytes) as floats.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[N]) {
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

// Copy N bytes global -> shared without the registers; ok == false copies
// nothing and zero-fills the destination (src must still be mapped).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? N : 0;
  if constexpr (N == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(N), "r"(n)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo: low half
  return *reinterpret_cast<const unsigned*>(&v);
}
// two consecutive int8 (2-byte aligned) as a bf16 pair, exactly
__device__ __forceinline__ unsigned i8pair(const int8_t* p) {
  const unsigned w = *reinterpret_cast<const uint16_t*>(p);
  return pack_bf16(static_cast<float>(static_cast<int8_t>(w & 0xffu)),
                   static_cast<float>(static_cast<int8_t>(w >> 8)));
}
// Four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8. TRANS: each transposed.
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if constexpr (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a)
        : "memory");
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a)
        : "memory");
  }
}
// c += A B, m16n8k16, bf16 in, fp32 out; A's rows 8-15 are zero (a[0]:
// row g, columns 2t, 2t + 1; a[1]: columns 2t + 8, 2t + 9).
__device__ __forceinline__ void mma_k16(float (&c)[4], const unsigned (&a)[2],
                                        unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(0u), "r"(a[1]), "r"(0u), "r"(b0), "r"(b1));
}
// c += A B, m16n8k8, bf16 in, fp32 out (a0: rows 0-7, a1: rows 8-15).
__device__ __forceinline__ void mma_k8(float (&c)[4], unsigned a0,
                                       unsigned a1, unsigned b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// Shared-memory layout of one instantiation (bytes).
template <typename TQ, typename TKV, int DH, bool QUANT>
struct Cfg {
  // bf16 queries take the tensor-core path
  static constexpr bool kMma = std::is_same<TQ, __nv_bfloat16>::value;
  static constexpr int kSize = static_cast<int>(sizeof(TKV));
  static constexpr int kCB = kSize == 1 ? 8 : 16;  // bytes per copy chunk
  static constexpr int kCH = kCB / kSize;          // elements per chunk
  static constexpr int kNC = DH / kCH;             // chunks per row (>= 4)
  static constexpr int kRB = DH * kSize;           // row bytes
  // Padded row stride. fp32 path: a quarter-warp (16-byte loads) or
  // half-warp (8-byte loads) reads 4 consecutive chunks from each of 2 or 4
  // rows; a stride of 4 * kCB modulo 128 puts those rows on disjoint banks.
  // Tensor-core path: `ldmatrix` reads 16 bytes from each of 8 rows, and
  // the int8 fragments 1-2 bytes from each of 8; a stride of 16 modulo 128
  // puts the 8 rows on disjoint banks.
  static constexpr int kRS =
      kMma ? kRB + 16 : kRB + ((4 * kCB - kRB % 128) % 128 + 128) % 128;
  static constexpr int kSB = 2 * kTile * kRS + (QUANT ? 2 * kTile * 4 : 0);
  static constexpr int kStages = 3 * kSB <= 64 * 1024 ? 3 : 2;
  static constexpr int kDPL = DH / 32;  // fp32 path: P.V columns per lane
  // query rows per block: 8 (the tensor-core path pads them to 16), or 4
  // on the fp32 path at Dh = 256, where acc[kGT][kDPL] would otherwise
  // crowd the registers
  static constexpr int kGT = kMma || DH != 256 ? 8 : 4;
  static constexpr int kQBytes = kMma ? 0 : kGT * DH * 4;
  static constexpr int kPBytes = kMma ? 0 : kWarps * kGT * kRowsPerWarp * 4;
  // after the loop the stages hold the warps' and the block's partials
  static constexpr int kEpilogue =
      (kWarps + 1) * kGT * DH * 4 + (2 * kWarps + 2) * kGT * 4;
  static constexpr int kRing =
      kStages * kSB > kEpilogue ? kStages * kSB : kEpilogue;
  static constexpr int kSmem = kQBytes + kPBytes + kRing;
  static_assert(kNC % 4 == 0, "4 lanes share a row's chunks");
  static_assert(kRS % 16 == 0 && kSB % 16 == 0, "16-byte aligned rows");
};

// TQ: type of q and out; TKV: type of the cache; QUANT: int8 cache with
// fp32 scales. Grid: (nsplit * B * Hkv, ceil(G / kGT)); with nsplit > 1 the
// nsplit blocks of one (b, c) are one cluster.
template <typename TQ, typename TKV, int DH, bool QUANT>
__global__ void __launch_bounds__(kThreads)
    flash_decode_split(const TQ* __restrict__ q, const TKV* __restrict__ k,
                       const TKV* __restrict__ v, const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ lens,
                       const int* __restrict__ los, TQ* __restrict__ out,
                       int S, int H, int Hkv, int nsplit, float scale,
                       float softcap) {
  using C = Cfg<TQ, TKV, DH, QUANT>;
  constexpr int DPL = C::kDPL;
  constexpr int kGT = C::kGT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);  // [kGT][DH]
  float* sp = sq + kGT * DH;                   // [kWarps][kGT][8]
  unsigned char* ring = smem + C::kQBytes + C::kPBytes;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // lanes in quads: fp32 path, gq is the lane's position among the warp's
  // 8 and tq its quarter of that position's row; tensor-core path, gq is
  // the lane's query row and tq its place in the row's fragments
  const int gq = lane >> 2;
  const int tq = lane & 3;
  const int split = blockIdx.x % nsplit;
  const int pair = blockIdx.x / nsplit;
  const int b = pair / Hkv;
  const int c = pair % Hkv;
  const int G = H / Hkv;
  const int g0 = blockIdx.y * kGT;
  const int gn = min(kGT, G - g0);  // block-uniform
  const int end = min(lens[b], S);
  const int lo = max(los[b], 0);
  const int n = max(end - lo, 0);
  // this split's run: whole tiles; late splits of a short row are empty
  const int per = ((n + nsplit - 1) / nsplit + kTile - 1) / kTile * kTile;
  const int s_lo = min(lo + split * per, max(end, lo));
  const int s_hi = min(s_lo + per, end);
  const int ntile = s_hi > s_lo ? (s_hi - s_lo + kTile - 1) / kTile : 0;
  const int64_t head0 = (int64_t)b * H + (int64_t)c * G + g0;

  // tensor-core path: lane (gq, tq) holds query row gq's A fragments
  unsigned qa[C::kMma ? DH / 16 : 1][2];
  if constexpr (C::kMma) {
#pragma unroll
    for (int j = 0; j < DH / 16; ++j) qa[j][0] = qa[j][1] = 0u;
    if (gq < gn) {
      const unsigned* qw =
          reinterpret_cast<const unsigned*>(q + (head0 + gq) * DH);
#pragma unroll
      for (int j = 0; j < DH / 16; ++j) {
        qa[j][0] = qw[8 * j + tq];
        qa[j][1] = qw[8 * j + 4 + tq];
      }
    }
  } else {
    for (int i = threadIdx.x; i < kGT * DH; i += kThreads) {
      const int g = i / DH;
      sq[i] = g < gn ? to_f32(q[(head0 + g) * DH + i % DH]) : 0.f;
    }
  }

  const int64_t step = (int64_t)Hkv * DH;  // elements between positions
  const int64_t base = ((int64_t)b * S * Hkv + c) * DH;
  const int64_t sbase = (int64_t)b * S * Hkv + c;

  auto load_tile = [&](int t, int st) {
    unsigned char* dst = ring + st * C::kSB;
    const int s0 = s_lo + t * kTile;
    for (int i = threadIdx.x; i < 2 * kTile * C::kNC; i += kThreads) {
      const int which = i / (kTile * C::kNC);  // 0: K, 1: V
      const int r = (i / C::kNC) % kTile;
      const int ch = i % C::kNC;
      const bool ok = s0 + r < s_hi;
      const TKV* src = (which ? v : k) + base +
                       (int64_t)(ok ? s0 + r : s_lo) * step + ch * C::kCH;
      cp_async<C::kCB>(dst + (which * kTile + r) * C::kRS + ch * C::kCB, src,
                       ok);
    }
    if constexpr (QUANT) {
      if (threadIdx.x < 2 * kTile) {
        const int which = threadIdx.x / kTile;
        const int r = threadIdx.x % kTile;
        const bool ok = s0 + r < s_hi;
        const float* src =
            (which ? vs : ks) + sbase + (int64_t)(ok ? s0 + r : s_lo) * Hkv;
        cp_async<4>(dst + 2 * kTile * C::kRS + (which * kTile + r) * 4, src,
                    ok);
      }
    }
  };

  // fp32 path: acc[g][i] of the kGT rows, columns lane * DPL + i;
  // tensor-core path: acc[n-tile][4] of row gq (C fragments: [0], [1] for
  // columns 8 nt + 2 tq, + 1 from P_hi, [2], [3] the same from P_lo), with
  // m[0], l[0] the row's softmax state
  constexpr int kAccR = C::kMma ? DH / 8 : kGT;
  constexpr int kAccC = C::kMma ? 4 : DPL;
  float acc[kAccR][kAccC], m[kGT], l[kGT];
#pragma unroll
  for (int g = 0; g < kAccR; ++g) {
#pragma unroll
    for (int i = 0; i < kAccC; ++i) acc[g][i] = 0.f;
  }
#pragma unroll
  for (int g = 0; g < kGT; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
  }

#pragma unroll
  for (int st = 0; st < C::kStages - 1; ++st) {
    if (st < ntile) load_tile(st, st);
    cp_commit();
  }
  for (int t = 0; t < ntile; ++t) {
    cp_wait<C::kStages - 2>();
    __syncthreads();  // tile t has landed; every warp is done with t - 1
    {
      const int nt = t + C::kStages - 1;
      if (nt < ntile) load_tile(nt, nt % C::kStages);
      cp_commit();
    }
    const unsigned char* tile = ring + (t % C::kStages) * C::kSB;
    if constexpr (C::kMma) {
      const int r0 = warp * kRowsPerWarp;  // the warp's first row
      // S = Q K^T: lane (gq, tq) gets row gq at positions r0 + 2tq, + 1
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (sizeof(TKV) == 2) {
#pragma unroll
        for (int j = 0; j < DH / 32; ++j) {
          unsigned bf[4];
          ldsm_x4<false>(bf, tile + (r0 + (lane & 7)) * C::kRS +
                                 (32 * j + 8 * (lane >> 3)) * 2);
          mma_k16(sc, qa[2 * j], bf[0], bf[1]);
          mma_k16(sc, qa[2 * j + 1], bf[2], bf[3]);
        }
      } else {
        const int8_t* kr =
            reinterpret_cast<const int8_t*>(tile + (r0 + gq) * C::kRS);
#pragma unroll
        for (int j = 0; j < DH / 16; ++j) {
          mma_k16(sc, qa[j], i8pair(kr + 16 * j + 2 * tq),
                  i8pair(kr + 16 * j + 8 + 2 * tq));
        }
      }
      float kscale[2] = {1.f, 1.f}, vscale[2] = {1.f, 1.f};
      if constexpr (QUANT) {
        const float* scl =
            reinterpret_cast<const float*>(tile + 2 * kTile * C::kRS);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          kscale[i] = scl[r0 + 2 * tq + i];
          vscale[i] = scl[kTile + r0 + 2 * tq + i];
        }
      }
      float lg[2];
      bool live[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        live[i] = s_lo + t * kTile + r0 + 2 * tq + i < s_hi;
        float d = sc[i] * kscale[i] * scale;
        if (softcap > 0.f) d = softcap * tanhf(d / softcap);
        lg[i] = live[i] ? d : kNegInf;
      }
      // the row's online softmax over the warp's 8 positions (its quad)
      float mx = fmaxf(lg[0], lg[1]);
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float mnew = fmaxf(m[0], mx);
      float pe[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) pe[i] = live[i] ? expf(lg[i] - mnew) : 0.f;
      float ps = pe[0] + pe[1];
      ps += __shfl_xor_sync(kFull, ps, 1);
      ps += __shfl_xor_sync(kFull, ps, 2);
      const float alpha = expf(m[0] - mnew);
      l[0] = fmaf(l[0], alpha, ps);
      m[0] = mnew;
      // P (times the V scale) as bf16 hi + lo: A rows gq and gq + 8
      const float p0 = pe[0] * vscale[0], p1 = pe[1] * vscale[1];
      const unsigned a_hi = pack_bf16(p0, p1);
      const __nv_bfloat162 h2 = *reinterpret_cast<const __nv_bfloat162*>(
          &a_hi);
      const unsigned a_lo =
          pack_bf16(p0 - __low2float(h2), p1 - __high2float(h2));
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] *= alpha;
      }
      // O += P V over the warp's 8 positions
      const unsigned char* vt = tile + kTile * C::kRS;
      if constexpr (sizeof(TKV) == 2) {
#pragma unroll
        for (int j = 0; j < DH / 32; ++j) {
          unsigned bf[4];
          ldsm_x4<true>(bf, vt + (r0 + (lane & 7)) * C::kRS +
                                (32 * j + 8 * (lane >> 3)) * 2);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            mma_k8(acc[4 * j + i], a_hi, a_lo, bf[i]);
          }
        }
      } else {
        const int8_t* v0 =
            reinterpret_cast<const int8_t*>(vt + (r0 + 2 * tq) * C::kRS);
        const int8_t* v1 = v0 + C::kRS;
#pragma unroll
        for (int nt = 0; nt < DH / 8; ++nt) {
          mma_k8(acc[nt], a_hi, a_lo,
                 pack_bf16(static_cast<float>(v0[8 * nt + gq]),
                           static_cast<float>(v1[8 * nt + gq])));
        }
      }
    } else {
      const int r = warp * kRowsPerWarp + gq;  // the lane's row of a tile
      float* wp = sp + warp * kGT * kRowsPerWarp;
      const TKV* krow = reinterpret_cast<const TKV*>(tile + r * C::kRS);
      const bool live = s_lo + t * kTile + r < s_hi;

      // quarter dot products: chunks tq, tq + 4, ... of the row
      float dot[kGT];
#pragma unroll
      for (int g = 0; g < kGT; ++g) dot[g] = 0.f;
#pragma unroll
      for (int j = 0; j < C::kNC / 4; ++j) {
        const int ch = tq + 4 * j;
        float kf[C::kCH];
        load_vec<TKV, C::kCH>(krow + ch * C::kCH, kf);
#pragma unroll
        for (int g = 0; g < kGT; ++g) {
          if (g < gn) {
            const float4* qp =
                reinterpret_cast<const float4*>(sq + g * DH + ch * C::kCH);
#pragma unroll
            for (int e = 0; e < C::kCH / 4; ++e) {
              const float4 qq = qp[e];
              dot[g] = fmaf(qq.x, kf[4 * e], dot[g]);
              dot[g] = fmaf(qq.y, kf[4 * e + 1], dot[g]);
              dot[g] = fmaf(qq.z, kf[4 * e + 2], dot[g]);
              dot[g] = fmaf(qq.w, kf[4 * e + 3], dot[g]);
            }
          }
        }
      }
      float kscale = 1.f, vscale = 1.f;
      if constexpr (QUANT) {
        const float* sc = reinterpret_cast<const float*>(tile + 2 * kTile *
                                                         C::kRS);
        kscale = sc[r];
        vscale = sc[kTile + r];
      }

      // the warp's online softmax over its 8 positions, one row at a time
      float alpha[kGT];
#pragma unroll
      for (int g = 0; g < kGT; ++g) {
        alpha[g] = 1.f;
        if (g < gn) {
          float d = dot[g];
          d += __shfl_xor_sync(kFull, d, 1);
          d += __shfl_xor_sync(kFull, d, 2);
          d = d * kscale * scale;
          if (softcap > 0.f) d = softcap * tanhf(d / softcap);
          const float lg = live ? d : kNegInf;
          float mx = lg;
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 4));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 8));
          mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 16));
          const float mnew = fmaxf(m[g], mx);
          const float p = live ? expf(lg - mnew) : 0.f;
          float ps = p;  // the 4 lanes of a position hold the same p
          ps += __shfl_xor_sync(kFull, ps, 4);
          ps += __shfl_xor_sync(kFull, ps, 8);
          ps += __shfl_xor_sync(kFull, ps, 16);
          alpha[g] = expf(m[g] - mnew);
          l[g] = fmaf(l[g], alpha[g], ps);
          m[g] = mnew;
          if (tq == 0) wp[g * kRowsPerWarp + gq] = p * vscale;
        }
      }
      __syncwarp();

      // P.V over the warp's 8 rows; lanes split Dh
#pragma unroll
      for (int g = 0; g < kGT; ++g) {
        if (g < gn) {
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha[g];
        }
      }
      const unsigned char* vt = tile + kTile * C::kRS;
#pragma unroll
      for (int pp = 0; pp < kRowsPerWarp; ++pp) {
        float vf[DPL];
        load_vec<TKV, DPL>(reinterpret_cast<const TKV*>(
                               vt + (warp * kRowsPerWarp + pp) * C::kRS) +
                               lane * DPL,
                           vf);
#pragma unroll
        for (int g = 0; g < kGT; ++g) {
          if (g < gn) {
            const float pv = wp[g * kRowsPerWarp + pp];
#pragma unroll
            for (int i = 0; i < DPL; ++i) {
              acc[g][i] = fmaf(pv, vf[i], acc[g][i]);
            }
          }
        }
      }
    }
  }

  // the 4 warps' partials, combined in warp order into the block's
  cp_wait<0>();
  __syncthreads();  // the ring is free
  float* wacc = reinterpret_cast<float*>(ring);  // [kWarps][kGT][DH]
  float* wm = wacc + kWarps * kGT * DH;          // [kWarps][kGT]
  float* wl = wm + kWarps * kGT;
  float* pacc = wl + kWarps * kGT;  // the block's partial [kGT][DH]
  float* pm = pacc + kGT * DH;      // [kGT]
  float* pl = pm + kGT;
  if constexpr (C::kMma) {
    if (gq < gn) {
#pragma unroll
      for (int nt = 0; nt < DH / 8; ++nt) {
        *reinterpret_cast<float2*>(wacc + (warp * kGT + gq) * DH + 8 * nt +
                                   2 * tq) =
            make_float2(acc[nt][0] + acc[nt][2], acc[nt][1] + acc[nt][3]);
      }
      if (tq == 0) {
        wm[warp * kGT + gq] = m[0];
        wl[warp * kGT + gq] = l[0];
      }
    }
  } else {
#pragma unroll
    for (int g = 0; g < kGT; ++g) {
      if (g < gn) {
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          wacc[(warp * kGT + g) * DH + lane * DPL + i] = acc[g][i];
        }
        if (lane == 0) {
          wm[warp * kGT + g] = m[g];
          wl[warp * kGT + g] = l[g];
        }
      }
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < gn * DH; e += kThreads) {
    const int g = e / DH;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * kGT + g]);
    float tot = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w * kGT + g] - mx);
      tot = fmaf(wl[w * kGT + g], f, tot);
      a = fmaf(wacc[(w * kGT + g) * DH + e % DH], f, a);
    }
    if (nsplit == 1) {
      put(out + head0 * DH + e, a / fmaxf(tot, 1e-30f));
    } else {
      pacc[e] = a;
      if (e % DH == 0) {
        pm[g] = mx;
        pl[g] = tot;
      }
    }
  }
  if (nsplit == 1) return;  // block-uniform: no cluster

  // the splits of (b, c): each block writes a share of the outputs from
  // every split's partial, read in split order through distributed shared
  // memory
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every split's partial is in its shared memory
  const int total = gn * DH;
  const int share = (total + nsplit - 1) / nsplit;
  const int e0 = static_cast<int>(cluster.block_rank()) * share;
  const int e1 = min(e0 + share, total);
  for (int e = e0 + threadIdx.x; e < e1; e += kThreads) {
    const int g = e / DH;
    float mx = kNegInf;
    for (int j = 0; j < nsplit; ++j) {
      mx = fmaxf(mx, cluster.map_shared_rank(pm, j)[g]);
    }
    float tot = 0.f, a = 0.f;
    for (int j = 0; j < nsplit; ++j) {
      const float f = expf(cluster.map_shared_rank(pm, j)[g] - mx);
      tot = fmaf(cluster.map_shared_rank(pl, j)[g], f, tot);
      a = fmaf(cluster.map_shared_rank(pacc, j)[e], f, a);
    }
    put(out + head0 * DH + e, a / fmaxf(tot, 1e-30f));
  }
  cluster.sync();  // no block leaves while another still reads its memory
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
  int B, S, H, Hkv;
  float scale, softcap;
};

// Resident blocks of one instantiation on `device` (occupancy x SMs), with
// its dynamic shared memory allowed; computed once per device.
template <typename TQ, typename TKV, int DH, bool QUANT>
cudaError_t resident_blocks(int device, int* out) {
  static int cache[kMaxDevices];  // 0: not yet known
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[device] == 0) {
    auto kern = flash_decode_split<TQ, TKV, DH, QUANT>;
    constexpr int smem = Cfg<TQ, TKV, DH, QUANT>::kSmem;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        kThreads, smem);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[device] = per_sm * sms;
  }
  *out = cache[device];
  return cudaSuccess;
}

// The splitting rule (see the header): two waves of resident blocks, at
// most kMaxSplits, at least two tiles of S per split. gt: query rows per
// block.
int splits_for(int resident, int gt, int B, int S, int H, int Hkv) {
  const int gtiles = (H / Hkv + gt - 1) / gt;
  const long long pairs = (long long)B * Hkv * gtiles;
  long long want = (2LL * resident + pairs - 1) / pairs;
  want = want < kMaxSplits ? want : kMaxSplits;
  const int by_s = S / (2 * kTile);
  want = want < by_s ? want : by_s;
  return want < 1 ? 1 : static_cast<int>(want);
}

template <typename TQ, typename TKV, int DH, bool QUANT>
int launch_dh(const Args& a, int device, cudaStream_t s, int* nsplit_out) {
  int resident = 0;
  cudaError_t err = resident_blocks<TQ, TKV, DH, QUANT>(device, &resident);
  if (err != cudaSuccess) return (int)err;
  using C = Cfg<TQ, TKV, DH, QUANT>;
  const int nsplit = splits_for(resident, C::kGT, a.B, a.S, a.H, a.Hkv);
  if (nsplit_out != nullptr) {  // a query: launch nothing
    *nsplit_out = nsplit;
    return 0;
  }
  const int G = a.H / a.Hkv;
  const dim3 grid((unsigned)(nsplit * a.B * a.Hkv),
                  (unsigned)((G + C::kGT - 1) / C::kGT));
  constexpr int smem = C::kSmem;
  auto kern = flash_decode_split<TQ, TKV, DH, QUANT>;
  const TQ* q = static_cast<const TQ*>(a.q);
  const TKV* k = static_cast<const TKV*>(a.k);
  const TKV* v = static_cast<const TKV*>(a.v);
  TQ* out = static_cast<TQ*>(a.out);
  if (nsplit == 1) {
    kern<<<grid, kThreads, smem, s>>>(q, k, v, a.ks, a.vs, a.lens, a.los, out,
                                      a.S, a.H, a.Hkv, 1, a.scale,
                                      a.softcap);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, q, k, v, a.ks, a.vs, a.lens, a.los,
                           out, a.S, a.H, a.Hkv, nsplit, a.scale, a.softcap);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV, bool QUANT>
int launch_typed(const Args& a, int dh, int device, cudaStream_t s,
                 int* nsplit_out) {
  switch (dh) {
    case 32: return launch_dh<TQ, TKV, 32, QUANT>(a, device, s, nsplit_out);
    case 64: return launch_dh<TQ, TKV, 64, QUANT>(a, device, s, nsplit_out);
    case 128: return launch_dh<TQ, TKV, 128, QUANT>(a, device, s, nsplit_out);
    case 256: return launch_dh<TQ, TKV, 256, QUANT>(a, device, s, nsplit_out);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(const Args& a, int Dh, int q_dtype, int kv_dtype, int device,
             cudaStream_t s, int* nsplit_out) {
  const bool quant = kv_dtype == 2;
  if (q_dtype == 0) {
    return quant ? launch_typed<float, int8_t, true>(a, Dh, device, s,
                                                     nsplit_out)
                 : launch_typed<float, float, false>(a, Dh, device, s,
                                                     nsplit_out);
  }
  if (q_dtype == 1) {
    return quant ? launch_typed<__nv_bfloat16, int8_t, true>(a, Dh, device, s,
                                                             nsplit_out)
                 : launch_typed<__nv_bfloat16, __nv_bfloat16, false>(
                       a, Dh, device, s, nsplit_out);
  }
  return (int)cudaErrorInvalidValue;
}

int check_args(int B, int S, int H, int Hkv, int q_dtype, int kv_dtype) {
  if (B < 0 || S < 0 || H < 0 || Hkv <= 0 || H % Hkv) {
    return (int)cudaErrorInvalidValue;
  }
  if (kv_dtype != 2 && kv_dtype != q_dtype) return (int)cudaErrorInvalidValue;
  return 0;
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
  const int bad = check_args(B, S, H, Hkv, q_dtype, kv_dtype);
  if (bad) return bad;
  if (kv_dtype == 2 && (k_scale == nullptr || v_scale == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0 || H == 0) return 0;
  const Args a{q, k, v, static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const int*>(lens), static_cast<const int*>(win_lo),
               out, B, S, H, Hkv,
               static_cast<float>(1.0 / sqrt(static_cast<double>(Dh))),
               softcap};
  return dispatch(a, Dh, q_dtype, kv_dtype, device,
                  static_cast<cudaStream_t>(stream), nullptr);
}

// The number of splits of S a launch with these sizes uses (written to
// *nsplit); launches nothing. Returns a cudaError_t.
extern "C" int flash_decode_splits(int B, int S, int H, int Hkv, int Dh,
                                   int q_dtype, int kv_dtype, int device,
                                   int* nsplit) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int bad = check_args(B, S, H, Hkv, q_dtype, kv_dtype);
  if (bad) return bad;
  if (B == 0 || H == 0) {
    *nsplit = 0;
    return 0;
  }
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, B, S, H, Hkv, 1.f, 0.f};
  return dispatch(a, Dh, q_dtype, kv_dtype, device, nullptr, nsplit);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
