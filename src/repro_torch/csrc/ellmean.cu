// ELL neighbour mean for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_ell_mean_kernel` / `ell_mean_pallas`
// (src/repro/kernels/ellmean.py): out[i] = mean over valid j of
// emb[idx[i, j]], rows with no valid entry give 0, fp32 accumulation, the
// result stored in emb's type. The (N, L, D) gather is never materialised.
//
// What bounds it on the H100: memory. The bytes the inputs need
// (`kernels/cost.py`) are `valid` whole (N * L), `idx` at the valid slots
// only (4 * cnt), each distinct gathered row of `emb` once and the (N, D)
// output once; the one add per gathered element is noise next to them. At
// the offline propagation's shells (L = 1,082, 2-10 valid slots a row,
// D = 150 fp32) `valid` is most of those bytes, so a kernel that reads
// `idx` at every slot (4 of every 5 bytes it scans) or scans a row twice
// moves 3x what it needs and spills its working set out of the 50 MB L2.
//
// Both paths, each deterministic (a fixed summation order, no atomics):
// * The valid-first scan (`list_set_slots`). A warp reads the aligned
//   16-byte words that cover its slots of `valid` (a row starts at any
//   byte: its stride is L), one word a lane per load, so each load of the
//   warp is 512 contiguous bytes; the bytes outside the row are masked.
//   Each lane turns its word into a mask of set bytes, a prefix count over
//   the lanes gives each set slot its place, and the slots are listed in
//   shared memory in slot order. `idx` is then read at the listed slots
//   only. A word with one byte of the row lies on a mapped page of the
//   row's allocation (a page is a multiple of 16 bytes), so the masked
//   bytes are never a fault.
// * The gather (`Unit`). A lane holds U units of W elements, lanes across
//   the row: one pass over a row's slots for every D up to 32 * 16 = 512
//   columns (at most 16 fp32 sums a lane), strips of 512 beyond. W is the
//   widest load that both base addresses and the row stride allow, chosen
//   at launch: 16 bytes (fp32 D % 4 == 0, bf16 D % 8 == 0), 8 bytes (fp32
//   D % 2 == 0: D = 150's 600-byte rows), else one element. A warp loads up
//   to 4 neighbour rows at once (2 where a lane holds 16 sums) and adds
//   them in list order.
// * Many rows (`ell_mean_warp`): one warp per destination row, 8 rows to a
//   block. The warp lists a pass of up to 2,032 slots at once (4 words a
//   lane), then reads the listed slots' `idx`, 32 at a time, one a lane,
//   and gathers them. Every column is added in slot order, as the kernel
//   before this design did, so fp32 outputs keep their bits.
// * Few long rows (`ell_mean_rows`): one 256-thread block per row. In
//   passes of 2,048 slots, warp w lists the valid entries of its 256 slots
//   in slot order, by one of two scans: `valid` first (one word a lane),
//   then `idx` at the set slots; or `idx` with `valid` at every slot, one
//   dependent read fewer on the way to the gather for 4 bytes a slot more.
//   The pass's entries, taken in warp order (slot order), are dealt to the
//   warps in turn, entry e to warp e % 8, so the few valid entries of a
//   flush row, which sit at its start, are gathered by all 8 warps. Each
//   warp adds its entries in list order; the warps' partial sums are added
//   in warp order through shared memory. Either scan gives the same bits.
// * The rule (`path_rule`), from device times on an H100 (PERF.md §6,
//   `chip_ab.py` with each path forced): the row-split kernel where the
//   warp-per-row kernel would start fewer blocks (ceil(N / 8)) than the card
//   has SMs and a row has at least 256 slots, else a warp per row. Measured
//   at L = 1,082 and D = 150, the warp-per-row kernel is the faster from
//   N = 635 up (shell 9, N = 922: 0.0053 ms against 0.0072; shell 2,
//   N = 10,474: 0.0123 against 0.0439), the row-split kernel at N = 525
//   (0.0049 against 0.0055) and at the flush (N = 64: 0.0046 against
//   0.0087). The edge stays at 8 rows an SM all the same: rows of more than
//   8 entries sum in another order on the two paths, so moving it would
//   change the bits of the propagation's shells 9 to 11 for ~5 us a sweep.
//   Within the row-split kernel, `idx` is read with `valid` where the
//   whole table has at most 2^18 slots (kWithIdxSlots: the flush, 77,000-
//   113,000 slots, 0.0046 ms against 0.0057 scanning `valid` first), and
//   `valid` first above (shell 12, 568,050 slots: 0.0049 against 0.0050,
//   and 0.0073 against 0.0081 at shell 9 with cold inputs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps (rows of the warp-per-row kernel) a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLaneFloats = 16;  // fp32 sums a lane holds: 512-column strips
constexpr int kScanWords = 4;    // 16-byte words a lane scans a pass (warp)
// slots a warp-per-row pass lists: their aligned cover fits 32 x 4 words
constexpr int kPass = 32 * 16 * kScanWords - 16;
constexpr int kRun = 256;              // slots a row-split warp lists a pass
constexpr int kSplitPass = kWarps * kRun;  // the row-split kernel's pass
// the row-split kernel's scans: `valid` first, then `idx` at the set slots
// (the byte-lean one), or `idx` with `valid` at every slot (one read fewer
// on the way to the gather, 4 bytes a slot more)
constexpr int kValidFirst = 0;
constexpr int kWithIdx = 1;
// paths of a launch: the warp-per-row kernel, the row-split kernel with
// either scan
constexpr int kWarpPath = 0;
constexpr int kSplitPath = 1;
constexpr int kSplitIdxPath = 2;

// neighbour rows a warp loads at once, by the fp32 sums a lane holds
__host__ __device__ constexpr int gather_rows(int sums) {
  return sums <= 8 ? 4 : 2;
}

// W elements of type T read (or written) as one load: a unit.
template <typename T, int W>
struct Unit;

template <>
struct Unit<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    v[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *p = v[0];
  }
};

template <>
struct Unit<float, 2> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float2 x = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = x.x;
    v[1] = x.y;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};

template <>
struct Unit<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = x.x;
    v[1] = x.y;
    v[2] = x.z;
    v[3] = x.w;
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Unit<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    v[0] = __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    *p = __float2bfloat16(v[0]);
  }
};

template <>
struct Unit<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* v) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 h;
      *reinterpret_cast<unsigned*>(&h) = w[i];
      const float2 f = __bfloat1622float2(h);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float* v) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// bit b set where byte b of the word is not 0
__device__ __forceinline__ unsigned set_bytes(const uint4& w) {
  const unsigned x[4] = {w.x, w.y, w.z, w.w};
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    unsigned t = (__vcmpne4(x[i], 0u) & 0x80808080u) >> 7;  // bits 0,8,16,24
    t |= t >> 7;
    t |= t >> 14;
    m |= (t & 0xfu) << (4 * i);
  }
  return m;
}

// Lists, in slot order, the set slots of the row `rv` of `valid` in
// [j0, j1): writes each one's offset from j0 to list[] and returns how many
// there are (the same on every lane). Lane `lane` reads words k * 32 + lane
// of the aligned 16-byte words that cover the range, so each of the KW
// loads of the warp is 512 contiguous bytes. Needs j1 - j0 <= 512 KW - 15.
template <int KW, typename Pos>
__device__ __forceinline__ int list_set_slots(const uint8_t* rv, int64_t j0,
                                              int64_t j1, Pos* list,
                                              int lane) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(rv + j0);
  const uintptr_t hi = reinterpret_cast<uintptr_t>(rv + j1);
  const uintptr_t base = lo & ~uintptr_t(15);
  uint4 w[KW];
#pragma unroll
  for (int k = 0; k < KW; ++k) {  // every load issued before any use
    const uintptr_t a = base + 16u * (unsigned)(k * 32 + lane);
    w[k] = a < hi ? __ldg(reinterpret_cast<const uint4*>(a))
                  : make_uint4(0u, 0u, 0u, 0u);
  }
  int n = 0;
#pragma unroll
  for (int k = 0; k < KW; ++k) {
    const uintptr_t a = base + 16u * (unsigned)(k * 32 + lane);
    // the word's bytes inside [lo, hi): from `first` up to `last`
    const long long first = max((long long)lo - (long long)a, 0ll);
    const long long last = min((long long)hi - (long long)a, 16ll);
    unsigned bits = 0;
    if (last > first) {
      bits = set_bytes(w[k]) & ((1u << last) - 1u) & ~((1u << first) - 1u);
    }
    const int c = __popc(bits);
    int incl = c;  // inclusive prefix count over the lanes
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, s);
      if (lane >= s) incl += t;
    }
    int at = n + incl - c;
    const int off = (int)((long long)a - (long long)lo);  // byte 0's slot
    while (bits) {
      const int b = __ffs(bits) - 1;
      bits &= bits - 1;
      list[at++] = (Pos)(off + b);
    }
    n += __shfl_sync(kFull, incl, 31);
  }
  __syncwarp();
  return n;
}

// Many rows: a warp per row. U units of W elements a lane.
template <typename T, int W, int U>
__global__ void __launch_bounds__(32 * kWarps)
    ell_mean_warp(const int32_t* __restrict__ idx,
                  const uint8_t* __restrict__ valid,
                  const T* __restrict__ emb, T* __restrict__ out, int64_t n,
                  int l, int d) {
  constexpr int G = gather_rows(U * W);
  __shared__ uint16_t lists[kWarps][32 * 16 * kScanWords];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarps + warp;
  if (row >= n) return;
  uint16_t* list = lists[warp];
  const int32_t* ri = idx + row * l;
  const uint8_t* rv = valid + row * l;
  const int du = d / W;
  for (int c0 = 0; c0 < du; c0 += 32 * U) {  // one strip unless d > 512
    float acc[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int w = 0; w < W; ++w) acc[u][w] = 0.f;
    }
    int cnt = 0;
    for (int j0 = 0; j0 < l; j0 += kPass) {
      const int np = list_set_slots<kScanWords>(rv, j0, min(l, j0 + kPass),
                                                list, lane);
      cnt += np;
      for (int e0 = 0; e0 < np; e0 += 32) {
        const int ne = min(32, np - e0);
        const int32_t my = lane < ne ? __ldg(ri + j0 + list[e0 + lane]) : 0;
        for (int g0 = 0; g0 < ne; g0 += G) {
          float val[G][U][W];
#pragma unroll
          for (int h = 0; h < G; ++h) {
            const int32_t src = __shfl_sync(kFull, my, (g0 + h) & 31);
            const T* er = emb + (int64_t)src * d;
#pragma unroll
            for (int u = 0; u < U; ++u) {
              const int c = c0 + u * 32 + lane;
              if (g0 + h < ne && c < du) {
                Unit<T, W>::load(er + (int64_t)c * W, val[h][u]);
              } else {
#pragma unroll
                for (int w = 0; w < W; ++w) val[h][u][w] = 0.f;
              }
            }
          }
#pragma unroll
          for (int h = 0; h < G; ++h) {
            if (g0 + h < ne) {  // warp-uniform; slot order
#pragma unroll
              for (int u = 0; u < U; ++u) {
#pragma unroll
                for (int w = 0; w < W; ++w) acc[u][w] += val[h][u][w];
              }
            }
          }
        }
      }
      __syncwarp();  // the list is rewritten by the next pass
    }
    const float denom = fmaxf((float)cnt, 1.f);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u * 32 + lane;
      if (c < du) {
        float o[W];
#pragma unroll
        for (int w = 0; w < W; ++w) o[w] = acc[u][w] / denom;
        Unit<T, W>::store(out + row * d + (int64_t)c * W, o);
      }
    }
  }
}

// Few long rows: a block per row. U units of W elements a lane. SCAN
// (kValidFirst or kWithIdx) is how a warp lists its run's entries.
template <typename T, int W, int U, int SCAN>
__global__ void __launch_bounds__(32 * kWarps)
    ell_mean_rows(const int32_t* __restrict__ idx,
                  const uint8_t* __restrict__ valid,
                  const T* __restrict__ emb, T* __restrict__ out, int l,
                  int d) {
  constexpr int G = gather_rows(U * W);
  constexpr int kUnits = 32 * U;  // units a strip
  __shared__ int32_t list[kWarps][kRun];  // a pass's set slots, then idx
  __shared__ int list_n[kWarps];
  __shared__ float part[kWarps][kUnits * W];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t row = blockIdx.x;
  const int32_t* ri = idx + row * l;
  const uint8_t* rv = valid + row * l;
  const int du = d / W;
  for (int c0 = 0; c0 < du; c0 += kUnits) {
    float acc[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int w = 0; w < W; ++w) acc[u][w] = 0.f;
    }
    int total = 0;
    for (int p0 = 0; p0 < l; p0 += kSplitPass) {
      // scan: warp w lists its run's set slots in slot order, then their idx
      const int j0 = p0 + warp * kRun;
      int nw = 0;
      if constexpr (SCAN == kWithIdx) {
        // each slot's (idx, valid) loaded at once, 8 groups of 32 slots,
        // the valid ones listed in slot order by ballot and prefix count
        const unsigned below = (1u << lane) - 1u;
        bool ok[kRun / 32];
        int32_t my[kRun / 32];
#pragma unroll
        for (int b = 0; b < kRun / 32; ++b) {  // all loads before any use
          const int j = j0 + 32 * b + lane;
          const bool in = j < l;
          ok[b] = in ? rv[j] != 0 : false;
          my[b] = in ? ri[j] : 0;
        }
#pragma unroll
        for (int b = 0; b < kRun / 32; ++b) {
          const unsigned mask = __ballot_sync(kFull, ok[b]);
          if (ok[b]) list[warp][nw + __popc(mask & below)] = my[b];
          nw += __popc(mask);
        }
      } else if (j0 < l) {  // warp-uniform
        nw = list_set_slots<1>(rv, j0, min(l, j0 + kRun), list[warp], lane);
        for (int e = lane; e < nw; e += 32) {
          list[warp][e] = __ldg(ri + j0 + list[warp][e]);
        }
      }
      if (lane == 0) list_n[warp] = nw;
      __syncthreads();
      // gather: entry e of the lists, taken in warp order, goes to warp
      // e % 8, which loads up to G rows at once and adds them in order
      int off[kWarps + 1];
      off[0] = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) off[w + 1] = off[w] + list_n[w];
      const int np = off[kWarps];
      for (int e0 = warp; e0 < np; e0 += kWarps * G) {
        int32_t src[G];
        bool has[G];
#pragma unroll
        for (int h = 0; h < G; ++h) {
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
        float val[G][U][W];
#pragma unroll
        for (int h = 0; h < G; ++h) {
          const T* er = emb + (int64_t)src[h] * d;
#pragma unroll
          for (int u = 0; u < U; ++u) {
            const int c = c0 + u * 32 + lane;
            if (has[h] && c < du) {
              Unit<T, W>::load(er + (int64_t)c * W, val[h][u]);
            } else {
#pragma unroll
              for (int w = 0; w < W; ++w) val[h][u][w] = 0.f;
            }
          }
        }
#pragma unroll
        for (int h = 0; h < G; ++h) {
          if (has[h]) {
#pragma unroll
            for (int u = 0; u < U; ++u) {
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
    for (int u = 0; u < U; ++u) {
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
      const float o = a / denom;
      Unit<T, 1>::store(out + row * d + (int64_t)c0 * W + e, &o);
    }
    __syncthreads();  // part is rewritten by the next strip
  }
}

// The path rule (see the header): the row-split kernel for few long rows,
// reading idx with valid where the whole idx is small.
constexpr long long kWithIdxSlots = 1 << 18;  // 1 MB of idx
int path_rule(long long n, int l, int sms) {
  if ((n + kWarps - 1) / kWarps >= sms || l < 32 * kWarps) return kWarpPath;
  return n * l <= kWithIdxSlots ? kSplitIdxPath : kSplitPath;
}

// The elements a load takes: the widest unit that both base addresses and
// the row stride (d elements) allow.
int unit_width(int dtype, int d, const void* emb, const void* out) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(emb) |
                      reinterpret_cast<uintptr_t>(out);
  if (dtype == 0) {
    if (d % 4 == 0 && a % 16 == 0) return 4;
    if (d % 2 == 0 && a % 8 == 0) return 2;
    return 1;
  }
  return d % 8 == 0 && a % 16 == 0 ? 8 : 1;
}

// The units a lane holds: the fewest of 1, 2, 3, 4, 8, 16 that cover a row
// of du units in one strip, at most kLaneFloats / w (then strips).
int lane_units(int du, int w) {
  const int need = (du + 31) / 32;
  const int most = kLaneFloats / w;
  const int choices[] = {1, 2, 3, 4, 8, 16};
  for (int u : choices) {
    if (u >= need && u <= most) return u;
  }
  return most;
}

struct Args {
  const int32_t* idx;
  const uint8_t* valid;
  const void* emb;
  void* out;
  long long n;
  int l, d;
};

// Launches one kernel; false (nothing launched) for a lane wider than
// kLaneFloats sums, which lane_units never asks for.
template <typename T, int W, int U>
bool launch(int path, const Args& a, cudaStream_t s) {
  if constexpr (U * W <= kLaneFloats) {
    const T* e = static_cast<const T*>(a.emb);
    T* o = static_cast<T*>(a.out);
    if (path == kWarpPath) {
      ell_mean_warp<T, W, U>
          <<<(unsigned)((a.n + kWarps - 1) / kWarps), 32 * kWarps, 0, s>>>(
              a.idx, a.valid, e, o, a.n, a.l, a.d);
    } else if (path == kSplitPath) {
      ell_mean_rows<T, W, U, kValidFirst>
          <<<(unsigned)a.n, 32 * kWarps, 0, s>>>(a.idx, a.valid, e, o, a.l,
                                                 a.d);
    } else {
      ell_mean_rows<T, W, U, kWithIdx>
          <<<(unsigned)a.n, 32 * kWarps, 0, s>>>(a.idx, a.valid, e, o, a.l,
                                                 a.d);
    }
    return true;
  }
  return false;
}

template <typename T, int W>
bool launch_units(int u, int path, const Args& a, cudaStream_t s) {
  switch (u) {
    case 1: return launch<T, W, 1>(path, a, s);
    case 2: return launch<T, W, 2>(path, a, s);
    case 3: return launch<T, W, 3>(path, a, s);
    case 4: return launch<T, W, 4>(path, a, s);
    case 8: return launch<T, W, 8>(path, a, s);
    case 16: return launch<T, W, 16>(path, a, s);
    default: return false;
  }
}

int sm_count(int device, int* sms) {
  return (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     device);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. path: -1 the rule, else kWarpPath,
// kSplitPath or kSplitIdxPath; the path launched is written to *taken.
// Returns the cudaError_t of the launch.
extern "C" int ell_mean_launch(const void* idx, const void* valid,
                               const void* emb, void* out, long long n, int l,
                               int d, int dtype, int path, int* taken,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (path < -1 || path > kSplitIdxPath) return (int)cudaErrorInvalidValue;
  if (n <= 0 || d <= 0) return 0;
  if (path < 0) {
    int sms = 0;
    const int bad = sm_count(device, &sms);
    if (bad) return bad;
    path = path_rule(n, l, sms);
  }
  *taken = path;
  const int w = unit_width(dtype, d, emb, out);
  const int u = lane_units(d / w, w);
  const Args a{static_cast<const int32_t*>(idx),
               static_cast<const uint8_t*>(valid), emb, out, n, l, d};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ok;
  if (dtype == 1) {
    ok = w == 8 ? launch_units<__nv_bfloat16, 8>(u, path, a, s)
                : launch_units<__nv_bfloat16, 1>(u, path, a, s);
  } else if (w == 4) {
    ok = launch_units<float, 4>(u, path, a, s);
  } else if (w == 2) {
    ok = launch_units<float, 2>(u, path, a, s);
  } else {
    ok = launch_units<float, 1>(u, path, a, s);
  }
  if (!ok) return (int)cudaErrorInvalidConfiguration;
  return (int)cudaGetLastError();
}

// The path (kWarpPath, kSplitPath, kSplitIdxPath) the rule gives a launch
// with these sizes, written to *path; launches nothing.
extern "C" int ell_mean_path(long long n, int l, int device, int* path) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  const int bad = sm_count(device, &sms);
  if (bad) return bad;
  *path = n > 0 ? path_rule(n, l, sms) : kWarpPath;
  return 0;
}

// The elements a load takes (*width) and the units a lane holds (*units)
// for rows of d elements at these base addresses; launches nothing.
extern "C" int ell_mean_units(int d, int dtype, const void* emb,
                              const void* out, int* width, int* units) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (d <= 0) return (int)cudaErrorInvalidValue;
  *width = unit_width(dtype, d, emb, out);
  *units = lane_units(d / *width, *width);
  return 0;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
