// Streaming score + top-k for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_topk_kernel` / `topk_pallas`
// (src/repro/kernels/topk.py): per query, the k rows of `table` with the
// highest score q . t + bias[t] under the total order (score desc, index
// asc), bias being 0 for live rows and -inf for dead ones. The (Q, N) score
// matrix is never written to memory.
//
// What bounds it on the H100: the fp32 dot products, 2 * Q * N * D
// operations on the CUDA cores at 67 TFLOP/s (no tensor cores: TF32 would
// move scores by ~1e-3 and reorder near-ties against the fp32 reference).
// At Q = 64, D = 128 that is 8x the time of one read of the table
// (N * D * 4 bytes at 3.35 TB/s); only for Q below about 8 do the bytes
// bound it.
//
// Design. Blocks run in parallel and in no order, so the work is two
// kernels: `topk_partial` reduces (64 queries, one contiguous range of
// table rows) to a sorted partial list per query, and `topk_merge` merges
// the partials, one block per query.
//
// * Dot products at the FFMA rate. A 256-thread block scores 256-row tiles
//   against its 64 queries; each thread holds an 8 x 8 (rows x queries)
//   register tile, rows rg + 32 i and queries qg + 8 j. Table rows and
//   queries stream through shared memory in steps of 32 widths, two
//   stages with `cp.async` (zero-filled past the table's end and past D),
//   so the next step loads while this one is scored; a tile's bias comes
//   with its first step. A stage row is padded to 36 floats (9 float4, an
//   odd count), so the rows and queries a warp reads together fall in
//   distinct banks. Per 4 widths a thread issues 16 LDS.128 for 256 FFMA:
//   16 FFMA per shared load.
// * A grid sized from occupancy: occupancy x SMs blocks over the query
//   blocks, each walking one long contiguous range of whole tiles (the
//   wrapper's planner, `kernels/topk.py:plan`), so a block's threshold
//   warms up once and few partials are left to merge.
// * Selection in batches with a threshold. Each query's running list (the
//   best L = pow2 >= k entries, sorted) and a candidate buffer (128
//   entries) live in shared memory. A score that beats the list's k-th
//   entry takes a buffer slot (a shared atomic counter). After a tile, when
//   a buffer overflowed or is half full, and at the end, the block flushes:
//   each warp takes its 8 queries and, for all of those with candidates at
//   once, bitonic-sorts the buffers, keeps the better of list[i] and
//   buffer[L - 1 - i] (a bitonic sequence holding the best L of both) and
//   bitonic-merges it (`flush_lists`). Candidates that found no slot retry
//   against the new threshold. A block's first tile with k <= 32 seeds the
//   lists first: each thread's best entry per query (32 a query) is
//   flushed, so the rest of the tile meets the k-th best of those as its
//   threshold instead of an empty list. The result is the exact top-k of
//   the kernel's scores under the total order, whatever the order of
//   arrival, so two calls give the same bits.
// * The merge: one 256-thread block per query reads the partials rank by
//   rank (entry 0 of every partial, then the next ranks, several a read
//   when the partials are few), through the same threshold and buffer, a
//   flush taken by the whole block, and stops after the first read none
//   of whose entries beats the threshold: every later entry of a sorted
//   partial is worse. Unfilled entries are -inf / -1.
//
// k of any size: one pass (a `topk_partial` + `topk_merge` pair) gives one
// *round* of at most 128 entries. A larger k runs ceil(k / 128) rounds;
// round r > 0 takes a floor per query, the last entry of round r - 1, and
// admits only candidates strictly after it in the (score desc, index asc)
// order, so the rounds are consecutive slices of one sorted list, each
// written at its column offset of the (Q, k) output. A floor that is an
// empty entry (index -1: fewer live rows than the earlier rounds asked
// for) admits nothing. Each round streams the table again.
//
// Shared memory of `topk_partial`: 2 stages x (256 + 64) rows x 36 floats
// = 92,160 bytes whatever D is (D streams through the stages), 2,048 of
// bias, 64 x (L + 128) x 8 bytes of lists and buffers and 1,280 of
// counters, floors and thresholds: 169,216 bytes for k <= 16, 177,408 for
// k <= 32, 193,792 for k <= 64 and 226,560 for k <= 128. One block an
// SM at every
// k: the register tile and its operands take more than the 128 registers a
// thread that two blocks would leave (at 128, ptxas spills).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQB = 64;    // queries per block
constexpr int kTR = 256;   // table rows per tile
constexpr int kBK = 32;    // widths per stage
constexpr int kLD = 36;    // floats per staged row: 9 float4, an odd count
constexpr int kStages = 2;
constexpr int kStageFloats = (kTR + kQB) * kLD;
constexpr int kRoundK = 128;
constexpr int kBuf = 128;       // candidate slots of a query
constexpr int kMergeBuf = 256;  // candidate slots of a merge block
constexpr int kNone = 0x7fffffff;  // index of an empty entry
constexpr int kMaxDevices = 64;

__host__ __device__ inline int list_width(int kr) {
  int l = 1;
  while (l < kr) l <<= 1;
  return l;
}

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
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

// One compare-exchange pass of a bitonic network over the sequences of na
// queries held by one warp: sequence a (the query in lane a's `qreg`) at
// v/x + q * stride, n / 2 pairs each at distance st; `dir_sz` > 0 sorts
// blocks of that size alternately best-first and worst-first (the sort),
// 0 puts the better entry first everywhere (the merge). Each lane takes
// four pairs at a time, all loads before any store: the pairs of a pass
// are disjoint.
__device__ __forceinline__ void ce_pass(float* v, int* x, int stride,
                                        int qreg, int na, int half_log,
                                        int st, int dir_sz, int lane) {
  const int total = na << half_log;
  for (int u0 = 0; u0 < total; u0 += 128) {
    float vi[4], vj[4];
    int ii[4], ij[4], oi[4], oj[4], dsc[4];
    bool ok[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = u0 + 32 * k + lane;
      ok[k] = t < total;
      const int q = __shfl_sync(kFull, qreg, (t >> half_log) & 31);
      const int tt = t & ((1 << half_log) - 1);
      const int i = ((tt & ~(st - 1)) << 1) | (tt & (st - 1));
      oi[k] = q * stride + i;
      oj[k] = oi[k] + st;
      dsc[k] = dir_sz == 0 || (i & dir_sz) == 0;
      if (ok[k]) {
        vi[k] = v[oi[k]];
        vj[k] = v[oj[k]];
        ii[k] = x[oi[k]];
        ij[k] = x[oj[k]];
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (ok[k] && better(vj[k], ij[k], vi[k], ii[k]) == (bool)dsc[k]) {
        v[oi[k]] = vj[k]; x[oi[k]] = ij[k];
        v[oj[k]] = vi[k]; x[oj[k]] = ii[k];
      }
    }
  }
  __syncwarp();
}

// One warp folds the candidates of na <= 32 queries into their lists, all
// at once: query q (lane a < na holds the a-th in `qreg`) has its sorted
// list at lv/li + q * L (L a power of two) and its buffer at bv/bi + q *
// cb, the first entries filled and the rest empty (-inf, kNone), cmax >= 1
// filled at most. Each buffer's first p = pow2 >= cmax entries are
// bitonic-sorted, best first; list[i] keeps the better of itself and
// buffer[L - 1 - i], a bitonic sequence holding the best L of both; a
// bitonic merge sorts it; the buffers are left empty.
__device__ void flush_lists(float* lv, int* li, float* bv, int* bi, int L,
                            int cb, int qreg, int na, int cmax, int lane) {
  int p = 2;
  while (p < cmax) p <<= 1;
  const int hp = __ffs(p) - 2;  // log2(p / 2)
  for (int sz = 2; sz <= p; sz <<= 1)  // bitonic sort, best first
    for (int st = sz >> 1; st > 0; st >>= 1)
      ce_pass(bv, bi, cb, qreg, na, hp, st, sz, lane);
  const int hl = __ffs(L) - 1;  // log2(L)
  for (int t0 = 0; t0 < (na << hl); t0 += 32) {  // best L of both
    const int t = t0 + lane;
    const int q = __shfl_sync(kFull, qreg, (t >> hl) & 31);
    const int i = t & (L - 1), j = L - 1 - i;
    if (t < (na << hl) && j < p &&
        better(bv[q * cb + j], bi[q * cb + j], lv[q * L + i],
               li[q * L + i])) {
      lv[q * L + i] = bv[q * cb + j];
      li[q * L + i] = bi[q * cb + j];
    }
  }
  __syncwarp();
  for (int st = L >> 1; st > 0; st >>= 1)  // bitonic merge, best first
    ce_pass(lv, li, L, qreg, na, hl - 1, st, 0, lane);
  const int lp = __ffs(p) - 1;
  for (int t0 = 0; t0 < (na << lp); t0 += 32) {
    const int t = t0 + lane;
    const int q = __shfl_sync(kFull, qreg, (t >> lp) & 31);
    if (t < (na << lp)) {
      bv[q * cb + (t & (p - 1))] = -INFINITY;
      bi[q * cb + (t & (p - 1))] = kNone;
    }
  }
  __syncwarp();
}

// The whole block folds one buffer (bv/bi, cmax >= 1 filled, the rest
// empty) into one sorted list lv/li of width L: the network of
// `flush_lists`, a compare-exchange per thread, a barrier per stage.
// Every thread of the block calls it.
__device__ void flush_block(float* lv, int* li, float* bv, int* bi, int L,
                            int cmax, int tid) {
  int p = 2;
  while (p < cmax) p <<= 1;
  for (int sz = 2; sz <= p; sz <<= 1) {  // bitonic sort, best first
    for (int st = sz >> 1; st > 0; st >>= 1) {
      for (int t = tid; t < (p >> 1); t += kThreads) {
        const int i = ((t & ~(st - 1)) << 1) | (t & (st - 1));
        const int j = i + st;
        const float vi = bv[i], vj = bv[j];
        const int ii = bi[i], ij = bi[j];
        if (better(vj, ij, vi, ii) == ((i & sz) == 0)) {
          bv[i] = vj; bi[i] = ij;
          bv[j] = vi; bi[j] = ii;
        }
      }
      __syncthreads();
    }
  }
  for (int i = tid; i < L; i += kThreads) {  // best L of both
    const int j = L - 1 - i;
    if (j < p && better(bv[j], bi[j], lv[i], li[i])) {
      lv[i] = bv[j];
      li[i] = bi[j];
    }
  }
  __syncthreads();
  for (int st = L >> 1; st > 0; st >>= 1) {  // bitonic merge, best first
    for (int t = tid; t < (L >> 1); t += kThreads) {
      const int i = ((t & ~(st - 1)) << 1) | (t & (st - 1));
      const int j = i + st;
      const float vi = lv[i], vj = lv[j];
      const int ii = li[i], ij = li[j];
      if (better(vj, ij, vi, ii)) {
        lv[i] = vj; li[i] = ij;
        lv[j] = vi; li[j] = ii;
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < p; i += kThreads) {
    bv[i] = -INFINITY;
    bi[i] = kNone;
  }
  __syncthreads();
}

// Shared memory of `topk_partial` for a round of kr entries.
__host__ __device__ inline long long partial_smem(int kr) {
  return (long long)kStages * kStageFloats * 4 + 2 * kTR * 4 +
         (long long)kQB * (list_width(kr) + kBuf) * 8 + kQB * 20;
}

// grid (n_chunks, ceil(Q / 64)); block 256; dynamic shared memory
// partial_smem(kr). Partials are (Q, kr, n_chunks): entry x of every
// block's list side by side, as the merge reads them. fv / fi: the floor of
// each query (row stride ld), null in a first round. kVec: d % 4 == 0 and
// q, t 16-byte aligned (float4 copies), else 4-byte copies.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    topk_partial(const float* __restrict__ q, const float* __restrict__ t,
                 const float* __restrict__ bias, const float* __restrict__ fv,
                 const int* __restrict__ fi, int ld, float* __restrict__ pv,
                 int* __restrict__ pi, int nq, int n, int d, int kr,
                 int rows_per_chunk) {
  extern __shared__ float4 smem4[];
  const int L = list_width(kr), CB = kBuf;
  float* stage = reinterpret_cast<float*>(smem4);
  float* bias_s = stage + kStages * kStageFloats;  // two tiles' bias
  float* lv = bias_s + 2 * kTR;
  int* li = reinterpret_cast<int*>(lv + kQB * L);
  float* bv = reinterpret_cast<float*>(li + kQB * L);
  int* bi = reinterpret_cast<int*>(bv + kQB * CB);
  int* cnt = bi + kQB * CB;
  float* flv = reinterpret_cast<float*>(cnt + kQB);
  int* fli = reinterpret_cast<int*>(flv + kQB);
  // each query's k-th entry, query qg + 8 j at qg * 8 + j: a thread reads
  // the thresholds of its 8 queries in four 16-byte loads
  float* thr_v = reinterpret_cast<float*>(fli + kQB);
  int* thr_i = reinterpret_cast<int*>(thr_v + kQB);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qg = lane & 7, rg = warp * 4 + (lane >> 3);
  const int q0 = blockIdx.y * kQB;
  // Row r with score sc may enter this round: a live row and, in a round
  // with floors (all but the first), strictly after query ql's floor entry
  // (an empty floor, index -1, admits nothing). The first round reads no
  // floor.
  const bool floors = fv != nullptr;
  auto admit = [&](float sc, int r, int ql) {
    if (!(sc > -INFINITY)) return false;
    if (!floors) return true;
    const int f = fli[ql];
    return f >= 0 && better(flv[ql], f, sc, r);
  };
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(n, r_begin + rows_per_chunk);

  for (int e = tid; e < kQB * L; e += kThreads) {
    lv[e] = -INFINITY;
    li[e] = kNone;
  }
  for (int e = tid; e < kQB * CB; e += kThreads) {
    bv[e] = -INFINITY;
    bi[e] = kNone;
  }
  if (tid < kQB) {
    const int qq = q0 + tid;
    cnt[tid] = 0;
    thr_v[tid] = -INFINITY;
    thr_i[tid] = kNone;
    flv[tid] = (fv && qq < nq) ? fv[(int64_t)qq * ld] : INFINITY;
    fli[tid] = (fi && qq < nq) ? fi[(int64_t)qq * ld] : -1;
  }
  __syncthreads();

  const int n_tiles = r_end > r_begin ? (r_end - r_begin + kTR - 1) / kTR : 0;
  const int dsteps = (d + kBK - 1) / kBK;
  const int nsteps = n_tiles * dsteps;

  // step s: tile s / dsteps, widths [d0, d0 + kBK) of its 256 rows and of
  // the block's 64 queries; a tile's first step also brings its bias
  auto issue = [&](int s) {
    const int tile = s / dsteps;
    const int d0 = (s - tile * dsteps) * kBK;
    const int r0 = r_begin + tile * kTR;
    float* buf = stage + (s % kStages) * kStageFloats;
    constexpr int kPer = kVec ? 4 : 1;
    for (int e = tid; e < (kTR + kQB) * (kBK / kPer); e += kThreads) {
      const int row = e / (kBK / kPer);
      const int c = (e - row * (kBK / kPer)) * kPer;
      const int col = d0 + c;
      const float* src;
      bool ok;
      if (row < kTR) {
        const int r = r0 + row;
        ok = r < r_end && col < d;
        src = ok ? t + (int64_t)r * d + col : t;
      } else {
        const int qq = q0 + row - kTR;
        ok = qq < nq && col < d;
        src = ok ? q + (int64_t)qq * d + col : q;
      }
      cp_async<4 * kPer>(buf + row * kLD + c, src, ok);
    }
    if (d0 == 0) {  // row tid at (tid % 32) * 8 + tid / 32: a thread's 8
      const int r = r0 + tid;  // rows side by side
      cp_async<4>(bias_s + (tile & 1) * kTR + (tid & 31) * 8 + (tid >> 5),
                  r < r_end ? bias + r : bias, r < r_end);
    }
  };

  auto flush_all = [&]() {  // after a barrier; ends with one
    // each warp its 8 queries: those with candidates, all at once
    const int q_w = warp * (kQB / kWarps);
    const int c = lane < kQB / kWarps ? min(cnt[q_w + lane], CB) : 0;
    const unsigned act = __ballot_sync(kFull, c > 0);
    // lane a takes the a-th query with candidates
    const int qreg = q_w + __fns(act, 0, lane + 1);
    if (act)
      flush_lists(lv, li, bv, bi, L, CB, qreg, __popc(act),
                  __reduce_max_sync(kFull, c), lane);
    if (lane < kQB / kWarps) cnt[q_w + lane] = 0;
    __syncthreads();
    if (tid < kQB) {
      thr_v[(tid & 7) * 8 + (tid >> 3)] = lv[tid * L + kr - 1];
      thr_i[(tid & 7) * 8 + (tid >> 3)] = li[tid * L + kr - 1];
    }
    __syncthreads();
  };

  float acc[8][8];
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nsteps) issue(s);
    cp_commit();
  }
  for (int s = 0; s < nsteps; ++s) {
    cp_wait<kStages - 2>();
    __syncthreads();  // step s landed; step s - 1 is consumed
    if (s + kStages - 1 < nsteps) issue(s + kStages - 1);
    cp_commit();
    const int tile = s / dsteps;
    const int ds = s - tile * dsteps;
    if (ds == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    const float* buf = stage + (s % kStages) * kStageFloats;
    const float* ta = buf + rg * kLD;
    const float* qb = buf + (kTR + qg) * kLD;
#pragma unroll 2  // a body the instruction cache holds
    for (int c = 0; c < kBK; c += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(ta + i * 32 * kLD + c);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(qb + j * 8 * kLD + c);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
    if (ds != dsteps - 1) continue;

    // the tile is scored: add the bias, then offer each score that beats
    // its query's k-th entry to the query's buffer
    const int r0 = r_begin + tile * kTR + rg;
    {
      const float* bt = bias_s + (tile & 1) * kTR + rg * 8;
      const float4 b0 = *reinterpret_cast<const float4*>(bt);
      const float4 b1 = *reinterpret_cast<const float4*>(bt + 4);
      const float bs[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float bb = r0 + 32 * i < r_end ? bs[i] : -INFINITY;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] += bb;
      }
    }
    // A block's first tile with k <= 32: each thread first puts its best
    // admitted entry per query in slot rg of the query's buffer (32
    // threads, 32 slots), and a flush makes the k-th best of those the
    // threshold, so the rest of the tile meets a warm threshold rather
    // than an empty list. `seeded` keeps which row each thread gave.
    unsigned seeded = 0xffffffffu;  // 4 bits a query; 8: none
    if (tile == 0 && kr <= 32) {
      seeded = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ql = qg + 8 * j;
        int best = 8;
        float bv_ = -INFINITY;
        int bi_ = kNone;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = r0 + 32 * i;
          if (better(acc[i][j], r, bv_, bi_) &&
              admit(acc[i][j], r, ql)) {
            best = i;
            bv_ = acc[i][j];
            bi_ = r;
          }
        }
        seeded |= (unsigned)best << (4 * j);
        bv[ql * CB + rg] = bv_;
        bi[ql * CB + rg] = bi_;
      }
      if (tid < kQB) cnt[tid] = q0 + tid < nq ? 32 : 0;
      __syncthreads();
      flush_all();
    }
    float thv[8];
    int thi[8];
    auto thresholds = [&]() {
      const float4 v0 = *reinterpret_cast<const float4*>(thr_v + qg * 8);
      const float4 v1 = *reinterpret_cast<const float4*>(thr_v + qg * 8 + 4);
      const int4 i0 = *reinterpret_cast<const int4*>(thr_i + qg * 8);
      const int4 i1 = *reinterpret_cast<const int4*>(thr_i + qg * 8 + 4);
      thv[0] = v0.x; thv[1] = v0.y; thv[2] = v0.z; thv[3] = v0.w;
      thv[4] = v1.x; thv[5] = v1.y; thv[6] = v1.z; thv[7] = v1.w;
      thi[0] = i0.x; thi[1] = i0.y; thi[2] = i0.z; thi[3] = i0.w;
      thi[4] = i1.x; thi[5] = i1.y; thi[6] = i1.z; thi[7] = i1.w;
    };
    thresholds();
    unsigned long long pend = 0;
    // first the scores that beat their threshold, as bits (straight-line
    // code, few instructions: after warm-up a tile has almost none), then
    // the inserts, only where there are any
    unsigned long long cand = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const bool ok = better(acc[i][j], r0 + 32 * i, thv[j], thi[j]) &&
                        ((seeded >> (4 * j)) & 15u) != (unsigned)i &&
                        q0 + qg + 8 * j < nq;
        cand |= (unsigned long long)ok << (j * 8 + i);
      }
    }
    if (cand) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!((cand >> (j * 8)) & 0xffu)) continue;
        const int ql = qg + 8 * j;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = r0 + 32 * i;
          const float sc = acc[i][j];
          if (((cand >> (j * 8 + i)) & 1u) &&
              admit(sc, r, ql)) {
            const int pos = atomicAdd(&cnt[ql], 1);
            if (pos < CB) {
              bv[ql * CB + pos] = sc;
              bi[ql * CB + pos] = r;
            } else {
              pend |= 1ull << (j * 8 + i);
            }
          }
        }
      }
    }
    // flush when a buffer overflowed (those candidates wait) or is half
    // full, so that the threshold rises before the next tile
    bool flush = __syncthreads_or(pend != 0 ||
                                  (tid < kQB && 2 * cnt[tid] >= CB));
    while (flush) {
      flush_all();
      thresholds();
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!((pend >> (j * 8)) & 0xffu)) continue;
        const int ql = qg + 8 * j;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const unsigned long long bit = 1ull << (j * 8 + i);
          if (!(pend & bit)) continue;
          const int r = r0 + 32 * i;
          const float sc = acc[i][j];
          if (!better(sc, r, thv[j], thi[j])) {
            pend &= ~bit;
            continue;
          }
          const int pos = atomicAdd(&cnt[ql], 1);
          if (pos < CB) {
            bv[ql * CB + pos] = sc;
            bi[ql * CB + pos] = r;
            pend &= ~bit;
          }
        }
      }
      flush = __syncthreads_or(pend != 0);
    }
  }
  __syncthreads();
  flush_all();
  for (int e = tid; e < kQB * kr; e += kThreads) {
    const int ql = e / kr, x = e - ql * kr;
    const int qq = q0 + ql;
    if (qq < nq) {
      const int64_t off = ((int64_t)qq * kr + x) * n_chunks + chunk;
      pv[off] = lv[ql * L + x];
      pi[off] = li[ql * L + x];
    }
  }
}

// grid Q; block 256: one block per query. Partials (Q, kr, n_chunks),
// each block's list sorted; output row stride ld. The partials are read
// rank by rank: rank 0 alone, then as many whole ranks at a time as 256
// threads cover; a flush (by the whole block) runs when the buffer
// overflows and, while the list is not yet full, after every read, so
// that the threshold is set early.
__global__ void __launch_bounds__(kThreads)
    topk_merge(const float* __restrict__ pv, const int* __restrict__ pi,
               float* __restrict__ ov, int* __restrict__ oi, int ld,
               int n_chunks, int kr) {
  __shared__ float lv[kRoundK], bv[kMergeBuf];
  __shared__ int li[kRoundK], bi[kMergeBuf];
  __shared__ int cnt;
  const int L = list_width(kr);
  const int tid = threadIdx.x;
  const int64_t qq = blockIdx.x;
  for (int e = tid; e < kMergeBuf; e += kThreads) {
    bv[e] = -INFINITY;
    bi[e] = kNone;
    if (e < L) {
      lv[e] = -INFINITY;
      li[e] = kNone;
    }
  }
  if (tid == 0) cnt = 0;
  __syncthreads();
  const float* sv = pv + qq * kr * n_chunks;
  const int* si = pi + qq * kr * n_chunks;
  const int per = max(1, kThreads / n_chunks);  // ranks a read covers
  for (int x0 = 0; x0 < kr; x0 = x0 ? x0 + per : 1) {
    const int end = min(kr, x0 ? x0 + per : 1) * n_chunks;
    bool beat = false;
    for (int e = x0 * n_chunks + tid; e - tid < end; e += kThreads) {
      float thv = lv[kr - 1];
      int thi = li[kr - 1];
      const float v = e < end ? sv[e] : -INFINITY;
      const int i = e < end ? si[e] : kNone;
      bool pend = v > -INFINITY && better(v, i, thv, thi);
      beat |= pend;
      if (pend) {
        const int pos = atomicAdd(&cnt, 1);
        if (pos < kMergeBuf) {
          bv[pos] = v;
          bi[pos] = i;
          pend = false;
        }
      }
      __syncthreads();  // every offer of this read is in
      bool flush = __syncthreads_or(
          pend || (tid == 0 && cnt > 0 && li[kr - 1] == kNone));
      while (flush) {
        flush_block(lv, li, bv, bi, L, min(cnt, kMergeBuf), tid);
        if (tid == 0) cnt = 0;
        __syncthreads();
        thv = lv[kr - 1];
        thi = li[kr - 1];
        if (pend && !better(v, i, thv, thi)) pend = false;
        if (pend) {
          const int pos = atomicAdd(&cnt, 1);
          if (pos < kMergeBuf) {
            bv[pos] = v;
            bi[pos] = i;
            pend = false;
          }
        }
        flush = __syncthreads_or(pend);
      }
    }
    // no entry of these ranks beat the threshold: no later one can
    if (!__syncthreads_or(beat)) break;
  }
  if (cnt > 0) flush_block(lv, li, bv, bi, L, min(cnt, kMergeBuf), tid);
  for (int x = tid; x < kr; x += kThreads) {
    const bool filled = lv[x] > -INFINITY;
    ov[qq * ld + x] = filled ? lv[x] : -INFINITY;
    oi[qq * ld + x] = filled ? li[x] : -1;
  }
}

// Allow both instantiations the largest shared memory a round needs, once
// per device.
cudaError_t allow_smem(int device) {
  static bool done[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!done[device]) {
    const int smem = (int)partial_smem(kRoundK);
    cudaError_t err = cudaFuncSetAttribute(
        topk_partial<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(topk_partial<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    done[device] = true;
  }
  return cudaSuccess;
}

}  // namespace

// Blocks of the first pass resident at once on `device` for a round of kr
// entries (occupancy x SMs), into *out; returns the cudaError_t.
extern "C" int topk_resident(int kr, int device, int* out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (kr < 1 || kr > kRoundK) return (int)cudaErrorInvalidValue;
  err = allow_smem(device);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, topk_partial<true>, kThreads, (size_t)partial_smem(kr));
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  return 0;
}

// One round: q (nq, d), t (n, d), bias (n,) fp32; partials pv/pi
// (nq, kr, n_chunks) with kr <= 128; out ov/oi (nq, kr) at row stride ld;
// floor fv/fi (row stride ld) or null for a first round. Launches
// topk_partial then topk_merge; returns the cudaError_t.
extern "C" int topk_launch(const void* q, const void* t, const void* bias,
                           const void* fv, const void* fi, void* pv, void* pi,
                           void* ov, void* oi, int ld, int nq, int n, int d,
                           int kr, int n_chunks, int rows_per_chunk,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nq <= 0) return 0;
  if (kr < 1 || kr > kRoundK || ld < kr || d < 1 || n_chunks < 1 ||
      rows_per_chunk % kTR || (fv == nullptr) != (fi == nullptr))
    return (int)cudaErrorInvalidValue;
  err = allow_smem(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)partial_smem(kr);
  const dim3 grid1((unsigned)n_chunks, (unsigned)((nq + kQB - 1) / kQB));
  const bool vec = d % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(t)) & 15) == 0;
  auto kern = vec ? topk_partial<true> : topk_partial<false>;
  kern<<<grid1, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(t),
      static_cast<const float*>(bias), static_cast<const float*>(fv),
      static_cast<const int*>(fi), ld, static_cast<float*>(pv),
      static_cast<int*>(pi), nq, n, d, kr, rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  topk_merge<<<(unsigned)nq, kThreads, 0, s>>>(
      static_cast<const float*>(pv), static_cast<const int*>(pi),
      static_cast<float*>(ov), static_cast<int*>(oi), ld, n_chunks, kr);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
