// Streaming score + top-k for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_topk_kernel` / `topk_pallas`
// (src/repro/kernels/topk.py): per query, the k rows of `table` with the
// highest score q . t + bias[t] under the total order (score desc, index
// asc), bias being 0 for live rows and -inf for dead ones. The (Q, N) score
// matrix is never written to memory.
//
// What bounds it on the H100: at the serving shapes (Q = 64, D = 128) the
// fp32 dot products, 2 * Q * N * D operations on the CUDA cores (no tensor
// cores: TF32 would move scores by ~1e-3 and reorder near-ties against the
// fp32 reference), sit just above one read of the table (N * D * 4 bytes).
//
// Design. The TPU kernel carries a running (Q, k) accumulator across a
// sequential grid over table blocks; Hopper blocks run in parallel and in no
// order, so the work is split in two passes:
//
// * pass 1 (`topk_partial`): a block takes 64 queries and one chunk of table
//   rows. The queries stay in shared memory; the chunk streams through
//   shared memory in 64-row tiles. Each warp owns 8 queries and each lane
//   scores 2 rows of the tile against them with FFMA from float4 shared
//   loads (rows padded by 4 floats, so the lanes of a float4 phase hit
//   distinct banks). Every query keeps a sorted running top-k in the
//   registers of its warp, entry e in lane e. A tile's candidates are first
//   tested against the current k-th entry, and only the few that beat it
//   are inserted (one ballot for the insert position, one shuffle to shift),
//   so after warm-up a tile costs little beyond its dot products. The block
//   writes its (64, k) partial, sorted.
// * pass 2 (`topk_merge`): one warp per query merges the (chunks * k)
//   partials with the same threshold-and-insert step and writes the final
//   (Q, k) list, already sorted; unfilled entries are -inf / -1.
//
// Ties break toward the lower row index in every comparison, so the result
// is the exact top-k of the scores the kernel computed, whatever the order
// in which blocks and candidates arrive.
//
// k of any size: a warp keeps at most 32 entries (one per lane), so one
// launch pair gives one *round* of at most 32 entries, and a larger k runs
// ceil(k / 32) rounds. Round r > 0 takes a floor per query, the last entry
// of round r - 1, and admits only candidates strictly after it in the
// (score desc, index asc) order; so the rounds are consecutive slices of one
// sorted list, each written at its column offset of the (Q, k) output. A
// floor that is an empty entry (index -1: fewer live rows than the earlier
// rounds asked for) admits nothing. Each round streams the table again.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kQB = 64;   // queries per block
constexpr int kTN = 64;   // table rows per tile
constexpr int kWarps = 8;
constexpr int kQW = kQB / kWarps;  // queries per warp
constexpr int kNone = 0x7fffffff;  // index of an empty entry
constexpr int kNoFloor = -2;       // floor index of a first round

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Insert (cv, ci) into the warp's sorted list (entry e held by lane e < k);
// a candidate that no longer beats the k-th entry is dropped.
__device__ __forceinline__ void warp_insert(float& v, int& i, float cv, int ci,
                                            int k, int lane) {
  const int pos =
      __popc(__ballot_sync(kFull, lane < k && better(v, i, cv, ci)));
  const float uv = __shfl_up_sync(kFull, v, 1);
  const int ui = __shfl_up_sync(kFull, i, 1);
  if (pos >= k) return;
  if (lane == pos) {
    v = cv;
    i = ci;
  } else if (lane > pos && lane < k) {
    v = uv;
    i = ui;
  }
}

// Candidate (s, r) may enter this round: a live row and, when the round has
// a floor (fi > kNoFloor), strictly after the floor entry (fv, fi).
__device__ __forceinline__ bool admit(float s, int r, float fv, int fi) {
  return s > -INFINITY && (fi == kNoFloor || (fi >= 0 && better(fv, fi, s, r)));
}

// Offer one candidate per lane to the list; only admitted ones beating the
// k-th entry go through an insert.
__device__ __forceinline__ void offer(float& v, int& i, float s, int r,
                                      bool ok, int k, int lane) {
  const float tv = __shfl_sync(kFull, v, k - 1);
  const int ti = __shfl_sync(kFull, i, k - 1);
  unsigned mask = __ballot_sync(kFull, ok && better(s, r, tv, ti));
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    warp_insert(v, i, __shfl_sync(kFull, s, src), __shfl_sync(kFull, r, src),
                k, lane);
  }
}

// grid (n_chunks, ceil(Q / 64)); block 256; dynamic shared memory
// (64 + 64) * dp floats. Partials are (Q, n_chunks, k). fv / fi: the floor
// of each query (row stride ld), null in a first round.
__global__ void __launch_bounds__(256)
    topk_partial(const float* __restrict__ q, const float* __restrict__ t,
                 const float* __restrict__ bias, const float* __restrict__ fv,
                 const int* __restrict__ fi, int ld, float* __restrict__ pv,
                 int* __restrict__ pi, int nq, int n, int d, int dp, int k,
                 int rows_per_chunk) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ts = qs + kQB * dp;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = blockIdx.y * kQB;
  const int chunk = blockIdx.x;
  const int n_chunks = gridDim.x;
  const int r_begin = chunk * rows_per_chunk;
  const int r_end = min(n, r_begin + rows_per_chunk);

  for (int e = threadIdx.x; e < kQB * dp; e += blockDim.x) {
    const int qq = e / dp, c = e - qq * dp;
    qs[e] = (q0 + qq < nq && c < d) ? q[(int64_t)(q0 + qq) * d + c] : 0.f;
  }
  float lv[kQW], flv[kQW];
  int li[kQW], fli[kQW];
#pragma unroll
  for (int u = 0; u < kQW; ++u) {
    lv[u] = -INFINITY;
    li[u] = kNone;
    const int qq = q0 + warp * kQW + u;
    flv[u] = (fv && qq < nq) ? fv[(int64_t)qq * ld] : INFINITY;
    fli[u] = (fi && qq < nq) ? fi[(int64_t)qq * ld] : kNoFloor;
  }

  for (int r0 = r_begin; r0 < r_end; r0 += kTN) {
    __syncthreads();  // the previous tile is consumed
    for (int e = threadIdx.x; e < kTN * dp; e += blockDim.x) {
      const int rr = e / dp, c = e - rr * dp;
      const int r = r0 + rr;
      ts[e] = (r < r_end && c < d) ? t[(int64_t)r * d + c] : 0.f;
    }
    __syncthreads();

    float acc0[kQW], acc1[kQW];
#pragma unroll
    for (int u = 0; u < kQW; ++u) acc0[u] = acc1[u] = 0.f;
    const float4* ta = reinterpret_cast<const float4*>(ts + lane * dp);
    const float4* tb = reinterpret_cast<const float4*>(ts + (lane + 32) * dp);
    const float4* qw =
        reinterpret_cast<const float4*>(qs + warp * kQW * dp);
    const int dp4 = dp >> 2;
    for (int c = 0; c < dp4; ++c) {
      const float4 a = ta[c];
      const float4 b = tb[c];
#pragma unroll
      for (int u = 0; u < kQW; ++u) {
        const float4 x = qw[u * dp4 + c];
        acc0[u] = fmaf(a.x, x.x, acc0[u]);
        acc0[u] = fmaf(a.y, x.y, acc0[u]);
        acc0[u] = fmaf(a.z, x.z, acc0[u]);
        acc0[u] = fmaf(a.w, x.w, acc0[u]);
        acc1[u] = fmaf(b.x, x.x, acc1[u]);
        acc1[u] = fmaf(b.y, x.y, acc1[u]);
        acc1[u] = fmaf(b.z, x.z, acc1[u]);
        acc1[u] = fmaf(b.w, x.w, acc1[u]);
      }
    }

    const int ra = r0 + lane, rb = r0 + lane + 32;
    const float ba = ra < r_end ? bias[ra] : -INFINITY;
    const float bb = rb < r_end ? bias[rb] : -INFINITY;
#pragma unroll
    for (int u = 0; u < kQW; ++u) {
      if (q0 + warp * kQW + u >= nq) continue;  // warp-uniform
      const float sa = acc0[u] + ba, sb = acc1[u] + bb;
      offer(lv[u], li[u], sa, ra, admit(sa, ra, flv[u], fli[u]), k, lane);
      offer(lv[u], li[u], sb, rb, admit(sb, rb, flv[u], fli[u]), k, lane);
    }
  }

#pragma unroll
  for (int u = 0; u < kQW; ++u) {
    const int qq = q0 + warp * kQW + u;
    if (qq < nq && lane < k) {
      const int64_t off = ((int64_t)qq * n_chunks + chunk) * k + lane;
      pv[off] = lv[u];
      pi[off] = li[u];
    }
  }
}

// grid ceil(Q / 8); block 256: one warp per query. Output row stride ld.
__global__ void __launch_bounds__(256)
    topk_merge(const float* __restrict__ pv, const int* __restrict__ pi,
               float* __restrict__ ov, int* __restrict__ oi, int ld, int nq,
               int total, int k) {
  const int lane = threadIdx.x & 31;
  const int qq = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (qq >= nq) return;
  float v = -INFINITY;
  int i = kNone;
  const float* sv = pv + (int64_t)qq * total;
  const int* si = pi + (int64_t)qq * total;
  for (int e0 = 0; e0 < total; e0 += 32) {
    const int e = e0 + lane;
    const float cv = e < total ? sv[e] : -INFINITY;
    const int ci = e < total ? si[e] : kNone;
    offer(v, i, cv, ci, cv > -INFINITY, k, lane);  // partials obey the floor
  }
  if (lane < k) {
    const bool filled = v > -INFINITY;
    ov[(int64_t)qq * ld + lane] = filled ? v : -INFINITY;
    oi[(int64_t)qq * ld + lane] = filled ? i : -1;
  }
}

}  // namespace

// Shared memory the first pass needs for a (padded) row width dp.
extern "C" long long topk_smem_bytes(int dp) {
  return (long long)(kQB + kTN) * dp * (long long)sizeof(float);
}

extern "C" int topk_rows_per_tile() { return kTN; }

// One round: q (nq, d), t (n, d), bias (n,) fp32; partials pv/pi
// (nq, n_chunks, k) with k <= 32; out ov/oi (nq, k) at row stride ld; floor
// fv/fi (row stride ld) or null for a first round. dp is padded_width(d) of
// the wrapper. Launches topk_partial then topk_merge; returns the
// cudaError_t.
extern "C" int topk_launch(const void* q, const void* t, const void* bias,
                           const void* fv, const void* fi, void* pv, void* pi,
                           void* ov, void* oi, int ld, int nq, int n, int d,
                           int dp, int k, int n_chunks, int rows_per_chunk,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (nq <= 0) return 0;
  if (k < 1 || k > 32 || ld < k || dp % 4 || dp < d ||
      (fv == nullptr) != (fi == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)topk_smem_bytes(dp);
  err = cudaFuncSetAttribute(topk_partial,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid1((unsigned)n_chunks, (unsigned)((nq + kQB - 1) / kQB));
  topk_partial<<<grid1, 32 * kWarps, smem, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(t),
      static_cast<const float*>(bias), static_cast<const float*>(fv),
      static_cast<const int*>(fi), ld, static_cast<float*>(pv),
      static_cast<int*>(pi), nq, n, d, dp, k, rows_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2((unsigned)((nq + kWarps - 1) / kWarps));
  topk_merge<<<grid2, 32 * kWarps, 0, s>>>(
      static_cast<const float*>(pv), static_cast<const int*>(pi),
      static_cast<float*>(ov), static_cast<int*>(oi), ld, nq, n_chunks * k,
      k);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
