// Row-masked h-index sweep for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_hindex_kernel` / `h_index_pallas`
// (src/repro/kernels/hindex.py, search in `_bisect_h`): per row,
// out = min(max(est, 0), W, H) with H the largest h such that at least h
// valid entries are >= h. Exact integer arithmetic, no sort; equal to the
// sort-based `h_index_ref` bit for bit.
//
// What bounds it on the H100: memory. The least a sweep must move is, for
// each row whose est is above 0, its valid entries (4 bytes each) and its
// mask (1 byte a slot), plus est and out of every row (8 bytes): at 3.35
// TB/s. The arithmetic (a compare or a histogram add per valid entry) is
// far below the FP32/INT32 rate.
//
// Design: each row is read from memory once (a hub row's second level
// reads it again, from the L2), and a row whose est is 0 (the padded rows
// of a sweep) only has its est read. Three paths by W, each exact at every
// W and equal to the TPU kernel's search:
//
// * Narrow rows (W <= 32): a thread per row, a persistent grid striding
//   over the rows. The thread reads est; then the mask (two 16-byte loads
//   at W = 32) and the values of only those groups of 4 slots that hold a
//   valid one (16-byte loads), clamps each valid value to [0, 32] (which
//   keeps count(>= h) for every h <= W) and packs four to a word. The
//   search is a binary search on [0, min(est, W, valid count)] whose probe
//   counts the bytes >= mid of the 8 words with __vcmpgeu4 + popc: no
//   memory read, a few dozen instructions a probe. Thousands of threads an
//   SM keep many loads in flight.
// * Wide rows (W > 32): a warp per row, a persistent grid striding over the
//   rows. One pass reads the mask (16-byte vectors when W % 16 == 0, kept
//   in registers up to W = 2048) and counts the valid slots, so hi =
//   min(est, W, valid count); a second pass over the mask reads the values
//   only in the 16-byte groups that hold a valid slot and counts each
//   valid value >= 1, clamped to hi, into hi + 1 bins of the warp's
//   histogram in shared memory
//   (integer atomics: the counts do not depend on their order). The warp
//   then scans the bins from hi down, 32 a step (lane l takes bin top - l,
//   a shuffle prefix plus the carry of the steps above is count(>= h)), and
//   stops at the first h with count(>= h) >= h: the largest, since
//   count(>= h) - h only grows as h falls. That is the h the binary search
//   of the TPU kernel finds, for every input.
//   Rule: a warp per row at every 32 < W <= h_index_max_width() (the
//   sweeps' rows are many: 4,096 hub rows in the smallest all-node sweep),
//   in blocks of up to 8 warps, as many as the shared memory holds at W + 1
//   bins a warp.
// * Hub rows (W > h_index_max_width(), one warp's W + 1 bins no longer fit
//   a block's shared memory; the serving repair pads a candidate of degree
//   above 32,768 to W = 65,536): a cluster of 4 blocks of 512 threads per
//   row, each block counting a slice of it (a block per row left one SM
//   counting 65,536 slots: 21,000-28,000 clocks a level, clock64 on the
//   card). The search
//   narrows [L, U] = [0, min(est, W)] level by level: each level is one
//   pass over the row that counts the
//   valid values, clamped to min(est, W), that fall in [max(L, 1), U] into
//   kHubBins bins of width s, the least power of two with kHubBins s >=
//   U - L + 1 (a shift, not a division, per value). A suffix scan
//   of the bins, plus the count above U carried from the level before,
//   gives count(>= L + j s) for every bin j; the highest j with count(>= h)
//   >= h at h = L + j s brackets the answer in [L + j s, L + (j + 1) s - 1],
//   the next level's range. A level with s = 1 ends the search exactly. At
//   kHubBins = 1,024 a row of W < 2^20 takes two levels (W = 65,536: bins
//   of 128, then of 1), so it is read once from memory and once more from
//   the L2, where the TPU kernel's binary search reads it ceil(log2(W + 1))
//   times. The counts are integer atomics in shared memory (their order
//   cannot change them), and the rows' values crowd into few bins (a hub's
//   neighbours hold a few small core numbers; every value above est lands
//   in the top bin): so each warp counts into bins of its own, offset by a
//   word so that the warps' same bins sit in different banks, a thread adds
//   a run of equal bins once; the warps' bins are summed, then every block
//   sums the cluster's blocks' bins through distributed shared memory and
//   runs the same scan (the same answer in each, no atomics across
//   blocks). Each thread loads the masks of 4 groups of 16 slots, then the
//   values of their words with a valid slot, before it counts any. Hub rows
//   are few (one per hub candidate), so a cluster per row fills the card
//   only for sweeps of many hubs; above 4,096 rows the clusters loop.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;  // shared memory a block may use
constexpr int kHeld = 4;  // 512-slot chunks of a wide row's mask a warp
                          // keeps in registers between its two passes
constexpr int kMaxDevices = 64;
constexpr int kHubThreads = 512;
constexpr int kHubWarps = kHubThreads / 32;
constexpr int kHubBins = 1024;  // a level's bins
constexpr int kHubStride = kHubBins + 1;  // a warp's own bins, bank-offset
constexpr int kHubChunk = kHubBins / kHubWarps;  // bins a warp scans
constexpr int kHubUnroll = 4;  // 16-slot groups a thread loads at once
// blocks a hub row is cut over, a cluster. One live row of W = 65,536
// among 64 (the serving repair's hub tier): 0.0275 / 0.0241 / 0.0179 /
// 0.0160 ms at 1 / 2 / 4 / 8 blocks; 64 live rows: 0.0391 / 0.0257 /
// 0.0428 / 0.0703 ms (H100, 700 W): 4 keeps most of the gain on the
// one-hub sweep without the waves of clusters that 8 costs on many rows
constexpr int kHubSplit = 4;
constexpr int kHubMaxClusters = 4096;  // a larger R loops over its rows
// the warps' bins, the block's and the cluster's summed bins
constexpr int kHubSmem = 4 * (kHubWarps * kHubStride + 2 * kHubBins);

// Narrow rows (W <= 32): a thread per row. The row's valid values, each
// clamped to [0, 32] (which keeps count(>= h) for every h <= W), are
// packed four to a 32-bit word; a probe counts the bytes >= mid with
// __vcmpgeu4 + popc over the 8 words. kVec: W is 16 or 32 and the rows are
// 16-byte aligned: the mask in 16-byte vectors, then the values in 16-byte
// vectors, only those groups of 4 slots that hold a valid one.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    h_index_narrow(const int32_t* __restrict__ vals,
                   const uint8_t* __restrict__ valid,
                   const int32_t* __restrict__ est, int32_t* __restrict__ out,
                   int64_t r, int w) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; row < r;
       row += stride) {
    const int e = est[row];
    if (e <= 0) {  // a padded row: nothing else is read
      out[row] = 0;
      continue;
    }
    unsigned packed[8];
    int nv = 0;
    const int32_t* v = vals + row * w;
    const uint8_t* m = valid + row * w;
    if constexpr (kVec) {
      unsigned mw[8];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint4 mm = make_uint4(0u, 0u, 0u, 0u);
        if (h * 16 < w) mm = *reinterpret_cast<const uint4*>(m + 16 * h);
        mw[4 * h] = mm.x;
        mw[4 * h + 1] = mm.y;
        mw[4 * h + 2] = mm.z;
        mw[4 * h + 3] = mm.w;
      }
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const unsigned nz = __vcmpne4(mw[g], 0u);  // 0xff per valid slot
        nv += __popc(nz);
        packed[g] = 0u;
        if (nz) {
          const int4 x = *reinterpret_cast<const int4*>(v + 4 * g);
          const unsigned b = (unsigned)min(max(x.x, 0), 32) |
                             (unsigned)min(max(x.y, 0), 32) << 8 |
                             (unsigned)min(max(x.z, 0), 32) << 16 |
                             (unsigned)min(max(x.w, 0), 32) << 24;
          packed[g] = b & nz;
        }
      }
      nv >>= 3;
    } else {
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        packed[g] = 0u;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int j = 4 * g + u;
          if (j < w && m[j]) {
            ++nv;
            packed[g] |= (unsigned)min(max(v[j], 0), 32) << (8 * u);
          }
        }
      }
    }
    int lo = 0;
    int hi = min(min(e, w), nv);
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      const unsigned rep = 0x01010101u * (unsigned)mid;
      int c = 0;
#pragma unroll
      for (int g = 0; g < 8; ++g) c += __popc(__vcmpgeu4(packed[g], rep));
      if ((c >> 3) >= mid) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    out[row] = lo;
  }
}

// Count a valid value into the bins (values below 1 count for no h >= 1).
__device__ __forceinline__ void bin(int* bins, int x, int hi) {
  if (x >= 1) atomicAdd(&bins[min(x, hi)], 1);
}

// kVec: W % 16 == 0 and both rows 16-byte aligned (vector loads).
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
    h_index_wide(const int32_t* __restrict__ vals,
                 const uint8_t* __restrict__ valid,
                 const int32_t* __restrict__ est, int32_t* __restrict__ out,
                 int64_t r, int w) {
  extern __shared__ int bins_all[];
  const int lane = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  int* bins = bins_all + (threadIdx.x >> 5) * (w + 1);
  const int64_t stride = (int64_t)gridDim.x * wpb;
  for (int64_t row = (int64_t)blockIdx.x * wpb + (threadIdx.x >> 5); row < r;
       row += stride) {
    int hi = min(est[row], w);
    if (hi <= 0) {
      if (lane == 0) out[row] = 0;
      continue;
    }
    const uint8_t* m = valid + row * w;
    const int32_t* v = vals + row * w;
    int nv = 0;
    uint4 mreg[kHeld];  // the first kHeld x 512 slots' mask, kept
    if constexpr (kVec) {
#pragma unroll
      for (int c = 0; c < kHeld; ++c) {
        const int j = lane * 16 + 512 * c;
        mreg[c] = j < w ? *reinterpret_cast<const uint4*>(m + j)
                        : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int c = 0; c < kHeld; ++c)
        nv += __popc(__vcmpne4(mreg[c].x, 0u)) +
              __popc(__vcmpne4(mreg[c].y, 0u)) +
              __popc(__vcmpne4(mreg[c].z, 0u)) +
              __popc(__vcmpne4(mreg[c].w, 0u));
      for (int j = lane * 16 + 512 * kHeld; j < w; j += 512) {
        const uint4 mm = *reinterpret_cast<const uint4*>(m + j);
        nv += __popc(__vcmpne4(mm.x, 0u)) + __popc(__vcmpne4(mm.y, 0u)) +
              __popc(__vcmpne4(mm.z, 0u)) + __popc(__vcmpne4(mm.w, 0u));
      }
      nv >>= 3;
    } else {
      for (int j = lane; j < w; j += 32) nv += m[j] != 0;
    }
    hi = min(hi, __reduce_add_sync(kFull, nv));
    if (hi <= 0) {
      if (lane == 0) out[row] = 0;
      continue;
    }
    for (int b = lane; b <= hi; b += 32) bins[b] = 0;
    __syncwarp();
    if constexpr (kVec) {
      for (int j = lane * 16, c = 0; j < w; j += 512, ++c) {
        uint4 mm;
        if (c < kHeld) {
#pragma unroll
          for (int u = 0; u < kHeld; ++u)
            if (u == c) mm = mreg[u];
        } else {
          mm = *reinterpret_cast<const uint4*>(m + j);
        }
        const unsigned words[4] = {mm.x, mm.y, mm.z, mm.w};
#pragma unroll
        for (int qd = 0; qd < 4; ++qd) {
          if (!words[qd]) continue;
          const int4 x = *reinterpret_cast<const int4*>(v + j + 4 * qd);
          if (words[qd] & 0xffu) bin(bins, x.x, hi);
          if (words[qd] & 0xff00u) bin(bins, x.y, hi);
          if (words[qd] & 0xff0000u) bin(bins, x.z, hi);
          if (words[qd] & 0xff000000u) bin(bins, x.w, hi);
        }
      }
    } else {
      for (int j = lane; j < w; j += 32)
        if (m[j]) bin(bins, v[j], hi);
    }
    __syncwarp();
    int h_out = 0, carry = 0;
    for (int top = hi; top >= 1; top -= 32) {
      const int h = top - lane;
      int c = h >= 1 ? bins[h] : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, c, o);
        if (lane >= o) c += y;
      }
      const int cum = carry + c;  // count(>= h)
      const unsigned ok = __ballot_sync(kFull, h >= 1 && cum >= h);
      if (ok) {
        h_out = top - (__ffs(ok) - 1);
        break;
      }
      carry = __shfl_sync(kFull, cum, 31);
    }
    if (lane == 0) out[row] = h_out;
    __syncwarp();  // the bins are the next row's
  }
}

// A thread's run of equal bins of a hub level, added to its warp's bins
// when the bin changes (and once at the end of the pass).
struct Run {
  int bin = -1, n = 0;
  __device__ __forceinline__ void add(int* own, int b) {
    if (b == bin) {
      ++n;
      return;
    }
    if (n) atomicAdd(&own[bin], n);
    bin = b;
    n = 1;
  }
  __device__ __forceinline__ void flush(int* own) {
    if (n) atomicAdd(&own[bin], n);
  }
};

// One valid value of a hub row at a level: clamped to hi, counted when it
// lies in [max(lo, 1), up], in bin (x - lo) >> shift.
__device__ __forceinline__ void hub_count(Run& run, int* own, int x, int hi,
                                          int lo, int up, int shift) {
  x = min(x, hi);
  if (x >= 1 && x >= lo && x <= up) run.add(own, (x - lo) >> shift);
}

// kVec: W % 16 == 0 and both rows 16-byte aligned (vector loads).
template <bool kVec>
__global__ void __launch_bounds__(kHubThreads)
    h_index_hub(const int32_t* __restrict__ vals,
                const uint8_t* __restrict__ valid,
                const int32_t* __restrict__ est, int32_t* __restrict__ out,
                int64_t r, int w) {
  extern __shared__ int smem[];
  int* bins = smem + kHubWarps * kHubStride;  // this block's bins, summed
  int* total = bins + kHubBins;               // the cluster's
  __shared__ int warp_total[kHubWarps];
  __shared__ int best_bin, best_above;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  int* own = smem + warp * kHubStride;  // this warp's bins
  // this block's slice of a row: kHubSplit slices, each a multiple of 16
  const int per = (w + kHubSplit * 16 - 1) / (kHubSplit * 16) * 16;
  const int begin = min(w, rank * per), end = min(w, begin + per);
  const int64_t clusters = gridDim.x / kHubSplit;
  for (int64_t row = blockIdx.x / kHubSplit; row < r; row += clusters) {
    const int hi = min(max(est[row], 0), w);  // the same in every block
    if (hi <= 0) {  // a padded row: nothing else is read
      if (tid == 0 && rank == 0) out[row] = 0;
      continue;
    }
    const uint8_t* m = valid + row * w;
    const int32_t* v = vals + row * w;
    // invariant: the answer lies in [lo, up]; count(>= lo) >= lo holds
    // (lo = 0, or a level proved it); above = count(>= up + 1)
    int lo = 0, up = hi, above = 0;
    while (true) {
      // bins of width 2^shift, the least power of two that covers the range
      int shift = 0;
      while (((int64_t)kHubBins << shift) < (int64_t)up - lo + 1) ++shift;
      const int width = 1 << shift;
      for (int b = tid; b < kHubWarps * kHubStride; b += kHubThreads)
        smem[b] = 0;
      if (tid == 0) best_bin = -1;
      __syncthreads();
      Run run;
      if constexpr (kVec) {
        constexpr int kStep = kHubThreads * 16;
        for (int j0 = begin + tid * 16; j0 < end; j0 += kStep * kHubUnroll) {
          unsigned words[kHubUnroll][4];
#pragma unroll
          for (int u = 0; u < kHubUnroll; ++u) {
            const int j = j0 + u * kStep;
            const uint4 mm = j < end ? *reinterpret_cast<const uint4*>(m + j)
                                     : make_uint4(0u, 0u, 0u, 0u);
            words[u][0] = mm.x, words[u][1] = mm.y, words[u][2] = mm.z,
            words[u][3] = mm.w;
          }
          int4 x[kHubUnroll][4];
#pragma unroll
          for (int u = 0; u < kHubUnroll; ++u)
#pragma unroll
            for (int qd = 0; qd < 4; ++qd)
              x[u][qd] = words[u][qd] ? *reinterpret_cast<const int4*>(
                                            v + j0 + u * kStep + 4 * qd)
                                      : make_int4(0, 0, 0, 0);
#pragma unroll
          for (int u = 0; u < kHubUnroll; ++u)
#pragma unroll
            for (int qd = 0; qd < 4; ++qd) {
              const unsigned wd = words[u][qd];
              if (!wd) continue;
              const int4 y = x[u][qd];
              if (wd & 0xffu) hub_count(run, own, y.x, hi, lo, up, shift);
              if (wd & 0xff00u) hub_count(run, own, y.y, hi, lo, up, shift);
              if (wd & 0xff0000u)
                hub_count(run, own, y.z, hi, lo, up, shift);
              if (wd & 0xff000000u)
                hub_count(run, own, y.w, hi, lo, up, shift);
            }
        }
      } else {
        for (int j = begin + tid; j < end; j += kHubThreads)
          if (m[j]) hub_count(run, own, v[j], hi, lo, up, shift);
      }
      run.flush(own);
      __syncthreads();
      for (int b = tid; b < kHubBins; b += kHubThreads) {
        int sum = 0;
#pragma unroll
        for (int u = 0; u < kHubWarps; ++u) sum += smem[u * kHubStride + b];
        bins[b] = sum;
      }
      cluster.sync();  // every block's bins are summed
      for (int b = tid; b < kHubBins; b += kHubThreads) {
        int sum = 0;
#pragma unroll
        for (int q = 0; q < kHubSplit; ++q)
          sum += cluster.map_shared_rank(bins, q)[b];
        total[b] = sum;
      }
      // every block has read the others' bins (they are rewritten only
      // after the next level's pass), and its total is complete
      cluster.sync();
      // warp u scans bins [u C, (u + 1) C) (consecutive lanes on
      // consecutive bins): first their count, then from the top down 32 a
      // step, lane l on bin top - l, an inclusive prefix over the lanes
      // plus the carry from above giving count(>= h)
      const int first = warp * kHubChunk;
      int mine = 0;
      for (int b = first + lane; b < first + kHubChunk; b += 32)
        mine += total[b];
      mine = __reduce_add_sync(kFull, mine);
      if (lane == 0) warp_total[warp] = mine;
      __syncthreads();
      int carry = above;  // count(>= lo + (first + C) width)
      for (int u = warp + 1; u < kHubWarps; ++u) carry += warp_total[u];
      int found = -1, found_above = 0;
      for (int top = first + kHubChunk - 1; top >= first; top -= 32) {
        const int b = top - lane;
        const int bin_count = total[b];
        int c = bin_count;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(kFull, c, o);
          if (lane >= o) c += y;
        }
        const int cum = carry + c;  // count(>= lo + b width)
        const int64_t h = lo + (int64_t)b * width;
        // bin 0: h = lo, which holds by the invariant
        const unsigned ok =
            __ballot_sync(kFull, h <= up && (b == 0 || cum >= h));
        if (ok) {
          const int l = __ffs(ok) - 1;
          found = top - l;
          found_above = __shfl_sync(kFull, cum - bin_count, l);
          break;
        }
        carry = __shfl_sync(kFull, cum, 31);
      }
      if (lane) found = -1;  // one report a warp
      if (found >= 0) atomicMax(&best_bin, found);
      __syncthreads();
      if (found >= 0 && found == best_bin) best_above = found_above;
      __syncthreads();
      const int j = best_bin;
      const int new_above = best_above;
      __syncthreads();  // every thread has read them before the next level
      if (width == 1) {
        lo += j;
        break;
      }
      up = min(up, (int)(lo + (int64_t)(j + 1) * width - 1));
      lo += j * width;
      above = new_above;
    }
    if (tid == 0 && rank == 0) out[row] = lo;
  }
}

// Warps a block of the wide kernel holds at width w (0: w too wide).
int wide_warps(int w) {
  const long long per_warp = 4LL * (w + 1);
  const long long fit = kSmemLimit / per_warp;
  return fit < kWarps ? (int)fit : kWarps;
}

// Resident blocks (occupancy x SMs) of `kern` at `threads` and `smem`.
// The launcher keeps them per device: the narrow kernel's, and the wide
// kernel's at the last width seen.
template <typename K>
cudaError_t resident(K kern, int threads, int smem, int device, int* out) {
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kern, threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  return cudaSuccess;
}

}  // namespace

// The widest row of the wide (shared-memory histogram) kernel: the bins of
// one warp fill the shared memory of a block. Wider rows take the hub
// kernel.
extern "C" int h_index_max_width() { return kSmemLimit / 4 - 1; }

// Returns the cudaError_t of the launch.
extern "C" int h_index_launch(const void* vals, const void* valid,
                              const void* est, void* out, long long r, int w,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (r <= 0) return 0;
  if (device < 0 || device >= kMaxDevices || w < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* v = static_cast<const int32_t*>(vals);
  const auto* m = static_cast<const uint8_t*>(valid);
  const auto* e = static_cast<const int32_t*>(est);
  auto* o = static_cast<int32_t*>(out);
  if (w <= 32) {
    const bool vec = (w == 16 || w == 32) &&
                     ((reinterpret_cast<uintptr_t>(vals) |
                       reinterpret_cast<uintptr_t>(valid)) & 15) == 0;
    auto kern = vec ? h_index_narrow<true> : h_index_narrow<false>;
    static int narrow_resident[kMaxDevices][2];
    if (!narrow_resident[device][vec]) {
      err = resident(kern, kThreads, 0, device, &narrow_resident[device][vec]);
      if (err != cudaSuccess) return (int)err;
    }
    long long blocks = (r + kThreads - 1) / kThreads;
    if (blocks > narrow_resident[device][vec])
      blocks = narrow_resident[device][vec];
    kern<<<(unsigned)blocks, kThreads, 0, s>>>(v, m, e, o, r, w);
    return (int)cudaGetLastError();
  }
  if (w > h_index_max_width()) {  // hub rows: a cluster per row
    const bool vec = w % 16 == 0 &&
                     ((reinterpret_cast<uintptr_t>(vals) |
                       reinterpret_cast<uintptr_t>(valid)) & 15) == 0;
    auto kern = vec ? h_index_hub<true> : h_index_hub<false>;
    static bool hub_ready[kMaxDevices][2];
    if (!hub_ready[device][vec]) {
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kHubSmem);
      if (err != cudaSuccess) return (int)err;
      hub_ready[device][vec] = true;
    }
    const long long clusters = r < kHubMaxClusters ? r : kHubMaxClusters;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(clusters * kHubSplit));
    cfg.blockDim = dim3(kHubThreads);
    cfg.dynamicSmemBytes = kHubSmem;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kHubSplit;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kern, v, m, e, o, r, w);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
  }
  const int wpb = wide_warps(w);
  if (wpb < 1) return (int)cudaErrorInvalidValue;
  const int smem = wpb * 4 * (w + 1);
  const bool vec = w % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(vals) |
                     reinterpret_cast<uintptr_t>(valid)) & 15) == 0;
  auto kern = vec ? h_index_wide<true> : h_index_wide<false>;
  static bool allowed[kMaxDevices];
  if (!allowed[device]) {
    err = cudaFuncSetAttribute(h_index_wide<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(h_index_wide<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemLimit);
    if (err != cudaSuccess) return (int)err;
    allowed[device] = true;
  }
  static int last_key[kMaxDevices], last_resident[kMaxDevices];
  const int key = 2 * w + vec;  // > 0: w > 32
  if (last_key[device] != key) {
    err = resident(kern, 32 * wpb, smem, device, &last_resident[device]);
    if (err != cudaSuccess) return (int)err;
    last_key[device] = key;
  }
  long long blocks = (r + wpb - 1) / wpb;
  if (blocks > last_resident[device]) blocks = last_resident[device];
  kern<<<(unsigned)blocks, 32 * wpb, smem, s>>>(v, m, e, o, r, w);
  return (int)cudaGetLastError();
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
