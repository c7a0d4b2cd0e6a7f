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
// Design: each row is read from memory once, and a row whose est is 0 (the
// padded rows of a sweep) only has its est read.
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
//   Rule: a warp per row at every W > 32 (the sweeps' rows are many: 4,096
//   hub rows in the smallest all-node sweep), in blocks of up to 8 warps,
//   as many as the shared memory holds at W + 1 bins a warp; the wrapper
//   refuses a W whose bins do not fit one warp (h_index_max_width()).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 232448;  // shared memory a block may use
constexpr int kHeld = 4;  // 512-slot chunks of a wide row's mask a warp
                          // keeps in registers between its two passes
constexpr int kMaxDevices = 64;

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

// The widest row the kernel takes: the bins of one warp fill the shared
// memory of a block.
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
