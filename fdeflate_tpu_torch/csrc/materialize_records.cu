// K13 materialize_records: the sequential path's K4 records -> output
// bytes and the next window, a block per lane.
//
// Replaces no TPU kernel: JAX's materialize (fdeflate_tpu/ops/inflate.py)
// is an XLA routine, pointer doubling over [lanes, 32768 + cap] int64
// arrays, and the port ran it as ~60 torch ops, two `nonzero`s and up to 17
// gather passes, each pass ending in a host sync.  On the sequential path
// (ops/inflate.decompress_sequential) a round's records hold the whole
// history of every lane: its 32 KiB window, then the records in order.
// That is the one case in which nothing has to be found by doubling: every
// source byte of a match lies before the match's start, so a lane that
// walks its matches in record order copies each from bytes already final.
//
// Bound on the H100: records, window, bytes and new window in and out over
// 3.35 TB/s, microseconds a round.  In practice the serial chain of
// matches holds it: a match may read the bytes the match before it wrote.
// The design keeps that chain in shared memory and off the host:
//   * a block takes a lane; [window | out] lives in its shared memory when
//     it fits (32768 + cap + 8 K + 128 bytes within the block's 227 KB: cap
//     <= 131072 at K = 8192), else in a scratch row in device memory that
//     the wrapper allocates;
//   * its 512 threads read 16 consecutive records each, one block-wide
//     exclusive scan gives every record its first byte and every match its
//     place in a compacted list; literals land at once, in parallel;
//   * the matches go in rounds.  A round takes the next 32 matches; one
//     is ready when its source range [start - d, start - d + min(d, len))
//     meets no earlier match of the round (a 5-step search over the round's
//     starts by shuffles, then one compare).  The ready prefix, at most 16,
//     copies at once, a warp a match, byte i from start - d + (i mod d);
//     then one __syncthreads.  Literal runs and long distances make most
//     matches ready; a run of chained short copies costs a round each;
//   * the same launch writes out[:cap] (zero past `produced`) and the new
//     window, the last 32 KiB of [window | out[:produced]].
// One launch a round; the host waits on nothing until it reads the bytes.
#include <atomic>

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWindow = 32768;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;                    // records a thread per group
constexpr int kGroup = kThreads * kPer;     // records a block scans at once
constexpr int kScanBytes = 8 * kWarps;      // the scan's warp sums
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kRecLits = 1, kRecMatch = 2;  // record kinds (bits 28..31)

// Bytes record `w` makes, with 1 << 32 added for a match.
__device__ __forceinline__ unsigned long long rec_step(uint32_t w) {
  const uint32_t kind = w >> 28;
  if (kind == kRecLits) return (w >> 16) & 3;
  if (kind == kRecMatch) return (1ull << 32) | (((w >> 15) & 0xFF) + 3);
  return 0;
}

// Exclusive scan of v over the block; *total gets the sum.  wsum holds
// kWarps values.  Every thread of the block calls it.
__device__ unsigned long long block_scan(unsigned long long v,
                                         unsigned long long* wsum,
                                         unsigned long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    unsigned long long s = lane < kWarps ? wsum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < kWarps) wsum[lane] = s;
  }
  __syncthreads();
  *total = wsum[kWarps - 1];
  const unsigned long long ex = (warp ? wsum[warp - 1] : 0) + x - v;
  __syncthreads();
  return ex;
}

// Lane blockIdx.x of K records (recs[u * L + lane]), window u8[32768],
// produced bytes P: out u8[cap] and new_window u8[32768].  kShared: the
// working bytes [window | out] in shared memory, else in scratch's row.
template <bool kShared>
__global__ void __launch_bounds__(kThreads, 1)
materialize_kernel(const int32_t* __restrict__ recs,
                   const uint8_t* __restrict__ window,
                   const int64_t* __restrict__ produced,
                   uint8_t* __restrict__ out, uint8_t* __restrict__ new_window,
                   uint8_t* scratch, int L, int K, int cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = blockIdx.x, tid = threadIdx.x;
  const int t = tid & 31, warp = tid >> 5;
  const int ext = kWindow + cap;
  unsigned long long* wsum = reinterpret_cast<unsigned long long*>(smem);
  uint8_t* buf = kShared ? smem + kScanBytes
                         : scratch + static_cast<int64_t>(lane) * ext;
  int32_t* mpos =
      reinterpret_cast<int32_t*>(smem + kScanBytes + (kShared ? ext : 0));
  uint32_t* mrec = reinterpret_cast<uint32_t*>(mpos + K);
  const int64_t P = produced[lane];
  const int lim = P <= 0 ? 0 : (P >= cap ? cap : static_cast<int>(P));

  const uint32_t* wsrc =
      reinterpret_cast<const uint32_t*>(window + static_cast<int64_t>(lane) *
                                                     kWindow);
  for (int i = tid; i < kWindow / 4; i += kThreads)
    reinterpret_cast<uint32_t*>(buf)[i] = wsrc[i];

  // Literals in place, matches listed in record order (start in buf, word).
  int nm = 0;
  if (lim > 0) {
    int64_t base = 0;
    for (int g = 0; g < K; g += kGroup) {
      uint32_t r[kPer];
      const int u0 = g + tid * kPer;
      unsigned long long mine = 0;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        r[i] = u0 + i < K ? static_cast<uint32_t>(
                                recs[static_cast<int64_t>(u0 + i) * L + lane])
                          : 0u;
        mine += rec_step(r[i]);
      }
      unsigned long long total;
      const unsigned long long ex = block_scan(mine, wsum, &total);
      int64_t pos = base + static_cast<int64_t>(ex & 0xffffffffull);
      int m = nm + static_cast<int>(ex >> 32);
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const uint32_t w = r[i];
        if (w >> 28 == kRecLits) {
          const int cnt = (w >> 16) & 3;
          for (int j = 0; j < cnt; ++j)
            if (pos + j < lim)
              buf[kWindow + pos + j] =
                  j < 2 ? static_cast<uint8_t>(w >> (8 * j)) : 0;
          pos += cnt;
        } else if (w >> 28 == kRecMatch) {
          mpos[m] = pos < lim ? kWindow + static_cast<int>(pos) : ext;
          mrec[m++] = w;
          pos += ((w >> 15) & 0xFF) + 3;
        }
      }
      base += static_cast<int64_t>(total & 0xffffffffull);
      nm += static_cast<int>(total >> 32);
    }
  }
  __syncthreads();

  // The matches, in rounds of a ready prefix of the next 32 (see the top).
  const int end = kWindow + lim;
  for (int a = 0; a < nm;) {
    const int idx = a + t;
    int s = ext, len = 0, d = 1;
    if (idx < nm) {
      s = mpos[idx];
      const uint32_t w = mrec[idx];
      len = ((w >> 15) & 0xFF) + 3;
      d = (w & 0x7FFF) + 1;
    }
    const bool valid = s < end;
    const int lo = s - d, hi = lo + (d < len ? d : len), e = s + len;
    int k = 0;  // matches of the round before this one that start below hi
#pragma unroll
    for (int step = 16; step >= 1; step >>= 1) {
      const int sj = __shfl_sync(kFull, s, k + step - 1);
      if (k + step <= t && sj < hi) k += step;
    }
    const int ek = __shfl_sync(kFull, e, k > 0 ? k - 1 : 0);
    const bool ready = valid && (k == 0 || ek <= lo);
    const unsigned wait = __ballot_sync(kFull, !ready);
    int p = wait ? __ffs(wait) - 1 : 32;
    if (p == 0) break;  // the next match starts past `produced`
    if (p > kWarps) p = kWarps;
    if (warp < p) {
      const int ms = __shfl_sync(kFull, s, warp);
      const int ml = __shfl_sync(kFull, len, warp);
      const int md = __shfl_sync(kFull, d, warp);
      const int me = ms + ml < end ? ms + ml : end;
      if (md >= ml) {
        for (int i = ms + t; i < me; i += 32) buf[i] = buf[i - md];
      } else {
        for (int i = ms + t; i < me; i += 32)
          buf[i] = buf[ms - md + (i - ms) % md];
      }
    }
    __syncthreads();
    a += p;
  }

  uint32_t* orow =
      reinterpret_cast<uint32_t*>(out + static_cast<int64_t>(lane) * cap);
  for (int w = tid; w < cap / 4; w += kThreads) {
    const int i = 4 * w;
    uint32_t v = 0;
    if (i < lim) {
      v = reinterpret_cast<const uint32_t*>(buf + kWindow)[w];
      if (lim - i < 4) v &= (1u << (8 * (lim - i))) - 1;
    }
    orow[w] = v;
  }
  // new_window[j] = [window | out][j + P], the index clamped to the row.
  uint32_t* nrow = reinterpret_cast<uint32_t*>(
      new_window + static_cast<int64_t>(lane) * kWindow);
  for (int w = tid; w < kWindow / 4; w += kThreads) {
    uint32_t v = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      int64_t x = 4 * w + b + P;
      x = x < 0 ? 0 : (x > ext - 1 ? ext - 1 : x);
      if (x < end) v |= static_cast<uint32_t>(buf[x]) << (8 * b);
    }
    nrow[w] = v;
  }
}

std::atomic<int> g_smem_set[2][kMaxDevices];

// Raise the kernel's dynamic shared memory limit to the device's opt-in
// maximum, once per device.
template <class Kernel>
cudaError_t allow_smem(Kernel kernel, std::atomic<int>* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load()) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev].store(1);
  return err;
}

}  // namespace

// recs int32[K, L] (K4's records, step-major), window u8[L, 32768],
// produced int64[L]; out u8[L, cap] (cap a multiple of 4), new_window
// u8[L, 32768].  scratch: null to work in shared memory, else u8[L, 32768
// + cap] for the working bytes.
extern "C" int fdt_materialize_records(const void* recs, const void* window,
                                       const void* produced, void* out,
                                       void* new_window, void* scratch, int L,
                                       int K, int cap, void* stream) {
  const bool shared = scratch == nullptr;
  const size_t smem = kScanBytes + 8 * static_cast<size_t>(K) +
                      (shared ? kWindow + static_cast<size_t>(cap) : 0);
  auto kernel = shared ? materialize_kernel<true> : materialize_kernel<false>;
  cudaError_t err = allow_smem(kernel, g_smem_set[shared ? 1 : 0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<L, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(recs), static_cast<const uint8_t*>(window),
      static_cast<const int64_t*>(produced), static_cast<uint8_t*>(out),
      static_cast<uint8_t*>(new_window), static_cast<uint8_t*>(scratch), L, K,
      cap);
  return static_cast<int>(cudaGetLastError());
}
