// K9 pack_v1: packed byte tokens -> lane bit windows, all pairs against
// all words.
//
// Replaces fdeflate_tpu/ops/pallas_pack.py:_kernel (via
// pack_blocked_pallas), the quadratic v1 pack kept on the TPU for A/B:
// win[lane, w] = OR over the lane's pairs p of (wi_p == w ? lo_p : 0) |
// (wi_p == w - 1 ? hi_p : 0).  It stays quadratic, as the TPU kernel is;
// the linear pack (pallas_pack._kernel_v2) lives in K1.
//
// Bound on the H100: this kernel's pair tests, wwin x S/2 per lane (1.7e9
// at 16 x 1 MiB, C = 2048), each about six integer operations.  The
// function itself needs only linear work (K1 builds the same windows), so
// its least time is its bytes (the tokens in, the windows out), about an
// order of magnitude below the pair tests; the quadratic form is the TPU
// kernel's, kept for the A/B.  One block per lane: its S <= 630
// tokens are decoded once into (wi, lo, hi) pairs in shared memory (at
// most 315 pairs, 3.8 KiB), then each thread accumulates one window word
// over every pair; all threads read the same pair at a time, a broadcast.
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

constexpr int kMaxPairs = 315;  // S <= 630: rel fits its 13 bits

__global__ void pack_v1_kernel(const int32_t* __restrict__ tok,
                               uint32_t* __restrict__ win, int S, int wwin) {
  __shared__ int wi[kMaxPairs];
  __shared__ uint32_t lo[kMaxPairs];
  __shared__ uint32_t hi[kMaxPairs];
  const int64_t lane = blockIdx.x;
  const int P = S / 2;
  const int32_t* t = tok + lane * S;
  for (int p = threadIdx.x; p < P; p += blockDim.x)
    fdt::pack_pair(t[2 * p], t[2 * p + 1], wi + p, lo + p, hi + p);
  __syncthreads();
  for (int w = threadIdx.x; w < wwin; w += blockDim.x)
    win[lane * wwin + w] = fdt::pack_v1_word(wi, lo, hi, P, w);
}

}  // namespace

extern "C" int fdt_pack_v1(const void* tok, void* win, int L, int S, int wwin,
                           void* stream) {
  if (S / 2 > kMaxPairs) return static_cast<int>(cudaErrorInvalidValue);
  int threads = wwin < 256 ? (wwin + 31) / 32 * 32 : 256;
  pack_v1_kernel<<<L, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(tok), static_cast<uint32_t*>(win), S, wwin);
  return static_cast<int>(cudaGetLastError());
}
