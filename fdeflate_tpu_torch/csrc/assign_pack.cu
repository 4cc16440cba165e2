// K1 assign_pack: raw stream bytes -> per-lane bit windows + chunk bits.
//
// Replaces two TPU kernels: fdeflate_tpu/ops/pallas_assign.py:_kernel
// (per-lane run state machine + literal lookup -> one token per byte) and
// fdeflate_tpu/ops/pallas_pack.py:_kernel_v2 (pair-combine + OR of each
// pair into the lane window).  On the TPU the two are separate because
// Mosaic has no per-lane bit accumulator; here one thread walks its lane's
// S bytes in 8-byte steps and shifts each token straight into a 64-bit
// accumulator (fdt::assign_pack_lane), so no token array ever reaches
// device memory.
//
// Bound on the H100: per-thread serial steps (~S byte decisions per lane)
// and the latency of strided 8-byte loads, not bandwidth (16 MiB in,
// ~27 MiB of windows out at the bench geometry).  One thread per lane gives
// B*C = 8192 threads there: 128 blocks of 64, about one block per SM.
// Literal and length tokens sit in shared memory.
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

__global__ void assign_pack_kernel(const uint8_t* __restrict__ data,
                                   const int32_t* __restrict__ lengths,
                                   const int32_t* __restrict__ lit_tok_g,
                                   const int32_t* __restrict__ len_tok_g,
                                   uint32_t* __restrict__ win,
                                   int32_t* __restrict__ chunk_bits, int B,
                                   int N, int C, int wwin) {
  __shared__ int32_t lit_tok[256];
  __shared__ int32_t len_tok[32];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) lit_tok[i] = lit_tok_g[i];
  for (int i = threadIdx.x; i < 29; i += blockDim.x) len_tok[i] = len_tok_g[i];
  __syncthreads();
  // The zero literal's token, and symbol 285's with its 1-bit distance code
  // (the tables may be an adaptive tree's, built on the card: no host read).
  const int32_t zlit = lit_tok[0];
  const int32_t t285 = len_tok[28] + (1 << fdt::kNbShift);

  int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= static_cast<int64_t>(B) * C) return;
  int b = static_cast<int>(lane / C);
  int k = static_cast<int>(lane % C);
  int S = N / C;
  const uint8_t* src = data + static_cast<int64_t>(b) * N +
                       static_cast<int64_t>(k) * S;
  int len = lengths[b];
  int base = k * S;
  int al = min(max(len / 8 * 8 - base, 0), S);
  int ln = min(max(len - base, 0), S);
  // The 8-byte-chunk rule's carry entering the lane: the previous lane's
  // last byte is zero (pallas_assign.blocked_input).
  bool prev_run = k > 0 && src[-1] == 0;
  chunk_bits[lane] = fdt::assign_pack_lane(
      src, S, al, ln, prev_run, lit_tok, len_tok, zlit, t285,
      win + lane * wwin, wwin);
}

}  // namespace

extern "C" int fdt_assign_pack(const void* data, const void* lengths,
                               const void* lit_tok, const void* len_tok,
                               void* win, void* chunk_bits,
                               int B, int N, int C, int wwin, void* stream) {
  const int threads = 64;
  int64_t L = static_cast<int64_t>(B) * C;
  int blocks = static_cast<int>((L + threads - 1) / threads);
  assign_pack_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const int32_t*>(lengths),
      static_cast<const int32_t*>(lit_tok), static_cast<const int32_t*>(len_tok),
      static_cast<uint32_t*>(win),
      static_cast<int32_t*>(chunk_bits), B, N, C, wwin);
  return static_cast<int>(cudaGetLastError());
}
