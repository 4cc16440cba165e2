// K3 decode2: fixed-geometry canonical decode straight from stream words.
//
// Replaces fdeflate_tpu/ops/pallas_decode2.py:_kernel_light and folds in
// fdeflate_tpu/ops/repack.py:_slab_kernel with the XLA log-shift and bit
// shift of repack.stage_blocked_from_linear.  Those exist because Mosaic
// cannot read per lane at a dynamic offset; a CUDA thread can, so each
// thread starts its bit reader at chunk_starts[lane] in the linear words
// and decodes exactly S bytes into out[b, k*S : (k+1)*S] (fdt::decode_lane).
// The TPU kernel's canonical compare chain and select-reduce symbol scans
// become one lookup in a 4096-entry table (class, value, extra bits, code
// length per 12-bit peek) held in 16 KiB of shared memory.
//
// Bound on the H100: the serial decode chain per thread (one table lookup
// and one shift per symbol, ~S symbols per lane) and its latency; bytes
// move as 32-bit stores.  One thread per lane: 128 blocks of 64 threads at
// the bench geometry, about one block per SM.
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

__global__ void decode_kernel(const uint32_t* __restrict__ words,
                              const int32_t* __restrict__ chunk_starts,
                              const int32_t* __restrict__ dtab_g,
                              uint8_t* __restrict__ out,
                              int32_t* __restrict__ bpos, int B, int W, int N,
                              int C) {
  __shared__ int32_t dtab[1 << fdt::kMaxL];
  for (int i = threadIdx.x; i < (1 << fdt::kMaxL); i += blockDim.x)
    dtab[i] = dtab_g[i];
  __syncthreads();

  int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= static_cast<int64_t>(B) * C) return;
  int b = static_cast<int>(lane / C);
  int k = static_cast<int>(lane % C);
  int S = N / C;
  uint32_t* dst = reinterpret_cast<uint32_t*>(
      out + static_cast<int64_t>(b) * N + static_cast<int64_t>(k) * S);
  bpos[lane] = fdt::decode_lane(words + static_cast<int64_t>(b) * W, W,
                                chunk_starts[lane], dtab, dst, S);
}

}  // namespace

extern "C" int fdt_decode2(const void* words, const void* chunk_starts,
                           const void* dtab, void* out, void* bpos, int B,
                           int W, int N, int C, void* stream) {
  const int threads = 64;
  int64_t L = static_cast<int64_t>(B) * C;
  int blocks = static_cast<int>((L + threads - 1) / threads);
  decode_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(chunk_starts),
      static_cast<const int32_t*>(dtab), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(bpos), B, W, N, C);
  return static_cast<int>(cudaGetLastError());
}
