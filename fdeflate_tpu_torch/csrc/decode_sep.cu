// K6 decode_sep: fixed-geometry decode of a class-separated (septree) tree
// straight from stream words.
//
// Replaces fdeflate_tpu/ops/pallas_decode2.py:_kernel_sep (via
// decode_blocked_sep) and, as K3 does, folds in the window staging of
// ops/repack.py (_slab_kernel and the XLA shifts of
// stage_blocked_from_linear): each thread starts its bit reader at
// chunk_starts[lane] in the linear words and writes S / 4 output words
// (fdt::decode_sep_lane).  The design that defines the TPU kernel stays:
// the code length comes from the 11 canonical bounds compares on the
// bit-reversed 12-bit peek, the class is arithmetic (L == 12 is EOB or a
// length symbol, idx - n_lit picks which), run base and extra bits come
// from RFC 1951's closed form, and only literal values are a lookup, in
// the 4-packed `vals` table.  meta (bounds, kvals, n_lit: 32 words) and
// vals (64 words) sit in shared memory.  Unlike K3 a lane does not stall
// at EOB: it consumes the 12 bits and decodes on, as the TPU kernel does.
//
// Bound on the H100: the serial decode chain per thread (11 compares, a
// dependent kvals load and a shift per symbol, ~S symbols per lane) and
// its latency; one thread per lane, 64 threads per block, as K3.
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

__global__ void decode_sep_kernel(const uint32_t* __restrict__ words,
                                  const int32_t* __restrict__ chunk_starts,
                                  const int32_t* __restrict__ meta_g,
                                  const int32_t* __restrict__ vals_g,
                                  uint8_t* __restrict__ out,
                                  int32_t* __restrict__ bpos, int B, int W,
                                  int N, int C) {
  __shared__ int32_t meta[32];
  __shared__ int32_t vals[64];
  for (int i = threadIdx.x; i < 32; i += blockDim.x) meta[i] = meta_g[i];
  for (int i = threadIdx.x; i < 64; i += blockDim.x) vals[i] = vals_g[i];
  __syncthreads();

  int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= static_cast<int64_t>(B) * C) return;
  int b = static_cast<int>(lane / C);
  int k = static_cast<int>(lane % C);
  int S = N / C;
  uint32_t* dst = reinterpret_cast<uint32_t*>(
      out + static_cast<int64_t>(b) * N + static_cast<int64_t>(k) * S);
  bpos[lane] = fdt::decode_sep_lane(words + static_cast<int64_t>(b) * W, W,
                                    chunk_starts[lane], meta, vals, dst, S);
}

}  // namespace

extern "C" int fdt_decode_sep(const void* words, const void* chunk_starts,
                              const void* meta, const void* vals, void* out,
                              void* bpos, int B, int W, int N, int C,
                              void* stream) {
  const int threads = 64;
  int64_t L = static_cast<int64_t>(B) * C;
  int blocks = static_cast<int>((L + threads - 1) / threads);
  decode_sep_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(chunk_starts),
      static_cast<const int32_t*>(meta), static_cast<const int32_t*>(vals),
      static_cast<uint8_t*>(out), static_cast<int32_t*>(bpos), B, W, N, C);
  return static_cast<int>(cudaGetLastError());
}
