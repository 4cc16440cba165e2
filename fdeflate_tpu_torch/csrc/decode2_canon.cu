// K8 decode2_canon: fixed-geometry decode of lane windows with the
// canonical compare chain and a 512-entry symbol table.
//
// Replaces fdeflate_tpu/ops/pallas_decode2.py:_kernel (via decode_blocked
// with light=False), the unrolled body kept on the TPU for A/B.  Its
// contract is K3's (_kernel_light's); what differs is the lookup: the code
// length comes from 11 compares of the bit-reversed 12-bit peek against
// the canonical bounds, the symbol from kvals[L] + (r12 >> (12 - L)) into
// the 512-entry packed table (canonical_meta), where K3 reads one
// 4096-entry peek table.  On Hopper this kernel is the A/B of "compare
// chain vs peek table" (fdt::decode_canon_lane).
//
// Bound on the H100: the serial decode chain of each thread (11 compares,
// one shared-memory lookup and the shifts per symbol, ~S symbols per lane)
// and its latency, as K3; bytes (the windows in, 4T bytes per lane out)
// are a small part.  One thread per lane reading its own window row;
// bounds, kvals and the table in shared memory (2 KiB).
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

__global__ void decode_canon_kernel(const uint32_t* __restrict__ win,
                                    const int32_t* __restrict__ meta_g,
                                    const int32_t* __restrict__ packed_g,
                                    uint32_t* __restrict__ out,
                                    int32_t* __restrict__ bpos, int L,
                                    int wwin, int T) {
  __shared__ int32_t packed[512];
  __shared__ int32_t meta[32];
  for (int i = threadIdx.x; i < 512; i += blockDim.x) packed[i] = packed_g[i];
  for (int i = threadIdx.x; i < 32; i += blockDim.x) meta[i] = meta_g[i];
  __syncthreads();

  int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= L) return;
  bpos[lane] = fdt::decode_canon_lane(win + lane * wwin, wwin, meta, meta + 16,
                                      packed, out + lane * T, T);
}

}  // namespace

extern "C" int fdt_decode2_canon(const void* win, const void* meta,
                                 const void* packed, void* out, void* bpos,
                                 int L, int wwin, int T, void* stream) {
  const int threads = 64;
  int blocks = (L + threads - 1) / threads;
  decode_canon_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(win), static_cast<const int32_t*>(meta),
      static_cast<const int32_t*>(packed), static_cast<uint32_t*>(out),
      static_cast<int32_t*>(bpos), L, wwin, T);
  return static_cast<int>(cudaGetLastError());
}
