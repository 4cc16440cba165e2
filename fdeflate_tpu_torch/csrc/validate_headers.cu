// K5 validate_headers: discovery stage 2, one candidate header per lane.
//
// Replaces fdeflate_tpu/ops/pallas_inflate.py:_validate_kernel (via
// validate_headers_blocked), together with the 160-word window gather
// before it (parallel/discovery._jit_stage2).  Each thread reads its
// candidate's header straight from the stream words at the candidate's
// bit offset, builds the 19-symbol code-length tree in registers and local
// memory, and decodes at most 320 sections of the lengths
// (fdt::validate_lane, inflate_lanes.cuh).
//
// Bound on the H100: the serial section decode of each lane (one 32-bit
// peek, a 6-compare canonical decode and a few integer updates per
// section, ~20-300 sections for real headers, a handful for most false
// candidates, which fail early); one thread per stage-1 survivor, about
// 0.1% of the stream's bit offsets, so small streams leave the card idle.
#include <cuda_runtime.h>

#include "inflate_lanes.cuh"

namespace {

__global__ void validate_kernel(const uint32_t* __restrict__ words, int64_t W,
                                const int64_t* __restrict__ cands,
                                int64_t n_bits, int32_t* __restrict__ good,
                                int64_t* __restrict__ end, int L) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= L) return;
  const fdt::WordReader rd{words, W};
  int64_t e;
  good[i] = fdt::validate_lane(rd, cands[i], n_bits, &e);
  end[i] = e;
}

}  // namespace

extern "C" int fdt_validate_headers(const void* words, int64_t W,
                                    const void* cands, int64_t n_bits,
                                    void* good, void* end, int L,
                                    void* stream) {
  const int threads = 128;
  int blocks = (L + threads - 1) / threads;
  validate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), W,
      static_cast<const int64_t*>(cands), n_bits, static_cast<int32_t*>(good),
      static_cast<int64_t*>(end), L);
  return static_cast<int>(cudaGetLastError());
}
