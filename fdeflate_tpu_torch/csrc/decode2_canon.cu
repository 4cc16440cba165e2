// K8 decode2_canon: fixed-geometry decode of lane windows under canonical
// rows (bounds, kvals) and a 512-entry symbol table.
//
// Replaces fdeflate_tpu/ops/pallas_decode2.py:_kernel (via decode_blocked
// with light=False), the unrolled body kept on the TPU for A/B.  Its
// contract is K3's (_kernel_light's) on windows: T word steps of four
// sub-steps from bit 0 of each lane's window (fdt::decode_canon_lane), the
// code length from 11 compares of the bit-reversed 12-bit peek against
// the canonical bounds, the symbol from kvals[L] + (r12 >> (12 - L)) into
// the 512-entry packed table (canonical_meta).
//
// Bound on the H100: bytes (the windows in, 4T bytes per lane out), if the
// card is kept busy.  One thread per lane, a serial chain of ~S/1.4
// symbols with the compare chain in each, left the card mostly idle (as
// K6 was before it ran K3's design).  So K8 runs K3's design
// (decode2.cu, grid.cuh decode_lanes): m = fdt::dec_threads(4T) threads
// per lane decode sub-ranges of its staged window speculatively, agree in
// sync rounds and write at scanned byte offsets; 32 warps to a block,
// blocks looping over lanes; each lane a C = 1 stream of wwin words from
// bit 0.  The compare chain runs once per peek, in each block's prologue,
// into K3's 4096-entry table (fdt::canon_table).  A table with a literal
// above 255 or a run of base below 3 among those entries (never the
// trained tree's) breaks K3's protocol for K8's word steps
// (fdt::canon_unsafe); every block builds the same table and sees it, and
// then every lane is decoded by one thread with decode_canon_lane, and
// counted in stats[4].
#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

__global__ void __launch_bounds__(32 * fdt::kDecWarps, 1)
decode_canon_kernel(const uint32_t* __restrict__ win,
                    const int32_t* __restrict__ meta_g,
                    const int32_t* __restrict__ packed_g,
                    uint8_t* __restrict__ out, int32_t* __restrict__ bpos,
                    unsigned long long* stats, int L, int wwin, int T) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int32_t meta[32];
  __shared__ int32_t packed[512];
  for (int i = threadIdx.x; i < 32; i += blockDim.x) meta[i] = meta_g[i];
  for (int i = threadIdx.x; i < 512; i += blockDim.x) packed[i] = packed_g[i];
  __syncthreads();
  int32_t* dtab = reinterpret_cast<int32_t*>(smem);
  const bool unsafe = __syncthreads_or(
      fdt::canon_table(meta, packed, dtab, threadIdx.x, blockDim.x));
  if (unsafe) {
    unsigned long long n = 0;
    for (int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                        threadIdx.x;
         lane < L; lane += static_cast<int64_t>(gridDim.x) * blockDim.x) {
      bpos[lane] = fdt::decode_canon_lane(
          win + lane * wwin, wwin, meta, meta + 16, packed,
          reinterpret_cast<uint32_t*>(out + lane * 4 * T), T);
      ++n;
    }
    if (stats && n) atomicAdd(stats + 4, n);
    return;
  }
  fdt::decode_lanes<false>(smem, win, wwin, nullptr, L, 4 * T, 1, out, bpos,
                           stats);
}

}  // namespace

// `stats`: null, or five zeroed counters (most sync rounds of a span,
// spans, spans another span continues, sync rounds, lanes decoded
// serially).  `dev`: the device the caller made current, whose stream
// `stream` is.
extern "C" int fdt_decode2_canon(const void* win, const void* meta,
                                 const void* packed, void* out, void* bpos,
                                 void* stats, int L, int wwin, int T, int dev,
                                 void* stream) {
  static std::atomic<int> caps[fdt::kMaxDevices];
  return static_cast<int>(fdt::launch_decode(
      decode_canon_kernel, dev, caps, L, 4 * T, 1, stream,
      static_cast<const uint32_t*>(win), static_cast<const int32_t*>(meta),
      static_cast<const int32_t*>(packed), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(bpos), static_cast<unsigned long long*>(stats), L,
      wwin, T));
}
