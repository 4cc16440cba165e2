// K3 decode2: fixed-geometry canonical decode straight from stream words.
//
// Replaces fdeflate_tpu/ops/pallas_decode2.py:_kernel_light and folds in
// fdeflate_tpu/ops/repack.py:_slab_kernel with the XLA log-shift and bit
// shift of repack.stage_blocked_from_linear.  Those exist because Mosaic
// cannot read per lane at a dynamic offset; here each lane starts its bit
// reader at chunk_starts[lane] in the linear words and decodes exactly S
// bytes into out[b, k*S : (k+1)*S].  The TPU kernel's canonical compare
// chain and select-reduce symbol scans become one lookup in a 4096-entry
// table (class, value, extra bits, code length per 12-bit peek) held in
// 16 KiB of shared memory.
//
// Bound on the H100: bytes (the words in, S bytes per lane out), if the
// card is kept busy.  A lane is a serial chain of ~S/1.5 dependent table
// lookups; one thread per lane left ~2 warps per SM and ~550 cycles per
// symbol.  So m threads decode a lane, speculatively (fdt::decode2_group
// in lanes.cuh, with the warp's operations of warp.cuh): m =
// fdt::dec_threads(S), about 64 output bytes a thread, 32 at S = 2048 and
// fewer for shorter lanes, whose 32 / m lanes then share a warp;
//   * the group stages the words a span can read in shared memory with
//     coalesced cp.async copies;
//   * the span's hint (the distance to the next lane's start, or for a
//     stream's last lane the staged words' last nonzero one) is split into
//     m sub-ranges; thread i decodes from its sub-range's start to its
//     first symbol boundary past the next, and while its start differs
//     from thread i-1's exit it decodes again from that exit.  Huffman
//     codes resynchronise within a few symbols, so one or two such rounds
//     are typical; the worst case is m, never a wrong answer;
//   * a scan of the segments' byte counts gives each thread its output
//     offset; each decodes its segment once more, writing literal bytes
//     into a zeroed output tile in shared memory, cut at S; the thread
//     that fills the lane gives bpos;
//   * the group stores the tile with 16-byte (or 4-byte) coalesced stores.
// Lanes longer than fdt::kDecTile (2048) bytes go tile by tile, a run
// crossing a tile edge carrying its zeros on.  A block is 32 warps, each
// with 2 KiB of output tile and ~3 KiB of staged words (split between its
// lanes), and the table: ~192 KiB, one block to an SM.  Blocks loop over
// lanes, so the table is loaded once per SM, and 4224 warps take the 8192
// lanes of 16 x 1 MiB at C = 512 in two rounds (8 warps to a block, 3
// blocks to an SM, took three).
#include <cuda_runtime.h>

#include "grid.cuh"

namespace {

__global__ void __launch_bounds__(32 * fdt::kDecWarps, 1)
decode_kernel(const uint32_t* __restrict__ words,
              const int32_t* __restrict__ chunk_starts,
              const int32_t* __restrict__ dtab_g, uint8_t* __restrict__ out,
              int32_t* __restrict__ bpos, int B, int W, int N, int C) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* dtab = reinterpret_cast<int32_t*>(smem);
  for (int i = threadIdx.x; i < (1 << fdt::kMaxL); i += blockDim.x) dtab[i] = dtab_g[i];
  __syncthreads();
  fdt::decode_lanes<false>(smem, words, W, chunk_starts, B, N, C, out, bpos,
                           nullptr);
}

}  // namespace

// `dev`: the device the caller made current, whose stream `stream` is.
extern "C" int fdt_decode2(const void* words, const void* chunk_starts,
                           const void* dtab, void* out, void* bpos, int B,
                           int W, int N, int C, int dev, void* stream) {
  static std::atomic<int> caps[fdt::kMaxDevices];
  return static_cast<int>(fdt::launch_decode(
      decode_kernel, dev, caps, B, N, C, stream,
      static_cast<const uint32_t*>(words),
      static_cast<const int32_t*>(chunk_starts),
      static_cast<const int32_t*>(dtab), static_cast<uint8_t*>(out),
      static_cast<int32_t*>(bpos), B, W, N, C));
}
