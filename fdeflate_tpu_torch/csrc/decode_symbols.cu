// K11 decode_symbols: the table-gather symbol engine, a thread per lane,
// a warp stepping while any of its lanes runs.
//
// Replaces fdeflate_tpu/ops/inflate.py:64 decode_symbols, an XLA
// while_loop (the JAX package has no Pallas kernel for it) that advances
// every lane one step per iteration with ~150 array ops and stops when no
// lane runs.  Here each thread runs one lane's loop
// (fdt::decode_symbols_lane, symbols_lanes.cuh) in one launch, its state
// (position, output count, status, a three-word window of the stream) in
// registers; no host loop, no per-step sync.
//
// Two output forms from one entry point.  The live form (fill = 0) writes
// each lane's rows [0, steps[lane]) and its step count, and leaves the rest
// of the [max_steps, L] records unwritten; the indexed decode reads it.
// Its bound is the stream words read once, the records of the steps run
// (~31 MB of 0.70 GB at 16 x 1 MiB, C = 512, 4096 steps) and the lanes'
// I/O, ~0.01 ms.  The full form (fill = 1) writes the records' initial
// values (0, 0, 0, 0, 0, -1) at every other row, JAX's [max_steps, L]
// layout (the public decode_symbols); all 0.70 GB of it bound the kernel.
// Its lanes step to max_steps, a stopped lane writing the initial values
// row by row as the others step, so the fill overlaps the step chain.  The
// form is a template argument, so each form's loop is compiled alone.
//
// In the live form a warp steps while any of its lanes runs (a vote each
// step), not for max_steps, so a warp whose lanes have all stopped exits;
// in both forms the stores of a warp's lanes fall on one row, so they
// coalesce.  A lane's steps are a serial chain of dependent table lookups
// and word loads, and one thread per lane gives the card 256 warps, ~2 per
// SM: the kernel is latency-bound first (several threads per lane, K3's
// speculative protocol, is not taken: records must be JAX's step grouping
// from each lane's exact start).  With one table set (T = 1, the indexed
// path's trained tables) the block stages the 4096-entry litlen table, its
// first-symbol lengths and the 512-entry distance table in 34 KiB of
// shared memory; the secondary tables, and every table for T > 1 (indexed
// by table_id), are read from global memory.  Blocks of 64 threads spread
// 8192 lanes over 128 SMs.
#include <cuda_runtime.h>

#include "symbols_lanes.cuh"

namespace {

constexpr int kThreads = 64;

// The warp's vote over its lanes in ``mask``: a warp steps while any of
// them runs.
struct WarpVote {
  unsigned mask;
  FDT_HD bool operator()(bool running) const {
#ifdef __CUDA_ARCH__
    return __any_sync(mask, running);
#else
    return running;
#endif
  }
};

template <bool kShared, bool kFill>
__global__ void __launch_bounds__(kThreads)
decode_symbols_kernel(const uint32_t* __restrict__ words, int nrows, int W,
                      const int32_t* __restrict__ rows,
                      const int32_t* __restrict__ bit_pos,
                      const int32_t* __restrict__ bit_end,
                      const int32_t* __restrict__ out_pos,
                      const int32_t* __restrict__ active,
                      const int32_t* __restrict__ table_id,
                      const int32_t* __restrict__ bit_stop,
                      const uint32_t* __restrict__ litlen,
                      const uint32_t* __restrict__ lsec, int nsec,
                      const uint32_t* __restrict__ dist,
                      const uint32_t* __restrict__ dsec, int ndsec,
                      const int32_t* __restrict__ first, int T, int chain,
                      int L, int max_steps, fdt::SymOut out,
                      int32_t* __restrict__ steps,
                      int32_t* __restrict__ bpos, int32_t* __restrict__ opos,
                      int8_t* __restrict__ status) {
  extern __shared__ __align__(16) uint32_t smem[];
  const uint32_t* lit = litlen;
  const uint32_t* dtab = dist;
  const int32_t* fst = first;
  if (kShared) {
    uint32_t* s_dist = smem + fdt::kSymLitlen;
    int32_t* s_first = reinterpret_cast<int32_t*>(s_dist + fdt::kSymDist);
    for (int i = threadIdx.x; i < fdt::kSymLitlen; i += blockDim.x) {
      smem[i] = litlen[i];
      if (first != nullptr) s_first[i] = first[i];
    }
    for (int i = threadIdx.x; i < fdt::kSymDist; i += blockDim.x)
      s_dist[i] = dist[i];
    __syncthreads();
    lit = smem;
    dtab = s_dist;
    fst = first != nullptr ? s_first : nullptr;
  }
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const unsigned mask = __ballot_sync(0xffffffffu, lane < L);
  if (lane >= L) return;
  const int64_t t = kShared ? 0 : fdt::iclamp(table_id[lane], 0, T - 1);
  const fdt::SymTables tb{
      lit + t * fdt::kSymLitlen, fst != nullptr ? fst + t * fdt::kSymLitlen : nullptr,
      dtab + t * fdt::kSymDist,  lsec + t * nsec,
      nsec,                      dsec + t * ndsec,
      ndsec};
  const int64_t row = fdt::iclamp(rows[lane], 0, nrows - 1);
  fdt::SymOut o = out;
  o.lo += lane;
  o.hi += lane;
  o.cnt += lane;
  o.len += lane;
  o.dist += lane;
  o.pos += lane;
  fdt::decode_symbols_lane(
      words + row * W, W, bit_pos[lane], bit_end[lane], out_pos[lane],
      active[lane] != 0, bit_stop[lane], tb, chain, max_steps, kFill, o,
      steps + lane, bpos + lane, opos + lane, status + lane, WarpVote{mask});
}

}  // namespace

// Records rl, rlh, rc (int8), rn, rd, rp: [max_steps, L], every row
// written with fill != 0, rows [0, steps[lane]) only otherwise; steps,
// bpos, opos: int32[L], status int8[L]; first may be null; rows, table_id
// in range are assumed and clamped.
extern "C" int fdt_decode_symbols(
    const void* words, int nrows, int W, const void* rows, const void* bit_pos,
    const void* bit_end, const void* out_pos, const void* active,
    const void* table_id, const void* bit_stop, const void* litlen,
    const void* lsec, int nsec, const void* dist, const void* dsec, int ndsec,
    const void* first, int T, int chain, int L, int max_steps, int fill,
    void* rl, void* rlh, void* rc, void* rn, void* rd, void* rp, void* steps,
    void* bpos, void* opos, void* status, void* stream) {
  const fdt::SymOut out{static_cast<uint32_t*>(rl), static_cast<uint32_t*>(rlh),
                        static_cast<int8_t*>(rc),   static_cast<int32_t*>(rn),
                        static_cast<int32_t*>(rd),  static_cast<int32_t*>(rp),
                        L};
  const int blocks = (L + kThreads - 1) / kThreads;
  const size_t smem =
      T == 1 ? sizeof(uint32_t) * (fdt::kSymLitlen + fdt::kSymDist +
                                   (first != nullptr ? fdt::kSymLitlen : 0))
             : 0;
  auto kernel = T == 1 ? (fill ? &decode_symbols_kernel<true, true>
                                : &decode_symbols_kernel<true, false>)
                       : (fill ? &decode_symbols_kernel<false, true>
                                : &decode_symbols_kernel<false, false>);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), nrows, W,
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(bit_pos),
      static_cast<const int32_t*>(bit_end), static_cast<const int32_t*>(out_pos),
      static_cast<const int32_t*>(active), static_cast<const int32_t*>(table_id),
      static_cast<const int32_t*>(bit_stop), static_cast<const uint32_t*>(litlen),
      static_cast<const uint32_t*>(lsec), nsec,
      static_cast<const uint32_t*>(dist), static_cast<const uint32_t*>(dsec),
      ndsec, static_cast<const int32_t*>(first), T, chain, L, max_steps, out,
      static_cast<int32_t*>(steps),
      static_cast<int32_t*>(bpos), static_cast<int32_t*>(opos),
      static_cast<int8_t*>(status));
  return static_cast<int>(cudaGetLastError());
}
