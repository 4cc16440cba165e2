// K11 decode_symbols: the table-gather symbol engine, a thread per lane.
//
// Replaces fdeflate_tpu/ops/inflate.py:64 decode_symbols, an XLA
// while_loop (the JAX package has no Pallas kernel for it) that advances
// every lane one step per iteration with ~150 array ops and stops when no
// lane runs.  Here each thread runs one lane's whole loop
// (fdt::decode_symbols_lane, symbols_lanes.cuh) in one launch, its state
// (position, output count, status, a three-word window of the stream) in
// registers; no host loop, no per-step sync.
//
// Bound on the H100: the records.  Every lane writes 21 bytes for each of
// max_steps steps (a lane that has stopped writes the records' initial
// values, so the caller allocates them uninitialised), ~0.7 GB for the
// 8192 lanes of 16 x 1 MiB at C = 512 and 4096 steps; the words are read
// once.  A lane's steps are a serial chain of dependent table lookups and
// word loads, and one thread per lane gives the card 256 warps, ~2 per SM:
// the kernel is latency-bound first, which a later design can attack with
// several threads per lane (K3's speculative protocol).  Rows are written
// together by a warp's lanes (every lane writes every row), so the stores
// coalesce.  With one table set (T = 1, the indexed path's trained tables)
// the block stages the 4096-entry litlen table, its first-symbol lengths
// and the 512-entry distance table in 34 KiB of shared memory; the
// secondary tables, and every table for T > 1 (indexed by table_id), are
// read from global memory.  Blocks of 64 threads spread 8192 lanes over
// 128 SMs.
#include <cuda_runtime.h>

#include "symbols_lanes.cuh"

namespace {

constexpr int kThreads = 64;

template <bool kShared>
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
  fdt::decode_symbols_lane(words + row * W, W, bit_pos[lane], bit_end[lane],
                           out_pos[lane], active[lane] != 0, bit_stop[lane],
                           tb, chain, max_steps, o, bpos + lane, opos + lane,
                           status + lane);
}

}  // namespace

// Records rl, rlh, rc (int8), rn, rd, rp: [max_steps, L]; first may be
// null; rows, table_id in range are assumed and clamped.
extern "C" int fdt_decode_symbols(
    const void* words, int nrows, int W, const void* rows, const void* bit_pos,
    const void* bit_end, const void* out_pos, const void* active,
    const void* table_id, const void* bit_stop, const void* litlen,
    const void* lsec, int nsec, const void* dist, const void* dsec, int ndsec,
    const void* first, int T, int chain, int L, int max_steps, void* rl,
    void* rlh, void* rc, void* rn, void* rd, void* rp, void* bpos, void* opos,
    void* status, void* stream) {
  const fdt::SymOut out{static_cast<uint32_t*>(rl), static_cast<uint32_t*>(rlh),
                        static_cast<int8_t*>(rc),   static_cast<int32_t*>(rn),
                        static_cast<int32_t*>(rd),  static_cast<int32_t*>(rp),
                        L};
  const int blocks = (L + kThreads - 1) / kThreads;
  const size_t smem =
      T == 1 ? sizeof(uint32_t) * (fdt::kSymLitlen + fdt::kSymDist +
                                   (first != nullptr ? fdt::kSymLitlen : 0))
             : 0;
  auto kernel = T == 1 ? &decode_symbols_kernel<true> : &decode_symbols_kernel<false>;
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), nrows, W,
      static_cast<const int32_t*>(rows), static_cast<const int32_t*>(bit_pos),
      static_cast<const int32_t*>(bit_end), static_cast<const int32_t*>(out_pos),
      static_cast<const int32_t*>(active), static_cast<const int32_t*>(table_id),
      static_cast<const int32_t*>(bit_stop), static_cast<const uint32_t*>(litlen),
      static_cast<const uint32_t*>(lsec), nsec,
      static_cast<const uint32_t*>(dist), static_cast<const uint32_t*>(dsec),
      ndsec, static_cast<const int32_t*>(first), T, chain, L, max_steps, out,
      static_cast<int32_t*>(bpos), static_cast<int32_t*>(opos),
      static_cast<int8_t*>(status));
  return static_cast<int>(cudaGetLastError());
}
