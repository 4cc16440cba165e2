// K5 validate_headers: discovery stage 2, one candidate header per thread.
//
// Replaces fdeflate_tpu/ops/pallas_inflate.py:_validate_kernel (via
// validate_headers_blocked), together with the 160-word window gather
// before it (parallel/discovery._jit_stage2).  Each thread reads its
// candidate's header straight from the stream words at the candidate's
// bit offset, bounded by the candidate's own stream (words at or past its
// `wend` read as 0, its payload ends at its `n_bits`), so one launch
// validates the candidates of a whole batch of streams over their
// concatenated words.
//
// Bound on the H100: the serial section decode of the longest header (up
// to 320 sections), not the stream's size.  The first design ran one
// thread per candidate with two dependent global loads per section and
// its code-length arrays indexed at run time (a 176-byte stack frame in
// local memory): ~0.1 ms whatever the stream.  Here (fdt::validate_lane's
// pieces, inflate_lanes.cuh) a thread keeps everything in registers and
// 132 bytes of shared memory:
//   * the CL lengths packed 3 bits a symbol in one 64-bit register, the CL
//     decode a 128-entry table of the bit-reversed 7-bit peek (symbol and
//     length), filled from the canonical codes (fdt::cl_table);
//   * the stream through a 64-bit bit buffer refilled from the next three
//     words held in registers (fdt::HeaderBits), so a section waits on a
//     shared-memory lookup, not on a global load;
//   * a section's body and the refill are selects, not branches
//     (fdt::val_sections): the threads of a warp decode different headers
//     and would part at every section (with branches the kernel took
//     0.11-0.12 ms one call on an 8 MiB stream's candidates on an H100,
//     without them 0.08-0.10 ms);
//   * a first pass of kFirstSections sections on every candidate, then a
//     ballot compacts the block's survivors into a shared queue and they
//     decode on densely (the first threads of the block), resuming from
//     their saved state with their tables where they were built.
// No stack frame: ptxas reports 0 bytes.
#include <cuda_runtime.h>

#include "inflate_lanes.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kFirstSections = 32;
constexpr int kTabStride = 132;  // 128 entries, + 4 bytes against bank conflicts

__global__ void __launch_bounds__(kThreads)
validate_kernel(const uint32_t* __restrict__ words,
                const int64_t* __restrict__ cands,
                const int64_t* __restrict__ wends,
                const int64_t* __restrict__ nbits, int64_t W, int64_t n_bits,
                bool* __restrict__ good, int64_t* __restrict__ end, int L) {
  __shared__ __align__(16) uint8_t tabs[kThreads * kTabStride];
  __shared__ fdt::ValState queue[kThreads];
  __shared__ int16_t slot[kThreads];
  __shared__ int nq;
  const int t = threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads;
  if (t == 0) nq = 0;
  __syncthreads();

  auto bounds = [&](int64_t i, int64_t* we, int64_t* nb) {
    *we = wends && wends[i] < W ? wends[i] : W;
    *nb = nbits ? nbits[i] : n_bits;
  };
  bool live = false;
  fdt::ValState s{};
  const int64_t i = base + t;
  if (i < L) {
    int64_t we, nb;
    bounds(i, &we, &nb);
    fdt::HeaderBits hb(words, we, cands[i]);
    s = fdt::val_begin(hb, cands[i], tabs + t * kTabStride);
    fdt::val_sections(s, hb, tabs + t * kTabStride, nb, kFirstSections);
    live = fdt::val_live(s);
    if (!live) {
      good[i] = fdt::val_good(s);
      end[i] = s.pos;
    }
  }
  const unsigned ball = __ballot_sync(0xFFFFFFFFu, live);
  const int lane = t & 31;
  int first = 0;
  if (lane == 0 && ball) first = atomicAdd(&nq, __popc(ball));
  first = __shfl_sync(0xFFFFFFFFu, first, 0);
  if (live) {
    const int k = first + __popc(ball & ((1u << lane) - 1));
    queue[k] = s;
    slot[k] = static_cast<int16_t>(t);
  }
  __syncthreads();

  if (t < nq) {  // the survivors, densely
    fdt::ValState q = queue[t];
    const int64_t j = base + slot[t];
    int64_t we, nb;
    bounds(j, &we, &nb);
    fdt::HeaderBits hb(words, we, q.pos);
    fdt::val_sections(q, hb, tabs + slot[t] * kTabStride, nb, fdt::kValSteps);
    good[j] = fdt::val_good(q);
    end[j] = q.pos;
  }
}

}  // namespace

// Per candidate `cands[i]` (absolute bits into `words`, W words): its
// stream's word end (at most W) and payload end from `wends`/`nbits`
// (int64[L]), or, where those are null, `W` and `n_bits` for every
// candidate.
extern "C" int fdt_validate_headers(const void* words, const void* cands,
                                    const void* wends, const void* nbits,
                                    int64_t W, int64_t n_bits, void* good,
                                    void* end, int L, void* stream) {
  const int blocks = (L + kThreads - 1) / kThreads;
  validate_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int64_t*>(cands),
      static_cast<const int64_t*>(wends), static_cast<const int64_t*>(nbits), W,
      n_bits, static_cast<bool*>(good), static_cast<int64_t*>(end), L);
  return static_cast<int>(cudaGetLastError());
}
