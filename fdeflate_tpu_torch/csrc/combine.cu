// K2 combine: lane windows -> linear stream words at each lane's bit start.
//
// Replaces fdeflate_tpu/ops/repack.py:_combine_kernel, which ORs lane rows
// into 1024-word output slabs with each lane's word shift applied in
// flight (slab-granular DMA is all Mosaic offers for per-lane placement).
// Here block `lane` reads its window row with coalesced loads, shifts each
// word by pos0 & 31 in a 64-bit register and ORs the two halves into
// words[b, (pos0 >> 5) + j] and the word after.  Neighbouring lanes share
// only the word at their boundary, and a word's high half meets the next
// word's low half, so the ORs are atomic.  Only the ceil(bits / 32) words
// that hold payload are read.
//
// Bound on the H100: memory traffic (~the payload bits once in, once out
// as 32-bit atomics to L2); the output row is zeroed by the caller.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void combine_kernel(const uint32_t* __restrict__ win,
                               const int32_t* __restrict__ chunk_bits,
                               const int32_t* __restrict__ pos0,
                               uint32_t* __restrict__ words, int C, int wwin,
                               int W) {
  int64_t lane = blockIdx.x;
  int b = static_cast<int>(lane / C);
  int nw = (chunk_bits[lane] + 31) >> 5;
  int p = pos0[lane];
  int w0 = p >> 5;
  int sh = p & 31;
  const uint32_t* src = win + lane * wwin;
  uint32_t* row = words + static_cast<int64_t>(b) * W;
  for (int j = threadIdx.x; j < nw; j += blockDim.x) {
    uint64_t x = static_cast<uint64_t>(src[j]) << sh;
    uint32_t lo = static_cast<uint32_t>(x);
    uint32_t hi = static_cast<uint32_t>(x >> 32);
    if (lo) atomicOr(row + w0 + j, lo);
    if (hi && w0 + j + 1 < W) atomicOr(row + w0 + j + 1, hi);
  }
}

}  // namespace

extern "C" int fdt_combine(const void* win, const void* chunk_bits,
                           const void* pos0, void* words, int B, int C,
                           int wwin, int W, void* stream) {
  int L = B * C;
  combine_kernel<<<L, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(win), static_cast<const int32_t*>(chunk_bits),
      static_cast<const int32_t*>(pos0), static_cast<uint32_t*>(words), C, wwin,
      W);
  return static_cast<int>(cudaGetLastError());
}
