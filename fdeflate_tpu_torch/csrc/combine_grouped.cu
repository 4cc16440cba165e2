// K10 combine_grouped: lane windows -> linear stream words, one block per
// 1024-word output slab, lanes staged `group` at a time.
//
// Replaces fdeflate_tpu/ops/repack.py:_combine_kernel_grouped (via
// linear_from_rows(group=K)): its output equals K2's (each lane's used
// window words ORed into the stream words at bit pos0[lane]).  The design
// is the TPU kernel's: block s owns output slab s; the contiguous range of
// lanes [lo[s], hi[s]) that can touch it comes from a search over lane
// start and end words done in torch beforehand (as JAX does it in XLA);
// the block stages those lanes' window words that land in the slab,
// `group` lanes at a time, into shared memory with double-buffered
// cp.async (the counterpart of the group DMA), then each thread ORs the
// shifted bits of every staged lane into the four words it owns.  Every
// word is written once, by its owner, with no atomics: the output needs no
// zeroing.
//
// Bound on the H100: memory traffic (the used window words in, the stream
// words out, ~2 x 6 MB at 16 x 1 MiB, C = 512), a few microseconds; the
// staging round trips through shared memory and the per-slab lane search
// add latency, which the double buffer hides in part.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSlab = 1024;
constexpr int kThreads = 256;   // four output words per thread
constexpr int kMaxGroup = 32;

struct Staged {
  int f[2][kMaxGroup];   // lane's first stream word (pos0 >> 5)
  int nw[2][kMaxGroup];  // used window words
  int sh[2][kMaxGroup];  // bit shift (pos0 & 31)
  int ja[2][kMaxGroup];  // first staged window word
  int n[2][kMaxGroup];   // staged window words
};

// Stage lanes [i0, min(i0 + K, hi)) into buffer `slot`: their window words
// ja..jb-1 that can reach slab words [s0, s0 + 1024), one 4-byte cp.async
// each (neighbouring threads on neighbouring words of one lane), committed
// as one group.
__device__ void stage(const uint32_t* __restrict__ win,
                      const int32_t* __restrict__ chunk_bits,
                      const int32_t* __restrict__ pos0, uint32_t* buf,
                      Staged& st, int slot, int i0, int hi, int K, int span,
                      int s0, int wwin) {
  if (threadIdx.x < K) {
    int k = threadIdx.x;
    int i = i0 + k;
    int f = 0, nw = 0, sh = 0, ja = 0, n = 0;
    if (i < hi) {
      int p = pos0[i];
      f = p >> 5;
      sh = p & 31;
      nw = (chunk_bits[i] + 31) >> 5;
      ja = max(0, s0 - f - 1);
      n = max(0, min(nw, s0 + kSlab - f) - ja);
    }
    st.f[slot][k] = f;
    st.nw[slot][k] = nw;
    st.sh[slot][k] = sh;
    st.ja[slot][k] = ja;
    st.n[slot][k] = n;
  }
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    const uint32_t* src =
        win + static_cast<int64_t>(i0 + k) * wwin + st.ja[slot][k];
    uint32_t* dst = buf + (slot * K + k) * span;
    for (int j = threadIdx.x; j < st.n[slot][k]; j += blockDim.x)
      __pipeline_memcpy_async(dst + j, src + j, 4);
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(kThreads)
combine_grouped_kernel(const uint32_t* __restrict__ win,
                       const int32_t* __restrict__ chunk_bits,
                       const int32_t* __restrict__ pos0,
                       const int32_t* __restrict__ lo_g,
                       const int32_t* __restrict__ hi_g,
                       uint32_t* __restrict__ words, int wwin, int W,
                       int nslabs, int K, int span) {
  extern __shared__ uint32_t buf[];  // [2][K][span]
  __shared__ Staged st;
  const int s = blockIdx.x;
  const int b = s / nslabs;
  const int s0 = (s % nslabs) * kSlab;
  const int lo = lo_g[s];
  const int hi = hi_g[s];
  const int ngroups = hi > lo ? (hi - lo + K - 1) / K : 0;

  uint32_t acc[kSlab / kThreads] = {};
  if (ngroups > 0)
    stage(win, chunk_bits, pos0, buf, st, 0, lo, hi, K, span, s0, wwin);
  for (int g = 0; g < ngroups; ++g) {
    const int slot = g & 1;
    if (g + 1 < ngroups) {
      stage(win, chunk_bits, pos0, buf, st, slot ^ 1, lo + (g + 1) * K, hi,
            K, span, s0, wwin);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const int nk = min(K, hi - (lo + g * K));
    for (int r = 0; r < kSlab / kThreads; ++r) {
      const int w = s0 + threadIdx.x + r * kThreads;
      uint32_t a = acc[r];
      for (int k = 0; k < nk; ++k) {
        const int j = w - st.f[slot][k];
        const int nw = st.nw[slot][k];
        if (j < 0 || j > nw) continue;
        const uint32_t* row = buf + (slot * K + k) * span - st.ja[slot][k];
        const int sh = st.sh[slot][k];
        if (j < nw) a |= row[j] << sh;
        if (j >= 1 && sh) a |= row[j - 1] >> (32 - sh);
      }
      acc[r] = a;
    }
    __syncthreads();
  }
  for (int r = 0; r < kSlab / kThreads; ++r) {
    const int w = s0 + threadIdx.x + r * kThreads;
    if (w < W) words[static_cast<int64_t>(b) * W + w] = acc[r];
  }
}

}  // namespace

extern "C" int fdt_combine_grouped(const void* win, const void* chunk_bits,
                                   const void* pos0, const void* lo,
                                   const void* hi, void* words, int B,
                                   int wwin, int W, int K, void* stream) {
  const int nslabs = (W + kSlab - 1) / kSlab;
  const int span = wwin < kSlab + 1 ? wwin : kSlab + 1;
  const size_t smem = 2 * static_cast<size_t>(K) * span * sizeof(uint32_t);
  if (K < 1 || K > kMaxGroup || smem > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        combine_grouped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  combine_grouped_kernel<<<B * nslabs, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(win),
      static_cast<const int32_t*>(chunk_bits),
      static_cast<const int32_t*>(pos0), static_cast<const int32_t*>(lo),
      static_cast<const int32_t*>(hi), static_cast<uint32_t*>(words), wwin, W,
      nslabs, K, span);
  return static_cast<int>(cudaGetLastError());
}
