// Per-lane bit machines of the fixed-geometry codec.
//
// A lane is one S-byte chunk of one stream (lane = stream * C + chunk).
// Each function below is the whole sequential work of one lane; the
// kernels in assign_pack.cu and decode2.cu run one lane per thread.  The
// functions are plain C++ with no CUDA intrinsics, so the same source also
// compiles for the host.
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define FDT_HD __host__ __device__ __forceinline__
#else
#define FDT_HD inline
#endif

namespace fdt {

constexpr int kNbShift = 13;   // token = v | nbits << 13
constexpr int kMaxL = 12;      // longest code; decode peeks 12 bits

FDT_HD uint64_t load8(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const uint64_t*>(p);  // caller keeps p 8-aligned
#else
  uint64_t x;
  memcpy(&x, p, 8);
  return x;
#endif
}

// LSB-first bit accumulator that writes full 32-bit words to `out`.
struct BitWriter {
  uint64_t acc = 0;
  int nacc = 0;
  int wi = 0;
  int32_t total = 0;
  uint32_t* out;

  FDT_HD explicit BitWriter(uint32_t* o) : out(o) {}

  FDT_HD void put(int32_t tok) {  // nbits <= 13, so acc never holds > 44
    int nb = tok >> kNbShift;
    acc |= static_cast<uint64_t>(tok & ((1 << kNbShift) - 1)) << nacc;
    nacc += nb;
    total += nb;
    if (nacc >= 32) {
      out[wi++] = static_cast<uint32_t>(acc);
      acc >>= 32;
      nacc -= 32;
    }
  }
};

// Tokens closing a zero run whose `tail` bytes follow its literal zero and
// its 258-byte blocks: <= 4 literal zeros, or the length symbol (RFC 1951
// closed form, tail in 5..257), its extra bits and the 1-bit distance code.
FDT_HD void put_tail(BitWriter& w, int tail, const int32_t* len_tok,
                     int32_t zlit) {
  if (tail <= 4) {
    for (int i = 0; i < tail; ++i) w.put(zlit);
    return;
  }
  int x = tail - 3;
  int e = (x >= 8) + (x >= 16) + (x >= 32) + (x >= 64) + (x >= 128);
  w.put(len_tok[4 * e + (x >> e)]);           // symbol 257 + 4e + (x >> e)
  w.put((x & ((1 << e) - 1)) | ((e + 1) << kNbShift));
}

// K1: tokenize one lane and pack its bits from bit 0 of `win`.
//
// Semantics of ops/ultrafast_kernel._assign_tokens with split_S == S:
// 8-byte-chunk run membership (whole zero chunks; zeros ending a chunk;
// zeros opening a chunk while a run is live), membership only below the
// lane's 8-aligned length `al`, literals below its length `ln`, runs cut at
// the lane end.  A run emits a literal zero, one 285-token per further 258
// bytes, then its tail.  Writes all `wwin` words (zeros past the payload)
// and returns the payload bit count.
FDT_HD int32_t assign_pack_lane(const uint8_t* src, int S, int al, int ln,
                                bool prev_run, const int32_t* lit_tok,
                                const int32_t* len_tok, int32_t zlit,
                                int32_t t285, uint32_t* win, int wwin) {
  BitWriter w(win);
  bool in_run = false;
  int cnt = 0;  // run bytes after the opening literal zero, mod 258
  for (int j = 0; j < S && j < ln; j += 8) {
    uint64_t x = load8(src + j);
    int t = 8, l = 8;  // first nonzero byte; zero bytes at the chunk end
    for (int i = 7; i >= 0; --i) {
      if ((x >> (8 * i)) & 0xFF) t = i;
    }
    for (int i = 0; i < 8; ++i) {
      if ((x >> (8 * i)) & 0xFF) l = 7 - i;
    }
    bool czero = t == 8;
    for (int i = 0; i < 8; ++i) {
      int pos = j + i;
      bool member = (czero || (i < t && prev_run) || i >= 8 - l) && pos < al;
      if (member) {
        if (!in_run) {
          w.put(zlit);
          in_run = true;
          cnt = 0;
        } else if (++cnt == 258) {
          w.put(t285);
          cnt = 0;
        }
      } else {
        if (in_run) {
          put_tail(w, cnt, len_tok, zlit);
          in_run = false;
        }
        if (pos < ln) w.put(lit_tok[(x >> (8 * i)) & 0xFF]);
      }
    }
    prev_run = czero || l > 0;
  }
  if (in_run) put_tail(w, cnt, len_tok, zlit);
  int wi = w.wi;
  if (w.nacc > 0) win[wi++] = static_cast<uint32_t>(w.acc);
  for (; wi < wwin; ++wi) win[wi] = 0;
  return w.total;
}

// Little-endian byte sink for one lane's S output bytes (S % 4 == 0).
struct ByteSink {
  uint32_t* dst;
  uint32_t cur = 0;
  int fill = 0;  // bytes held in cur
  int wi = 0;
  int n = 0;     // bytes written so far

  FDT_HD explicit ByteSink(uint32_t* d) : dst(d) {}

  FDT_HD void put(uint32_t v) {
    cur |= v << (8 * fill);
    ++n;
    if (++fill == 4) {
      dst[wi++] = cur;
      cur = 0;
      fill = 0;
    }
  }

  FDT_HD void zeros(int k) {
    for (; k > 0 && fill != 0; --k) put(0);
    for (; k >= 4; k -= 4) {
      dst[wi++] = 0;
      n += 4;
    }
    fill += k;
    n += k;
  }
};

// K3: decode one lane of S bytes starting at absolute bit `start` of the
// stream row `row` (W words; words at or past W read as 0).
//
// Semantics of pallas_decode2._kernel_light: literals; zero runs of length
// base + extra bits with the 1 distance bit consumed unchecked; a run that
// overruns the lane is cut at S with all its bits counted; on EOB the lane
// stalls (consumes nothing more, writes zeros to the lane end).  Returns
// the exit bit relative to `start`.
FDT_HD int32_t decode_lane(const uint32_t* row, int64_t W, int64_t start,
                           const int32_t* dtab, uint32_t* dst, int S) {
  int64_t wnext = start >> 5;
  auto fetch = [&]() -> uint64_t {
    uint64_t v = (wnext >= 0 && wnext < W) ? row[wnext] : 0u;
    ++wnext;
    return v;
  };
  int sh = static_cast<int>(start & 31);
  uint64_t buf = fetch() >> sh;
  int nbuf = 32 - sh;
  int32_t pos = 0;
  ByteSink out(dst);
  while (out.n < S) {
    if (nbuf < 32) {
      buf |= fetch() << nbuf;
      nbuf += 32;
    }
    int32_t e = dtab[buf & ((1u << kMaxL) - 1)];
    int L = (e >> 16) & 0x1F;
    int cls = (e >> 13) & 3;
    int val = e & 0x1FF;
    if (cls == 0) {
      out.put(static_cast<uint32_t>(val));
    } else if (cls == 2) {
      int extra = (e >> 9) & 0xF;
      int run = val + static_cast<int>((buf >> L) & ((1u << extra) - 1));
      L += extra + 1;
      out.zeros(run < S - out.n ? run : S - out.n);
    } else {
      break;  // EOB: stall
    }
    buf >>= L;
    nbuf -= L;
    pos += L;
  }
  out.zeros(S - out.n);
  return pos;
}

}  // namespace fdt
