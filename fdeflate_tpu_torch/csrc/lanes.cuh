// Per-lane bit machines of the fixed-geometry codec.
//
// A lane is one S-byte chunk of one stream (lane = stream * C + chunk).
// Each function below is the whole sequential work of one lane; the
// kernels in assign_pack.cu, decode2.cu and decode_sep.cu run one lane per
// thread.  The functions are plain C++ (device intrinsics only behind
// __CUDA_ARCH__, with a host equivalent), so the same source also compiles
// for the host.
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

FDT_HD int bitrev12(uint32_t x) {
#ifdef __CUDA_ARCH__
  return static_cast<int>(__brev(x) >> 20);
#else
  int r = 0;
  for (int i = 0; i < kMaxL; ++i) r |= ((x >> i) & 1) << (kMaxL - 1 - i);
  return r;
#endif
}

// K6: decode one lane of S bytes of a class-separated tree (ops/septree)
// starting at absolute bit `start` of the stream row `row` (W words; words
// at or past W read as 0).
//
// Semantics of pallas_decode2._kernel_sep: the lane makes S / 4 word steps
// of up to 4 sub-steps.  A sub-step first takes pending run bytes into the
// word; if the word still has room and no run is pending it decodes one
// symbol: code length L = 1 + #{l < 12: r12 >= bounds[l]} on the
// bit-reversed 12-bit peek r12, sorted index kvals[L] + (r12 >> (12 - L)).
// L < 12 is a literal whose byte comes from the 4-packed `vals`; L == 12
// is EOB when idx - n_lit == 0 (12 bits consumed, nothing written,
// decoding goes on) and otherwise a length symbol whose zero run (RFC 1951
// closed-form base and extra bits, 1 distance bit consumed unchecked) is
// written as zero bytes.  The run left over when the word is full carries
// to the next step and is dropped at the lane end.  Returns the exit bit
// relative to `start`.
FDT_HD int32_t decode_sep_lane(const uint32_t* row, int64_t W, int64_t start,
                               const int32_t* meta, const int32_t* vals,
                               uint32_t* dst, int S) {
  int64_t wnext = start >> 5;
  auto fetch = [&]() -> uint64_t {
    uint64_t v = (wnext >= 0 && wnext < W) ? row[wnext] : 0u;
    ++wnext;
    return v;
  };
  int sh = static_cast<int>(start & 31);
  uint64_t buf = fetch() >> sh;
  int nbuf = 32 - sh;
  const int n_lit = meta[15];
  int32_t pos = 0;
  int run = 0;  // run bytes not yet written
  for (int u = 0; u < S / 4; ++u) {
    uint32_t word = 0;
    int filled = 0;
    for (int s = 0; s < 4; ++s) {
      int take = run < 4 - filled ? run : 4 - filled;
      filled += take;
      run -= take;
      if (filled == 4 || run != 0) continue;
      if (nbuf < 32) {  // a sub-step consumes at most 12 + 5 + 1 bits
        buf |= fetch() << nbuf;
        nbuf += 32;
      }
      uint32_t bits = static_cast<uint32_t>(buf);
      int r12 = bitrev12(bits);
      int L = 1;
      for (int l = 1; l < kMaxL; ++l) L += r12 >= meta[l];
      int idx = meta[16 + L] + (r12 >> (kMaxL - L));
      int n = L;
      if (L < kMaxL) {
        uint32_t v = static_cast<uint32_t>(vals[idx >> 2]) >> (8 * (idx & 3));
        word |= (v & 0xFFu) << (8 * filled);
        ++filled;
      } else if (idx > n_lit) {
        int sp = idx - n_lit - 1;  // length symbol 257 + sp
        int e = (sp < 4 || sp == 28) ? 0 : (sp >> 2) - 1;
        int base = sp == 28 ? 258 : sp < 4 ? sp + 3 : ((4 + (sp & 3)) << e) + 3;
        run = base + static_cast<int>((bits >> L) & ((1u << e) - 1));
        n += e + 1;
      }
      buf >>= n;
      nbuf -= n;
      pos += n;
    }
    int take = run < 4 - filled ? run : 4 - filled;
    run -= take;
    dst[u] = word;
  }
  return pos;
}

// K8: decode one lane's window of the trained tree, T output words from bit
// 0 of `win` (wwin words; words at or past wwin read as 0).
//
// Semantics of pallas_decode2._kernel (the unrolled body): T word steps of
// up to 4 sub-steps.  A sub-step first takes pending run bytes (zeros)
// into the word; if the word still has room and no run is pending it
// decodes one symbol: code length L = 1 + #{l < 12: r12 >= bounds[l]} on
// the bit-reversed 12-bit peek r12, canonical index kvals[L] +
// (r12 >> (12 - L)), entry packed[index] (val | extra << 9 | cls << 13; an
// index outside the 512-entry table reads 0, a zero literal).  A literal
// fills a byte; a length symbol sets a run of base + extra bits and
// consumes its 1 distance bit unchecked; anything else (EOB) consumes
// nothing, so the lane stalls.  The run left over when the last word is
// full is dropped.  Returns the bits consumed.
FDT_HD int32_t decode_canon_lane(const uint32_t* win, int wwin,
                                 const int32_t* bounds, const int32_t* kvals,
                                 const int32_t* packed, uint32_t* dst,
                                 int T) {
  int wnext = 0;
  auto fetch = [&]() -> uint64_t {
    uint64_t v = wnext < wwin ? win[wnext] : 0u;
    ++wnext;
    return v;
  };
  uint64_t buf = fetch();
  int nbuf = 32;
  int32_t pos = 0;
  int run = 0;  // run bytes not yet written
  for (int u = 0; u < T; ++u) {
    uint32_t word = 0;
    int filled = 0;
    for (int s = 0; s < 4; ++s) {
      int take = run < 4 - filled ? run : 4 - filled;
      filled += take;
      run -= take;
      if (filled == 4 || run != 0) continue;
      if (nbuf < 32) {  // a sub-step consumes at most 12 + 5 + 1 bits
        buf |= fetch() << nbuf;
        nbuf += 32;
      }
      uint32_t bits = static_cast<uint32_t>(buf);
      int r12 = bitrev12(bits);
      int L = 1;
      for (int l = 1; l < kMaxL; ++l) L += r12 >= bounds[l];
      int idx = kvals[L] + (r12 >> (kMaxL - L));
      int e = (idx >= 0 && idx < 512) ? packed[idx] : 0;
      int val = e & 0x1FF;
      int cls = e >> 13;
      int n = 0;
      if (cls == 0) {
        word |= static_cast<uint32_t>(val) << (8 * filled);
        ++filled;
        n = L;
      } else if (cls == 2) {
        int extra = (e >> 9) & 0xF;
        run = val + static_cast<int>((bits >> L) & ((1u << extra) - 1));
        n = L + extra + 1;
      }
      buf >>= n;
      nbuf -= n;
      pos += n;
    }
    int take = run < 4 - filled ? run : 4 - filled;
    run -= take;
    dst[u] = word;
  }
  return pos;
}

// K9: one pair of packed byte tokens (tok = v | nb << 13 | rel << 18, rel
// the first token's lane-relative bit offset) -> its window word `wi`
// (-3 for an empty pair) and the low and high words of its bits shifted to
// rel & 31 (pallas_pack._kernel's pair decode, `hi` in its
// (vp >> 1) >> (31 - sh) form).
FDT_HD void pack_pair(int32_t t0, int32_t t1, int* wi, uint32_t* lo,
                      uint32_t* hi) {
  int n0 = (t0 >> 13) & 0x1F;
  int n1 = (t1 >> 13) & 0x1F;
  uint32_t vp = static_cast<uint32_t>(t0 & 0x1FFF) |
                (static_cast<uint32_t>(t1 & 0x1FFF) << n0);
  int rel = t0 >> 18;
  uint32_t sh = static_cast<uint32_t>(rel & 31);
  *lo = vp << sh;
  *hi = (vp >> 1) >> (31 - sh);
  *wi = n0 + n1 > 0 ? rel >> 5 : -3;
}

// K9: window word `w` of a lane, the all-pairs select-accumulate of
// pallas_pack._kernel over the lane's P decoded pairs:
// OR_p (wi_p == w ? lo_p : 0) | (wi_p == w - 1 ? hi_p : 0).
FDT_HD uint32_t pack_v1_word(const int* wi, const uint32_t* lo,
                             const uint32_t* hi, int P, int w) {
  uint32_t acc = 0;
  for (int p = 0; p < P; ++p) {
    acc |= (wi[p] == w ? lo[p] : 0u) | (wi[p] == w - 1 ? hi[p] : 0u);
  }
  return acc;
}

}  // namespace fdt
