// Per-lane bit machines of the foreign-stream decoder.
//
// K4 inflate_records decodes one deflate block per lane into records; K5
// validate_headers checks one candidate dynamic-block header per lane.
// Each function below is the whole sequential work of one lane; the
// kernels in inflate_records.cu and validate_headers.cu run one lane per
// thread.  Plain C++ apart from two bit-reversal intrinsics, so the same
// source also compiles for the host (tests/test_torch_lanes_host.py).
#pragma once

#include "lanes.cuh"

namespace fdt {

// Record words (pallas_inflate REC_*): kind in bits 28..30.
constexpr int32_t kRecLits = 1 << 28;   // | count << 16 | lit1 << 8 | lit0
constexpr int32_t kRecMatch = 2 << 28;  // | (len - 3) << 15 | (dist - 1)
constexpr int32_t kRecEob = 3 << 28;
constexpr int32_t kRecErr = 4 << 28;

// Lane exit codes of inflate_lane.  0-2 are decode_records_np's `done`;
// 3-5 refine it for the sequential decoder's error classes.
constexpr int32_t kDoneSlots = 0;      // ran out of record slots
constexpr int32_t kDoneEob = 1;        // end of block
constexpr int32_t kDoneBadLitlen = 2;  // invalid literal/length code
constexpr int32_t kDoneBadDist = 3;    // invalid distance code
constexpr int32_t kDoneTruncated = 4;  // a symbol runs past bit_end
constexpr int32_t kDoneTooFar = 5;     // distance past the output so far

constexpr int kMetaRows = 64;   // pallas_inflate.foreign_meta meta i32[64]
constexpr int kTabPairs = 160;  // and tab i32[160] (two 15-bit entries each)
constexpr int kTabEntries = 2 * kTabPairs;

FDT_HD uint32_t bitrev15(uint32_t x) {  // reverse the low 15 bits
#ifdef __CUDA_ARCH__
  return __brev(x) >> 17;
#else
  uint32_t r = 0;
  for (int i = 0; i < 15; ++i) r |= ((x >> i) & 1u) << (14 - i);
  return r;
#endif
}

FDT_HD uint32_t bitrev7(uint32_t x) {  // reverse the low 7 bits
#ifdef __CUDA_ARCH__
  return __brev(x) >> 25;
#else
  uint32_t r = 0;
  for (int i = 0; i < 7; ++i) r |= ((x >> i) & 1u) << (6 - i);
  return r;
#endif
}

// Little-endian stream words; words at or past `wend` read as 0.
struct WordReader {
  const uint32_t* w;
  int64_t wend;

  FDT_HD uint32_t word(int64_t i) const {
    return (i >= 0 && i < wend) ? w[i] : 0u;
  }
  FDT_HD uint32_t peek32(int64_t p) const {  // the 32 bits from bit p
    int64_t i = p >> 5;
    uint64_t v = static_cast<uint64_t>(word(i)) |
                 (static_cast<uint64_t>(word(i + 1)) << 32);
    return static_cast<uint32_t>(v >> (p & 31));
  }
};

// Canonical decode of a peek against one tree of a foreign_meta block:
// bounds at meta[brow + 1 .. brow + 14], kvals at meta[brow + 16 + L].
// Returns the code length; *idx is the index into the packed table.
FDT_HD int canon15(uint32_t bits, const int32_t* meta, int brow, int* idx) {
  int32_t r15 = static_cast<int32_t>(bitrev15(bits & 0x7FFF));
  int L = 1;
  for (int l = 1; l < 15; ++l) L += r15 >= meta[brow + l];
  int32_t i = meta[brow + 16 + L] + (r15 >> (15 - L));
  *idx = i < 0 ? 0 : (i >= kTabEntries ? kTabEntries - 1 : i);
  return L;
}

FDT_HD int32_t tab_entry(const int32_t* tab, int idx) {
  return static_cast<int32_t>(
      (static_cast<uint32_t>(tab[idx >> 1]) >> ((idx & 1) * 16)) & 0x7FFF);
}

// K4: decode one block from absolute bit `pos` into at most K records,
// record u at recs[u * stride].  Semantics of
// pallas_inflate.decode_records_np (a record is <= 2 literals, a match, EOB
// or an error; a lane stops at EOB or at an error, leaving its position
// before the failing symbol), plus two checks that stop the lane with an
// error record: a symbol whose bits run past `bit_end` (kDoneTruncated; for
// an invalid distance code the bits counted are the length code's and its
// extra bits', as ops/inflate.decode_symbols counts them) and a distance
// larger than out0 plus the bytes this lane has produced (kDoneTooFar).
// Truncation wins over an invalid code, which wins over a distance too
// far, as in decode_symbols.  Slots past the last record are not written.
FDT_HD int32_t inflate_lane(const WordReader& rd, int64_t pos, int64_t bit_end,
                            int64_t out0, const int32_t* meta,
                            const int32_t* tab, int32_t* recs, int64_t stride,
                            int K, int64_t* bpos_out, int64_t* nout_out) {
  int64_t nout = 0;
  int32_t done = kDoneSlots;
  for (int u = 0; u < K; ++u) {
    uint32_t bits = rd.peek32(pos);
    int idx1;
    int L1 = canon15(bits, meta, 0, &idx1);
    int32_t e1 = tab_entry(tab, idx1);
    int cls1 = e1 >> 13;
    int32_t rec = kRecErr;
    int32_t err = -1;
    int64_t used = L1;
    int64_t adv = 0;
    if (cls1 == 3) {
      err = kDoneBadLitlen;
    } else if (cls1 == 1) {
      rec = kRecEob;
    } else if (cls1 == 0) {
      int32_t lit0 = e1 & 0x1FF;
      int idx2;
      int L2 = canon15(bits >> L1, meta, 0, &idx2);
      int32_t e2 = tab_entry(tab, idx2);
      if ((e2 >> 13) == 0) {
        rec = kRecLits | (2 << 16) | ((e2 & 0xFF) << 8) | lit0;
        used += L2;
        adv = 2;
      } else {
        rec = kRecLits | (1 << 16) | lit0;
        adv = 1;
      }
    } else {
      int ext1 = (e1 >> 9) & 0xF;
      int32_t run = (e1 & 0x1FF) +
                    static_cast<int32_t>((bits >> L1) & ((1u << ext1) - 1));
      used += ext1;
      uint32_t dbits = rd.peek32(pos + used);
      int idxd;
      int Ld = canon15(dbits, meta, 32, &idxd);
      int32_t s = tab_entry(tab, idxd) & 0x1FF;
      if (s == 0x1FF) {
        err = kDoneBadDist;
      } else {
        int dext = (s >> 1) - 1 > 0 ? (s >> 1) - 1 : 0;
        int32_t dbase = s < 2 ? s + 1 : ((2 + (s & 1)) << dext) + 1;
        int32_t dist = dbase +
                       static_cast<int32_t>((dbits >> Ld) & ((1u << dext) - 1));
        rec = kRecMatch | ((run - 3) << 15) | (dist - 1);
        used += Ld + dext;
        adv = run;
        if (dist > out0 + nout) err = kDoneTooFar;
      }
    }
    if (pos + used > bit_end) err = kDoneTruncated;
    if (err >= 0) {
      recs[u * stride] = kRecErr;
      done = err;
      break;
    }
    recs[u * stride] = rec;
    pos += used;
    nout += adv;
    if (cls1 == 1) {
      done = kDoneEob;
      break;
    }
  }
  *bpos_out = pos;
  *nout_out = nout;
  return done;
}

// K5: validate the candidate dynamic-block header at absolute bit `c` of a
// stream of n_bits payload bits.  Semantics of
// parallel/discovery.validate_stage2 (the numpy oracle): parse
// HLIT/HDIST/HCLEN and the 19 code-length (CL) code lengths, build the
// 7-bit canonical CL decode, then decode at most 320 sections (a length or
// a 16/17/18 repeat) while tracking the litlen and distance Kraft sums,
// the end-of-block symbol's length and the structural errors.  Returns 1
// for a valid header; *end_out is the bit just past the last section
// decoded (the header's end when valid).
FDT_HD int32_t validate_lane(const WordReader& rd, int64_t c, int64_t n_bits,
                             int64_t* end_out) {
  const int kClcl[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                         11, 4, 12, 3, 13, 2, 14, 1, 15};
  auto field = [&](int64_t p, int w) -> int32_t {
    return static_cast<int32_t>(rd.peek32(p) & ((1u << w) - 1));
  };
  int32_t hlit = field(c + 3, 5) + 257;
  int32_t hdist = field(c + 8, 5) + 1;
  int32_t ncl = field(c + 13, 4) + 4;
  int32_t cl[19];
  for (int j = 0; j < 19; ++j)
    cl[kClcl[j]] = j < ncl ? field(c + 17 + 3 * j, 3) : 0;

  int32_t cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  for (int s = 0; s < 19; ++s) cnt[cl[s]] += cl[s] > 0;
  int32_t bound[8], kval[8];
  bound[0] = 0;
  kval[0] = 0;
  int32_t code = 0, acc = 0;
  for (int L = 1; L <= 7; ++L) {
    bound[L] = (code + cnt[L]) << (7 - L);
    kval[L] = acc - code;
    acc += cnt[L];
    code = (code + cnt[L]) << 1;
  }
  // Symbols in (length, symbol) order, unused symbols last in symbol order.
  int8_t order[19];
  int k = 0;
  for (int L = 1; L <= 7; ++L)
    for (int s = 0; s < 19; ++s)
      if (cl[s] == L) order[k++] = static_cast<int8_t>(s);
  for (int s = 0; s < 19; ++s)
    if (cl[s] == 0) order[k++] = static_cast<int8_t>(s);

  int64_t pos = c + 17 + 3 * ncl;
  int32_t total = hlit + hdist;
  int32_t written = 0, prev = 0, kraft_l = 0, kraft_d = 0, nz_d = 0;
  int32_t len256 = 0;
  bool bad = false;
  for (int step = 0; step < 320 && !bad && written < total; ++step) {
    uint32_t v = rd.peek32(pos);
    int32_t r7 = static_cast<int32_t>(bitrev7(v & 0x7F));
    int L = 1;
    for (int l = 1; l < 7; ++l) L += (r7 >= bound[l]) && (bound[l] < 128);
    int32_t idx = kval[L] + (r7 >> (7 - L));
    int32_t sym = order[idx < 0 ? 0 : (idx > 18 ? 18 : idx)];
    if (idx < 0 || idx > 18 || cl[sym] != L) bad = true;
    bool plain = sym <= 15;
    int ebits = sym == 16 ? 2 : (sym == 17 ? 3 : 7);
    int32_t ebase = sym == 18 ? 11 : 3;
    int32_t rep = plain ? 1 : ebase + static_cast<int32_t>(
                                          (v >> L) & ((1u << ebits) - 1));
    int32_t value = plain ? sym : (sym == 16 ? prev : 0);
    if (sym == 16 && written == 0) bad = true;
    if (written + rep > total) bad = true;
    if (!bad) {
      int32_t lim = written + rep < hlit ? written + rep : hlit;
      int32_t l_cnt = lim - written > 0 ? lim - written : 0;
      int32_t d_cnt = rep - l_cnt;
      if (value > 0) {
        kraft_l += (1 << (15 - value)) * l_cnt;
        kraft_d += (1 << (15 - value)) * d_cnt;
        nz_d += d_cnt;
      }
      if (written <= 256 && 256 < written + rep && hlit > 256) len256 = value;
      if (plain) prev = sym;
      written += rep;
      pos += L + (plain ? 0 : ebits);
    }
    if (pos + 7 >= n_bits) bad = true;
  }
  *end_out = pos;
  return !bad && written == total && kraft_l == (1 << 15) && len256 > 0 &&
         (kraft_d == (1 << 15) || nz_d <= 1);
}

}  // namespace fdt
