// Lane code of the foreign-stream decoder.
//
// K4 inflate_records decodes one deflate block per lane into records, by a
// group of m threads (inflate_group, written over warp.cuh's policy as
// lanes.cuh's decode2_group is); K5 validate_headers checks one candidate
// dynamic-block header per thread (validate_lane, and the pieces its
// kernel splits around a compaction).  Plain C++ apart from bit-reversal
// intrinsics, so the same source also compiles for the host
// (tests/test_torch_lanes_host.py).
#pragma once

#include "lanes.cuh"

namespace fdt {

// Record words (pallas_inflate REC_*): kind in bits 28..30.
constexpr int32_t kRecLits = 1 << 28;   // | count << 16 | lit1 << 8 | lit0
constexpr int32_t kRecMatch = 2 << 28;  // | (len - 3) << 15 | (dist - 1)
constexpr int32_t kRecEob = 3 << 28;
constexpr int32_t kRecErr = 4 << 28;

// Lane exit codes of K4.  0-2 are decode_records_np's `done`; 3-5 refine
// it for the sequential decoder's error classes.
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

// ---- K4, a group of threads per lane --------------------------------------
//
// Semantics of ops/inflate_records.inflate_records_plain (and of
// pallas_inflate.decode_records_np): decode one block from absolute bit
// `start` into at most K records, record u at recs[u * stride].  A record
// is <= 2 literals (two when the next symbol is also a literal), a match,
// EOB or an error; a lane stops at EOB or at an error, leaving its position
// before the failing symbol, with an error record.  Besides the invalid
// literal/length and distance codes, two checks stop a lane: a symbol whose
// bits run past `bit_end` (kDoneTruncated; for an invalid distance code the
// bits counted are the length code's and its extra bits', as
// ops/inflate.decode_symbols counts them) and a distance larger than out0
// plus the bytes the lane has produced (kDoneTooFar).  Truncation wins
// over an invalid code, which wins over a distance too far.  A lane that
// fills its K slots ends with done 0 and its position after slot K - 1.
// Slots past the last record are not written.
//
// The lane is decoded span by span: a span stages kInfTileWords words from
// the lane's position in shared memory (words at or past `wend` read as
// 0), splits a hint of its bit length into m sub-ranges, and runs K3's
// protocol on records instead of symbols: thread i decodes records from
// its sub-range's first bit to its first record boundary after a match at
// or past the next one; while a thread's start differs from the previous
// thread's exit it decodes again from that exit (sync rounds).  Exits are
// record boundaries, so a thread that started on a symbol boundary inside a
// literal pair is not in step with the serial decode, whatever its bit.
// At the fixed point every live segment is the serial decode's; scans of
// the segments' record and byte counts give each its first slot and its
// output offset, and a write pass decodes each live segment once more,
// storing its records and checking distances against out0 plus the bytes
// before them (too far is known only then).  The first segment to end the
// span (EOB, an error, the K slots, or a record past the staged words)
// decides what follows; segments after a too-far error clear the slots
// they wrote.  The hint (inf_hint_end: the next lane's start when it lies
// in the same stream, else the stream's end) decides only where threads
// start, never the result.
//
// The decode lookup is built once per lane: a direct table over the first
// kInfBits bits of the litlen and of the distance peek, whose entry is the
// canonical decode (canon15) wherever every peek with those bits decodes
// alike in no more than kInfBits bits, and -1 elsewhere, where the compare
// chain runs.

constexpr int kInfBits = 10;
constexpr int kInfTable = 1 << kInfBits;
constexpr int kInfTileWords = 2048;
// A record starting at or before bit kInfPmax of the staged words reads
// them only: a record reads 32 bits at its start and 32 more at most 20
// bits on (the distance code after a length code and its extra bits).
constexpr int32_t kInfPmax = 32 * (kInfTileWords - 3);
constexpr int kInfBitsPerThread = 1024;

// Threads per lane from the lane's hinted span (~1024 bits, ~100 records,
// a thread; a power of two up to 32).
FDT_HD int inf_threads(int64_t span_bits) {
  int m = 1;
  while (m < 32 && static_cast<int64_t>(kInfBitsPerThread) * m < span_bits)
    m <<= 1;
  return m;
}

// Where the hint of lane `lane` ends: the next lane's start when it lies
// after this lane's and before its stream's end, else the stream's end.
FDT_HD int64_t inf_hint_end(const int64_t* start, const int64_t* wend,
                            const int64_t* bit_end, int64_t L, int64_t lane) {
  int64_t e = wend[lane] * 32;
  if (bit_end[lane] < e) e = bit_end[lane];
  if (lane + 1 < L && start[lane + 1] > start[lane] && start[lane + 1] < e)
    e = start[lane + 1];
  return e;
}

// Table entry of peek x (< kInfTable) for the tree at meta row brow:
// (code length << 16) | table entry, or -1.  The compare chain's length is
// a sum of comparisons each monotone in the reversed peek, so it is the
// same for every completion of x's bits iff it is the same for the least
// and the greatest.
FDT_HD int32_t inf_entry(const int32_t* meta, const int32_t* tab, int brow,
                         uint32_t x) {
  int ilo, ihi;
  const int llo = canon15(x, meta, brow, &ilo);
  const int lhi = canon15(x | (0x7FFFu & ~(kInfTable - 1u)), meta, brow, &ihi);
  if (llo != lhi || llo > kInfBits) return -1;
  return (llo << 16) | tab_entry(tab, ilo);
}

// Thread i of n's part of the lane's litlen and distance tables.
FDT_HD void inf_table_part(const int32_t* meta, const int32_t* tab,
                           int32_t* lit, int32_t* dist, int i, int n) {
  for (int x = i; x < kInfTable; x += n) {
    lit[x] = inf_entry(meta, tab, 0, x);
    dist[x] = inf_entry(meta, tab, 32, x);
  }
}

struct InfTables {
  const int32_t* lit;
  const int32_t* dist;
  const int32_t* meta;
  const int32_t* tab;
};

// Code length of the peek `bits` under the litlen (d false) or distance
// tree; *e its table entry.
FDT_HD int inf_lookup(const InfTables& t, bool d, uint32_t bits, int32_t* e) {
  const int32_t x = (d ? t.dist : t.lit)[bits & (kInfTable - 1)];
  if (x >= 0) {
    *e = x & 0x7FFF;
    return x >> 16;
  }
  int idx;
  const int L = canon15(bits, t.meta, d ? 32 : 0, &idx);
  *e = tab_entry(t.tab, idx);
  return L;
}

struct InfStep {
  int32_t rec;   // the record (kRecErr on an error)
  int32_t used;  // bits consumed
  int32_t adv;   // output bytes
  int32_t err;   // kDone* error of the symbol (too far not checked), or -1
  int32_t dist;  // a match's distance, else 0
  bool eob;
};

// One record from bit p of the staged words; rel_end is bit_end there.
FDT_HD InfStep inflate_step(const uint32_t* sw, int32_t p, int32_t rel_end,
                            const InfTables& t) {
  InfStep r{kRecErr, 0, 0, -1, 0, false};
  const uint32_t bits = peek32(sw, p);
  int32_t e1;
  const int L1 = inf_lookup(t, false, bits, &e1);
  const int cls1 = e1 >> 13;
  r.used = L1;
  if (cls1 == 3) {
    r.err = kDoneBadLitlen;
  } else if (cls1 == 1) {
    r.rec = kRecEob;
    r.eob = true;
  } else if (cls1 == 0) {
    const int32_t lit0 = e1 & 0x1FF;
    int32_t e2;
    const int L2 = inf_lookup(t, false, bits >> L1, &e2);
    if ((e2 >> 13) == 0) {
      r.rec = kRecLits | (2 << 16) | ((e2 & 0xFF) << 8) | lit0;
      r.used += L2;
      r.adv = 2;
    } else {
      r.rec = kRecLits | (1 << 16) | lit0;
      r.adv = 1;
    }
  } else {
    const int ext1 = (e1 >> 9) & 0xF;
    const int32_t run = (e1 & 0x1FF) +
                        static_cast<int32_t>((bits >> L1) & ((1u << ext1) - 1));
    r.used += ext1;
    const uint32_t dbits = peek32(sw, p + r.used);
    int32_t ed;
    const int Ld = inf_lookup(t, true, dbits, &ed);
    const int32_t s = ed & 0x1FF;
    if (s == 0x1FF) {
      r.err = kDoneBadDist;
    } else {
      const int dext = (s >> 1) - 1 > 0 ? (s >> 1) - 1 : 0;
      const int32_t dbase = s < 2 ? s + 1 : ((2 + (s & 1)) << dext) + 1;
      r.dist = dbase + static_cast<int32_t>((dbits >> Ld) & ((1u << dext) - 1));
      r.rec = kRecMatch | ((run - 3) << 15) | (r.dist - 1);
      r.used += Ld + dext;
      r.adv = run;
    }
  }
  if (p + r.used > rel_end) r.err = kDoneTruncated;
  return r;
}

// How a K4 segment decode ended.
enum : int {
  kInfStop = 0,  // at a record boundary at or past `stop`
  kInfEob = 1,   // after an EOB record
  kInfErr = 2,   // at an error record (exit: the failing symbol's start)
  kInfOff = 3,   // a record start past kInfPmax (the next span's)
  kInfFull = 4,  // the lane's K slots are full (o0 + n >= want)
};

struct InfSeg {
  int32_t exit;   // bit after the last record (at an error: its start)
  int32_t n;      // records, an error record included
  int32_t bytes;  // output bytes of the records
  int end;
  int32_t err;    // kDone* code at kInfErr
};

// K4 segment decode: records from bit p until a boundary at or past `stop`
// that follows a match (at least one record), EOB, an error, a start past
// kInfPmax, or o0 + n >= want.  A boundary after a match is one whatever
// pairing of literals came before it: a thread that started out of step
// with the pairs is back in step there once its symbols are, so the next
// thread can start from its exit (inside a run of literals the pairs stay
// out of step to the run's end).  With `check`, a match farther than far0 plus the segment's
// bytes before it is a too-far error.  With `recs`, record r is stored at
// recs[r * stride].
FDT_HD InfSeg inflate_segment(const uint32_t* sw, int32_t p, int32_t stop,
                              int32_t rel_end, const InfTables& t, int32_t o0,
                              int32_t want, bool check, int64_t far0,
                              int32_t* recs, int64_t stride) {
  InfSeg r{p, 0, 0, kInfStop, -1};
  bool after_match = false;
  do {
    if (p > kInfPmax) {
      r.end = kInfOff;
      break;
    }
    const InfStep st = inflate_step(sw, p, rel_end, t);
    int32_t err = st.err;
    if (err < 0 && check && st.dist > 0 && st.dist > far0 + r.bytes)
      err = kDoneTooFar;
    if (err >= 0) {
      if (recs) recs[r.n * stride] = kRecErr;
      r.n += 1;
      r.end = kInfErr;
      r.err = err;
      break;
    }
    if (recs) recs[r.n * stride] = st.rec;
    p += st.used;
    r.bytes += st.adv;
    r.n += 1;
    if (st.eob) {
      r.end = kInfEob;
      break;
    }
    if (o0 + r.n >= want) {
      r.end = kInfFull;
      break;
    }
    after_match = st.dist > 0;
  } while (p < stop || !after_match);
  r.exit = p;
  return r;
}

// K4 lane: the block from `start` into recs[u * stride] (u < K), with the
// lane's stream bounds (`wend` words, `bit_end` bits), out0, the hint's
// end `hint_end`, the lane's tables and kInfTileWords words of staging
// `sw`, by the group g (warp.cuh) of m threads.  Writes *bpos_out,
// *nout_out and *done_out (kDone*).
template <class G>
FDT_GROUP void inflate_group(const G& g, const uint32_t* words, int64_t start,
                             int64_t wend, int64_t bit_end, int64_t out0,
                             int64_t hint_end, const InfTables& t,
                             uint32_t* sw, int32_t* recs, int64_t stride,
                             int K, int64_t* bpos_out, int64_t* nout_out,
                             int32_t* done_out) {
  const int m = g.m;
  typename G::template Var<int32_t> st, stop, pre, bpre, px;
  typename G::template Var<InfSeg> s, wr;
  typename G::template Var<bool> flag, dead, redo;
  auto plus = [](int32_t l, int32_t r) { return l + r; };
  int64_t P = start, nout = 0;
  int32_t u = 0, done = kDoneSlots;
  bool more = K > 0;
  while (more) {
    const int64_t w0 = P >> 5;
    const int32_t rel0 = static_cast<int32_t>(P & 31);
    g.each([&](int i) {
      for (int j = i; j < kInfTileWords; j += m) {
        const int64_t gi = w0 + j;
        if (gi >= 0 && gi < wend) g.copy(sw + j, words + gi, 4);
        else sw[j] = 0u;
      }
    });
    g.wait();
    const int64_t base = w0 << 5;
    const int64_t re = bit_end - base;
    const int32_t rel_end =
        re < -1 ? -1 : re > (1 << 30) ? (1 << 30) : static_cast<int32_t>(re);
    const int32_t want = K - u;
    const int64_t H = hint_end > P ? hint_end - P : kInfPmax - rel0 + 1;
    const int32_t Hc = clamp_hint(g.hint(H), rel0, kInfPmax);
    g.each([&](int i) {
      st[i] = sub_start(rel0, Hc, i, m);
      stop[i] = sub_start(rel0, Hc, i + 1, m);
      s[i] = inflate_segment(sw, st[i], stop[i], rel_end, t, 0, want, false,
                             0, nullptr, 0);
    });
    int rounds = 0;
    while (true) {  // sync rounds
      g.each([&](int i) {
        px[i] = s[i].exit;
        pre[i] = s[i].n;
        flag[i] = s[i].end != kInfStop;
      });
      g.up(px, 0);
      g.excl_scan(pre, 0, plus);
      const uint32_t ended = g.ballot(flag);
      g.each([&](int i) {
        dead[i] = seg_dead(i, (ended & ((1u << i) - 1)) != 0, pre[i], want);
        redo[i] = seg_redo(i, dead[i], st[i], px[i]);
      });
      if (!g.any(redo)) break;
      ++rounds;
      g.each([&](int i) {
        if (!redo[i]) return;
        st[i] = px[i];
        s[i] = inflate_segment(sw, st[i], stop[i], rel_end, t, 0, want, false,
                               0, nullptr, 0);
      });
    }
    g.each([&](int i) { bpre[i] = s[i].bytes; });
    g.excl_scan(bpre, 0, plus);
    g.each([&](int i) {  // the write pass
      wr[i] = InfSeg{st[i], 0, 0, kInfStop, -1};
      if (!dead[i])
        wr[i] = inflate_segment(sw, st[i], stop[i], rel_end, t, pre[i], want,
                                true, out0 + nout + bpre[i],
                                recs + static_cast<int64_t>(u + pre[i]) * stride,
                                stride);
      flag[i] = !dead[i] && wr[i].end != kInfStop;
    });
    const uint32_t endm = g.ballot(flag);
    if (endm) {  // segment f ends the span
      const int f = ctz32(endm);
      g.each([&](int i) {  // after a too-far error: slots past it
        if (dead[i] || i <= f) return;
        for (int32_t r = 0; r < wr[i].n; ++r)
          recs[static_cast<int64_t>(u + pre[i] + r) * stride] = 0;
      });
      const InfSeg F = g.bcast(wr, f);
      P = base + F.exit;
      u += g.bcast(pre, f) + F.n;
      nout += g.bcast(bpre, f) + F.bytes;
      more = F.end == kInfOff && u < K;
      if (F.end == kInfEob) done = kDoneEob;
      if (F.end == kInfErr) done = F.err;
    } else {  // every segment reached its stop: the hint was short
      const InfSeg l = g.bcast(wr, m - 1);
      P = base + l.exit;
      u += g.bcast(pre, m - 1) + l.n;
      nout += g.bcast(bpre, m - 1) + l.bytes;
      more = u < K;
    }
    g.span_done(rounds, !endm);
    g.sync();
  }
  g.each([&](int i) {
    if (i != 0) return;
    *bpos_out = P;
    *nout_out = nout;
    *done_out = done;
  });
}

// ---- K5, one candidate per thread -----------------------------------------
//
// Semantics of parallel/discovery.validate_stage2 (the numpy oracle) for the
// candidate dynamic-block header at absolute bit `c` of a stream whose
// payload ends at bit `n_bits` (words at or past `wend` read as 0): parse
// HLIT/HDIST/HCLEN and the 19 code-length (CL) code lengths, build the 7-bit
// canonical CL decode, then decode at most kValSteps sections (a length or a
// 16/17/18 repeat) while tracking the litlen and distance Kraft sums, the
// end-of-block symbol's length and the structural errors.  A header is good
// when the lengths end exactly at HLIT + HDIST with no error, the litlen
// code is complete with a nonzero end-of-block length, and the distance code
// is complete or has at most one code; `pos` is the bit after the last
// section decoded (the header's end when good).
//
// Everything stays in registers and a 128-byte table: the CL lengths packed
// 3 bits a symbol in one 64-bit word, the decode a lookup of the
// bit-reversed 7-bit peek (cl_table), the stream read through a 64-bit
// buffer with three words loaded ahead (HeaderBits).  The state after any
// number of sections (ValState) resumes from its bit alone, so the kernel
// decodes a first few sections of every candidate, then the survivors
// densely.

constexpr int kValSteps = 320;   // pallas_inflate._VAL_STEPS
constexpr uint8_t kClBad = 0xFF;  // a peek the CL code does not decode

// Stream bits from bit p in order: `buf` holds the next nbuf >= 32 bits
// (>= 18 after a skip of at most 14), a0..a2 the three words after them.
struct HeaderBits {
  const uint32_t* w;
  int64_t wend;
  int64_t next;
  uint64_t buf;
  int nbuf;
  uint32_t a0, a1, a2;

  FDT_HD uint32_t load(int64_t i) const {
    return (i >= 0 && i < wend) ? w[i] : 0u;
  }
  FDT_HD HeaderBits(const uint32_t* w_, int64_t wend_, int64_t p)
      : w(w_), wend(wend_) {
    const int64_t i = p >> 5;
    const int sh = static_cast<int>(p & 31);
    const uint64_t lo = load(i), hi = load(i + 1);
    a0 = load(i + 2);
    a1 = load(i + 3);
    a2 = load(i + 4);
    next = i + 5;
    buf = (lo >> sh) | (hi << (32 - sh));
    nbuf = 64 - sh;
  }
  FDT_HD uint32_t peek() const { return static_cast<uint32_t>(buf); }
  FDT_HD void skip(int n) {  // n <= 14; selects, no branch
    buf >>= n;
    nbuf -= n;
    const bool r = nbuf < 32;
    buf |= r ? static_cast<uint64_t>(a0) << nbuf : 0u;
    nbuf += r ? 32 : 0;
    a0 = r ? a1 : a0;
    a1 = r ? a2 : a1;
    a2 = r ? load(next) : a2;
    next += r;
  }
};

FDT_HD int cl_len(uint64_t clp, int s) { return static_cast<int>((clp >> (3 * s)) & 7); }

// Byte t[a .. a + n) = e, word stores where four bytes are aligned.
FDT_HD void fill_bytes(uint8_t* t, int a, int n, uint32_t e) {
  const int b = a + n;
  const uint32_t w = e * 0x01010101u;
  for (; a < b && (a & 3); ++a) t[a] = static_cast<uint8_t>(e);
  for (; a + 4 <= b; a += 4) {
#ifdef __CUDA_ARCH__
    *reinterpret_cast<uint32_t*>(t + a) = w;
#else
    memcpy(t + a, &w, 4);
#endif
  }
  for (; a < b; ++a) t[a] = static_cast<uint8_t>(e);
}

// The compare chain of the CL decode for the bit-reversed peek r (validate
// lengths clp): code length L = 1 + #{l < 7: r >= bound[l] < 128}, index
// kval[L] + (r >> (7 - L)) into the symbols in (length, symbol) order
// (unused ones last, `ord_lo`/`ord_hi` 5 bits a position), valid when the
// index is 0..18 and its symbol has length L.  Entry sym | L << 5, or
// kClBad.
FDT_HD uint8_t cl_chain_entry(uint64_t clp, uint64_t cntp, uint64_t ord_lo,
                              uint64_t ord_hi, int r) {
  int L = 1;
  int32_t code = 0;
#pragma unroll
  for (int l = 1; l < 7; ++l) {
    const int32_t c = static_cast<int32_t>((cntp >> (8 * l)) & 0xFF);
    const int32_t bound = (code + c) << (7 - l);
    L += (r >= bound) && (bound < 128);
    code = (code + c) << 1;
  }
  int32_t kv = 0, acc = 0;
  code = 0;
#pragma unroll
  for (int l = 1; l <= 7; ++l) {
    const int32_t c = static_cast<int32_t>((cntp >> (8 * l)) & 0xFF);
    if (l == L) kv = acc - code;
    acc += c;
    code = (code + c) << 1;
  }
  const int32_t idx = kv + (r >> (7 - L));
  if (idx < 0 || idx > 18) return kClBad;
  const int sym = static_cast<int>(
      (idx < 12 ? ord_lo >> (5 * idx) : ord_hi >> (5 * (idx - 12))) & 31);
  return cl_len(clp, sym) == L ? static_cast<uint8_t>(sym | (L << 5)) : kClBad;
}

// The CL decode of lengths `clp` as a table t[128] over the bit-reversed
// 7-bit peek: entry sym | L << 5, or kClBad where the compare chain of
// validate_stage2 finds no symbol.  For a code that does not oversubscribe
// (Kraft sum <= 1: every stage-1 survivor's is exactly 1) each symbol of
// length L fills its 2^(7-L) entries from its canonical code and the
// entries past the last code are kClBad, which is the chain's answer; an
// oversubscribed code takes the chain's answer entry by entry.
FDT_HD void cl_table(uint64_t clp, uint8_t* t) {
  uint64_t cntp = 0;  // symbols of each length, 8 bits a length
#pragma unroll
  for (int s = 0; s < 19; ++s) {
    const int l = cl_len(clp, s);
    cntp += l ? (1ull << (8 * l)) : 0ull;
  }
  int kraft = 0;
#pragma unroll
  for (int l = 1; l <= 7; ++l)
    kraft += static_cast<int>((cntp >> (8 * l)) & 0xFF) << (7 - l);
  if (kraft <= 128) {
    uint64_t nextp = 0;  // the next canonical code of each length
    int code = 0;
#pragma unroll
    for (int l = 1; l <= 7; ++l) {
      const int c = static_cast<int>((cntp >> (8 * l)) & 0xFF);
      nextp |= static_cast<uint64_t>(code) << (8 * l);
      code = (code + c) << 1;
    }
#pragma unroll
    for (int s = 0; s < 19; ++s) {
      const int l = cl_len(clp, s);
      if (!l) continue;
      const int cd = static_cast<int>((nextp >> (8 * l)) & 0xFF);
      nextp += 1ull << (8 * l);
      fill_bytes(t, cd << (7 - l), 1 << (7 - l),
                 static_cast<uint32_t>(s | (l << 5)));
    }
    fill_bytes(t, kraft, 128 - kraft, kClBad);
    return;
  }
  // Positions in (length, symbol) order, unused symbols last.
  uint64_t accp = 0, rankp = 0, ord_lo = 0, ord_hi = 0;
  int acc = 0;
#pragma unroll
  for (int l = 1; l <= 7; ++l) {
    accp |= static_cast<uint64_t>(acc) << (8 * l);
    acc += static_cast<int>((cntp >> (8 * l)) & 0xFF);
  }
  accp |= static_cast<uint64_t>(acc);  // slot 0: the unused symbols
#pragma unroll
  for (int s = 0; s < 19; ++s) {
    const int l = cl_len(clp, s);
    const int p = static_cast<int>(((accp + rankp) >> (8 * l)) & 0xFF);
    rankp += 1ull << (8 * l);
    if (p < 12) ord_lo |= static_cast<uint64_t>(s) << (5 * p);
    else ord_hi |= static_cast<uint64_t>(s) << (5 * (p - 12));
  }
  for (int r = 0; r < 128; ++r)
    t[r] = cl_chain_entry(clp, cntp, ord_lo, ord_hi, r);
}

struct ValState {
  int64_t pos;
  int32_t hlit, total, written, prev, kraft_l, kraft_d, nz_d, len256, step;
  bool bad;
};

// The candidate's header fields and CL lengths from bit c (the reader at
// c), its CL table into t[128]; the state before the first section.
FDT_HD ValState val_begin(HeaderBits& hb, int64_t c, uint8_t* t) {
  const int kClcl[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                         11, 4, 12, 3, 13, 2, 14, 1, 15};
  ValState s{};
  hb.skip(3);
  s.hlit = static_cast<int32_t>(hb.peek() & 31) + 257;
  hb.skip(5);
  const int32_t hdist = static_cast<int32_t>(hb.peek() & 31) + 1;
  hb.skip(5);
  const int ncl = static_cast<int>(hb.peek() & 15) + 4;
  hb.skip(4);
  uint64_t clp = 0;
#pragma unroll
  for (int j = 0; j < 19; ++j) {
    if (j < ncl) {
      clp |= static_cast<uint64_t>(hb.peek() & 7) << (3 * kClcl[j]);
      hb.skip(3);
    }
  }
  cl_table(clp, t);
  s.pos = c + 17 + 3 * ncl;
  s.total = s.hlit + hdist;
  return s;
}

FDT_HD bool val_live(const ValState& s) {
  return s.step < kValSteps && !s.bad && s.written < s.total;
}

// Sections while live, up to step `upto`, from the reader at s.pos.  The
// body has no branch, only selects: the threads of a warp decode different
// candidates and would part at every section, and the longest header's
// chain of sections sets the kernel's time.  An invalid code or a failed
// check consumes nothing and updates nothing but `bad`.
FDT_HD void val_sections(ValState& s, HeaderBits& hb, const uint8_t* t,
                         int64_t n_bits, int upto) {
  while (s.step < upto && !s.bad && s.written < s.total) {
    ++s.step;
    const uint32_t v = hb.peek();
    const uint32_t e = t[bitrev7(v & 0x7F)];
    const int L = static_cast<int>(e >> 5) & 7;
    const int sym = static_cast<int>(e & 31);
    const bool plain = sym <= 15;
    const int ebits = sym == 16 ? 2 : (sym == 17 ? 3 : 7);
    const int32_t rep =
        plain ? 1
              : (sym == 18 ? 11 : 3) +
                    static_cast<int32_t>((v >> L) & ((1u << ebits) - 1));
    const int32_t value = plain ? sym : (sym == 16 ? s.prev : 0);
    const bool ok = e != kClBad && !(sym == 16 && s.written == 0) &&
                    s.written + rep <= s.total;
    const int32_t lim = s.written + rep < s.hlit ? s.written + rep : s.hlit;
    const int32_t l_cnt = lim - s.written > 0 ? lim - s.written : 0;
    const int32_t k = ok && value > 0 ? 1 << (15 - value) : 0;
    s.kraft_l += k * l_cnt;
    s.kraft_d += k * (rep - l_cnt);
    s.nz_d += k ? rep - l_cnt : 0;
    s.len256 = ok && s.written <= 256 && 256 < s.written + rep && s.hlit > 256
                   ? value
                   : s.len256;
    s.prev = ok && plain ? sym : s.prev;
    s.written += ok ? rep : 0;
    const int n = ok ? L + (plain ? 0 : ebits) : 0;
    s.pos += n;
    hb.skip(n);
    s.bad = !ok || s.pos + 7 >= n_bits;
  }
}

FDT_HD int32_t val_good(const ValState& s) {
  return !s.bad && s.written == s.total && s.kraft_l == (1 << 15) &&
         s.len256 > 0 && (s.kraft_d == (1 << 15) || s.nz_d <= 1);
}

// K5 on one candidate, every section in one pass: returns good, *end_out
// the bit after the last section.  (The kernel splits the same passes
// around its compaction.)
FDT_HD int32_t validate_lane(const uint32_t* words, int64_t wend, int64_t c,
                             int64_t n_bits, uint8_t* t, int64_t* end_out) {
  HeaderBits hb(words, wend, c);
  ValState s = val_begin(hb, c, t);
  val_sections(s, hb, t, n_bits, kValSteps);
  *end_out = s.pos;
  return val_good(s);
}

}  // namespace fdt
