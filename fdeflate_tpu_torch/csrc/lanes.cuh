// Bit machines of the fixed-geometry codec.
//
// A lane is one S-byte chunk of one stream (lane = stream * C + chunk).
// K1 (assign_pack.cu), K2 (combine.cu) and K3 (decode2.cu) put a group of
// m threads on a lane: the pieces in their sections below are one thread's
// work (a segment of the lane), and assign_pack_group, combine_group and
// decode2_group put them
// together with the group's collectives, written once over a policy of
// warp operations (warp.cuh): shuffles on the card, loops over m thread
// slots on the host.  K6 (decode_sep.cu) runs decode2_group too, with the
// sep tree's table and its own EOB rule, and K8 (decode2_canon.cu) with a
// table built from its canonical rows; K9 (pack_v1.cu) puts a group on a
// lane's window (pack_v1_group).  The whole-lane functions further down
// are the serial paths of K6 and K8.  At the end, K7 (adler32_tiles.cu)
// puts a group on a 1024-byte tile (adler_tile_group) and K10
// (combine_grouped.cu) on a 1024-word output slab (combine_slab_group).  Everything here is plain C++ (device
// intrinsics only behind __CUDA_ARCH__, with a host equivalent), so the
// same source also compiles for the host, where
// tests/test_torch_lanes_host.py runs it.
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define FDT_HD __host__ __device__ __forceinline__
#define FDT_GROUP __device__
#else
#define FDT_HD inline
#define FDT_GROUP
#endif

namespace fdt {

FDT_HD int imin(int a, int b) { return a < b ? a : b; }
FDT_HD int imax(int a, int b) { return a > b ? a : b; }

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

FDT_HD int clz64(uint64_t x) {  // x != 0
#ifdef __CUDA_ARCH__
  return __clzll(static_cast<long long>(x));
#else
  return __builtin_clzll(x);
#endif
}

FDT_HD int ctz64(uint64_t x) {  // x != 0
#ifdef __CUDA_ARCH__
  return __ffsll(static_cast<long long>(x)) - 1;
#else
  return __builtin_ctzll(x);
#endif
}

FDT_HD int ctz32(uint32_t x) {  // x != 0
#ifdef __CUDA_ARCH__
  return __ffs(static_cast<int>(x)) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// OR into a word that another thread of the warp may also OR into.
FDT_HD void or_word(uint32_t* p, uint32_t v) {
#ifdef __CUDA_ARCH__
  atomicOr(p, v);
#else
  *p |= v;
#endif
}

// Tokens closing a zero run whose `tail` bytes follow its literal zero and
// its 258-byte blocks: <= 4 literal zeros, or the length symbol (RFC 1951
// closed form, tail in 5..257), its extra bits and the 1-bit distance code.
template <class Sink>
FDT_HD void put_tail(Sink& w, int tail, const int32_t* len_tok, int32_t zlit) {
  if (tail <= 4) {
    for (int i = 0; i < tail; ++i) w.put(zlit);
    return;
  }
  int x = tail - 3;
  int e = (x >= 8) + (x >= 16) + (x >= 32) + (x >= 64) + (x >= 128);
  w.put(len_tok[4 * e + (x >> e)]);           // symbol 257 + 4e + (x >> e)
  w.put((x & ((1 << e) - 1)) | ((e + 1) << kNbShift));
}

// ---- K1, a group of threads per lane --------------------------------------
//
// Semantics of ops/ultrafast_kernel._assign_tokens with split_S == S (and
// of ops/assign_pack.runs, its readable statement): 8-byte-group run
// membership (whole zero groups; zeros ending a group; zeros opening a
// group whose previous byte is zero), membership only below the lane's
// 8-aligned length `al`, literals below its length `ln`, runs cut at the
// lane end.  A run emits a literal zero, one 285-token per further 258
// bytes, and its tail before the byte that ends it (or at the lane end).
//
// A byte's membership depends only on its group and the byte before the
// group, so each thread classifies its own groups.  What crosses thread
// edges is the run length entering a segment (a scan of RunSeg) and the
// bit offset (a scan of the segments' bit counts).  The lane's bytes are
// staged kApTile at a time; the run length, the bit offset and the partial
// last word carry from tile to tile (assign_pack_group).

constexpr int kApTile = 2048;  // lane bytes staged per tile

// Window words a tile of T bytes can touch, its bits starting at bit rel
// of a word: at most 13 bits per byte, plus a run tail owed by the
// previous tile.
FDT_HD constexpr int ap_buf_words(int rel, int T) {
  return (rel + 13 * T + 64 + 31) / 32 + 1;
}
constexpr int kApBufWords = ap_buf_words(31, kApTile);

// A thread's groups [g0, g1) of a tile of G groups split over m threads.
FDT_HD void seg_groups(int G, int m, int i, int* g0, int* g1) {
  int gpt = (G + m - 1) / m;
  int a = i * gpt;
  *g0 = a < G ? a : G;
  *g1 = a + gpt < G ? a + gpt : G;
}

// Run summary of a segment: all its bytes members, and the member bytes
// that end it.  run_combine is the scan step: the run length entering the
// right segment's end, from the left one's.  (An empty segment is the
// identity {true, 0}; the carry from an earlier tile enters as
// {false, run}.)
struct RunSeg {
  bool all;
  int32_t trail;
};

FDT_HD RunSeg run_combine(RunSeg l, RunSeg r) {
  return r.all ? RunSeg{l.all, l.trail + r.trail} : r;
}

// Member mask (bit i = byte i) of the group `x`; `prev_run`: the byte
// before the group is zero; only the first `below` bytes may be members.
FDT_HD uint32_t group_members(uint64_t x, bool prev_run, int below) {
  uint32_t m = 0xFFu;
  if (x != 0) {
    int t = ctz64(x) >> 3;  // first nonzero byte
    int l = clz64(x) >> 3;  // zero bytes at the group end
    m = (prev_run ? (1u << t) - 1 : 0u) | ((0xFFu << (8 - l)) & 0xFFu);
  }
  below = below < 0 ? 0 : below > 8 ? 8 : below;
  return m & ((1u << below) - 1);
}

// Whether the run rule's carry enters group g0 of the staged tile: the
// byte before it is zero (`prev0`: the byte before the tile).
FDT_HD bool seg_prev_run(const uint8_t* tile, int g0, bool prev0) {
  return g0 == 0 ? prev0 : tile[8 * g0 - 1] == 0;
}

// K1 classification: the RunSeg of groups [g0, g1) of the staged tile;
// `below`: al minus the tile's lane offset; `prev0`: the byte before the
// tile is zero.
FDT_HD RunSeg classify_segment(const uint8_t* tile, int g0, int g1, int below,
                               bool prev0) {
  RunSeg r{true, 0};
  bool prev = seg_prev_run(tile, g0, prev0);
  for (int g = g0; g < g1; ++g) {
    uint64_t x = load8(tile + 8 * g);
    uint32_t m = group_members(x, prev, below - 8 * g);
    uint32_t inv = ~m & 0xFFu;
    RunSeg s{true, 8};
    if (inv) s = RunSeg{false, clz64(inv) - 56};  // bytes above the last non-member
    r = run_combine(r, s);
    prev = (x >> 56) == 0;
  }
  return r;
}

// K1 segment emit: the tokens of groups [g0, g1) in byte order into `w`
// (BitCount or WordWriter), the run entering the segment `entering` bytes
// long.  A run reaching the segment end owes its tail to the segment that
// ends it (or to the lane end, run_end_tail).
template <class Sink>
FDT_HD void emit_segment(const uint8_t* tile, int g0, int g1, int below,
                         int lit_below, bool prev0, int32_t entering,
                         const int32_t* lit_tok, const int32_t* len_tok,
                         Sink& w) {
  const int32_t zlit = lit_tok[0];
  const int32_t t285 = len_tok[28] + (1 << kNbShift);  // + distance bit
  bool in_run = entering > 0;
  int cnt = in_run ? (entering - 1) % 258 : 0;  // run bytes after the first
  bool prev = seg_prev_run(tile, g0, prev0);
  for (int g = g0; g < g1; ++g) {
    uint64_t x = load8(tile + 8 * g);
    uint32_t m = group_members(x, prev, below - 8 * g);
    prev = (x >> 56) == 0;
    for (int i = 0; i < 8; ++i) {
      if ((m >> i) & 1) {
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
        if (8 * g + i < lit_below) w.put(lit_tok[(x >> (8 * i)) & 0xFF]);
      }
    }
  }
}

// The tail of a run `run` bytes long that reaches the lane end.
template <class Sink>
FDT_HD void run_end_tail(Sink& w, int32_t run, const int32_t* lit_tok,
                         const int32_t* len_tok) {
  if (run > 0) put_tail(w, (run - 1) % 258, len_tok, lit_tok[0]);
}

// Pass 1 sink: counts bits.
struct BitCount {
  int32_t total = 0;
  FDT_HD void put(int32_t tok) { total += tok >> kNbShift; }
};

// Pass 2 sink: LSB-first bits into a zeroed word buffer from bit `bit`.
// The segment's first and last words may be shared with its neighbours
// (or_word); the words between are its own (plain stores).
struct WordWriter {
  uint32_t* buf;
  uint64_t acc = 0;
  int nacc;
  int wi;
  bool first = true;

  FDT_HD WordWriter(uint32_t* b, int32_t bit)
      : buf(b), nacc(bit & 31), wi(bit >> 5) {}

  FDT_HD void put(int32_t tok) {  // nbits <= 13, so acc never holds > 44
    acc |= static_cast<uint64_t>(tok & ((1 << kNbShift) - 1)) << nacc;
    nacc += tok >> kNbShift;
    if (nacc >= 32) {
      if (first) {
        or_word(buf + wi, static_cast<uint32_t>(acc));
        first = false;
      } else {
        buf[wi] = static_cast<uint32_t>(acc);
      }
      ++wi;
      acc >>= 32;
      nacc -= 32;
    }
  }

  FDT_HD void finish() {
    if (nacc > 0) or_word(buf + wi, static_cast<uint32_t>(acc));
  }
};

// K1 lane `lane` (stream lane / C, chunk lane % C) of data u8[B, N] with
// lengths i32[B] -> win[lane, :wwin] and chunk_bits[lane], by the group g
// (warp.cuh) of m threads.  Per tile of kApTile bytes: stage the bytes in
// `tile` and zero the window words in `buf` (kApBufWords; the partial word
// carried in), classify each thread's groups and scan the run state, count
// each thread's bits and scan the bit offsets, emit into `buf` (segment
// edge words OR'd), close a run at the lane end, store the full words and
// carry the partial one.  Then zero the window past the payload.
template <class G>
FDT_GROUP void assign_pack_group(const G& g, const uint8_t* data,
                                 const int32_t* lengths, int N, int C,
                                 int64_t lane, const int32_t* lit_tok,
                                 const int32_t* len_tok, uint8_t* tile,
                                 uint32_t* buf, uint32_t* win, int wwin,
                                 int32_t* chunk_bits) {
  const int m = g.m;
  const int b = static_cast<int>(lane / C), k = static_cast<int>(lane % C);
  const int S = N / C, base = k * S, len = lengths[b];
  const uint8_t* src = data + static_cast<int64_t>(b) * N + base;
  const int al = imin(imax(len / 8 * 8 - base, 0), S);
  const int ln = imin(imax(len - base, 0), S);
  uint32_t* dst = win + lane * wwin;
  const bool v16 = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  // The group rule's carry entering the lane: the previous lane's last
  // byte is zero (pallas_assign.blocked_input).
  bool prev = k > 0 && src[-1] == 0;
  int32_t carry_run = 0, bitpos = 0;
  uint32_t carry_word = 0;
  typename G::template Var<int> g0, g1;
  typename G::template Var<RunSeg> seg;
  typename G::template Var<int32_t> ent, off;
  auto comb = [](RunSeg l, RunSeg r) { return run_combine(l, r); };
  auto plus = [](int32_t l, int32_t r) { return l + r; };
  for (int toff = 0; toff < S; toff += kApTile) {
    const int T = imin(kApTile, S - toff), NG = T >> 3;
    const uint8_t* s = src + toff;
    const int rel = bitpos & 31, nwb = ap_buf_words(rel, T);
    const int below = al - toff, lit_below = ln - toff;
    g.each([&](int i) {
      if (v16) {
        for (int j = i; j < (T >> 4); j += m)
          g.copy(tile + 16 * j, s + 16 * j, 16);
        if ((T & 15) && i == 0) g.copy(tile + T - 8, s + T - 8, 8);
      } else {
        for (int j = i; j < NG; j += m) g.copy(tile + 8 * j, s + 8 * j, 8);
      }
      for (int j = i; j < nwb; j += m) buf[j] = j == 0 ? carry_word : 0u;
      seg_groups(NG, m, i, &g0[i], &g1[i]);
    });
    g.wait();

    g.each([&](int i) {
      seg[i] = classify_segment(tile, g0[i], g1[i], below, prev);
    });
    const RunSeg in_tile = g.excl_scan(seg, RunSeg{true, 0}, comb);
    const RunSeg carry{false, carry_run};
    g.each([&](int i) { ent[i] = run_combine(carry, seg[i]).trail; });
    carry_run = run_combine(carry, in_tile).trail;

    g.each([&](int i) {
      BitCount c;
      emit_segment(tile, g0[i], g1[i], below, lit_below, prev, ent[i],
                   lit_tok, len_tok, c);
      off[i] = c.total;
    });
    int32_t tile_bits = g.excl_scan(off, 0, plus);
    g.each([&](int i) {
      WordWriter w(buf, rel + off[i]);
      emit_segment(tile, g0[i], g1[i], below, lit_below, prev, ent[i],
                   lit_tok, len_tok, w);
      w.finish();
    });
    const bool last = toff + T >= S;
    if (last) {  // a run reaching the lane end closes here
      BitCount tc;
      run_end_tail(tc, carry_run, lit_tok, len_tok);
      g.sync();
      if (tc.total) {
        g.each([&](int i) {
          if (i) return;
          WordWriter tw(buf, rel + tile_bits);
          run_end_tail(tw, carry_run, lit_tok, len_tok);
          tw.finish();
        });
      }
      tile_bits += tc.total;
    }
    g.sync();

    const int32_t newbit = bitpos + tile_bits;
    const int nfull = (newbit >> 5) - (bitpos >> 5);
    const int nout = last ? ((newbit + 31) >> 5) - (bitpos >> 5) : nfull;
    uint32_t* d = dst + (bitpos >> 5);
    g.each([&](int i) {
      for (int j = i; j < nout; j += m) d[j] = buf[j];
    });
    carry_word = buf[nfull];
    prev = tile[T - 1] == 0;
    bitpos = newbit;
    g.sync();
  }
  g.each([&](int i) {
    for (int j = ((bitpos + 31) >> 5) + i; j < wwin; j += m) dst[j] = 0;
    if (i == 0) chunk_bits[lane] = bitpos;
  });
}

// ---- K6's tree and word steps ----------------------------------------------

FDT_HD int bitrev12(uint32_t x) {
#ifdef __CUDA_ARCH__
  return static_cast<int>(__brev(x) >> 20);
#else
  int r = 0;
  for (int i = 0; i < kMaxL; ++i) r |= ((x >> i) & 1) << (kMaxL - 1 - i);
  return r;
#endif
}

// The decode entry (K3's format: val | extra << 9 | cls << 13 | L << 16,
// trees.decode_table) of the 12-bit LSB-first peek x under a
// class-separated tree's rows (trees.sep_tables: bounds at meta[0..12],
// kvals at meta[16..28], the literal count at meta[15]; `vals` the
// literal bytes by sorted index, four to a word).  Code length L = 1 +
// #{l < 12: r12 >= bounds[l]} of the bit-reversed peek r12, sorted index
// kvals[L] + (r12 >> (12 - L)); L < 12 is a literal; L == 12 is EOB at
// index n_lit and otherwise length symbol 257 + (index - n_lit - 1), its
// base and extra bits in RFC 1951's closed form.
FDT_HD int32_t sep_entry(const int32_t* meta, const int32_t* vals,
                         uint32_t x) {
  const int r12 = bitrev12(x);
  int L = 1;
  for (int l = 1; l < kMaxL; ++l) L += r12 >= meta[l];
  const int idx = meta[16 + L] + (r12 >> (kMaxL - L));
  if (L < kMaxL) {
    const uint32_t v = static_cast<uint32_t>(vals[imin(imax(idx >> 2, 0), 63)]);
    return static_cast<int32_t>((v >> (8 * (idx & 3))) & 0xFFu) | (L << 16);
  }
  const int n_lit = meta[15];
  if (idx <= n_lit) return (1 << 13) | (kMaxL << 16);
  const int sp = idx - n_lit - 1;
  const int e = (sp < 4 || sp == 28) ? 0 : (sp >> 2) - 1;
  const int base = sp == 28 ? 258 : sp < 4 ? sp + 3 : ((4 + (sp & 3)) << e) + 3;
  return base | (e << 9) | (2 << 13) | (kMaxL << 16);
}

// Entries of sep_entry's format looked up in a 4096-entry table (the
// kernel's, in shared memory), or computed from the tree's rows.
struct SepTable {
  const int32_t* t;
  FDT_HD int32_t operator()(uint32_t x) const { return t[x]; }
};
struct SepRows {
  const int32_t* meta;
  const int32_t* vals;
  FDT_HD int32_t operator()(uint32_t x) const {
    return sep_entry(meta, vals, x);
  }
};

// K6's word steps (pallas_decode2._kernel_sep) over one lane of S bytes
// from absolute bit `start` of the stream row `row` (W words; words at or
// past W read as 0), `look(peek12)` giving each peek's entry (SepRows or
// SepTable).  The lane makes S / 4 word steps of up to
// 4 sub-steps.  A sub-step first takes pending run bytes into the word; if
// the word still has room and no run is pending it decodes one symbol: a
// literal fills a byte; EOB consumes its 12 bits, writes nothing, and
// decoding goes on (so the word may end short, zero-padded); a length
// symbol's zero run (base and extra bits, 1 distance bit consumed
// unchecked) is written as zero bytes.  The run left over when the word is
// full carries to the next step and is dropped at the lane end.  Words go
// to dst[0 .. S/4).  Returns the exit bit relative to `start`.
template <class Look>
FDT_HD int32_t sep_serial(const uint32_t* row, int64_t W, int64_t start,
                          const Look& look, uint32_t* dst, int S) {
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
      const uint32_t bits = static_cast<uint32_t>(buf);
      const int32_t e = look(bits & ((1u << kMaxL) - 1));
      int n = (e >> 16) & 0x1F;
      const int cls = (e >> 13) & 3;
      if (cls == 0) {
        word |= static_cast<uint32_t>(e & 0xFF) << (8 * filled);
        ++filled;
      } else if (cls == 2) {
        const int extra = (e >> 9) & 0xF;
        run = (e & 0x1FF) + static_cast<int>((bits >> n) & ((1u << extra) - 1));
        n += extra + 1;
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

// ---- K3, a group of threads per lane --------------------------------------
//
// Semantics of pallas_decode2._kernel_light: literals; zero runs of length
// base + extra bits with the 1 distance bit consumed unchecked; a run that
// overruns the lane is cut at S with all its bits counted; on EOB (or any
// entry that is neither a literal nor a run) the lane stalls and writes
// zeros to its end; words at or past W (or before 0) read as 0.  The lane
// is decoded a tile of output bytes at a time (a run crossing a tile edge
// carries its zeros on), each tile by spans: a span stages the words it
// can read and splits a hint of its bit length into m sub-ranges, one per
// thread.  Thread i decodes from its sub-range's first bit to its first
// symbol boundary at or past the next one (decode_segment); while a
// thread's start differs from the previous thread's exit it decodes again
// from that exit (sync rounds); at the fixed point every segment is the
// serial decode's, and a second decode of each segment writes its literal
// bytes at its scanned byte offset.  A span that falls short of the tile
// (a hint too short) is followed by another from where it ended
// (decode2_group).
//
// Every code is <= 12 bits and a run symbol <= 18 bits for >= 3 bytes
// (the entries of trees.decode_table), so a lane that has written n bytes
// has consumed <= 12 n bits: a symbol starting past rel0 + 12 (want - 1)
// is never reached before the span's `want` bytes are written.  That
// bounds the words a span stages and the bits a thread may read.

constexpr int kDecTile = 2048;  // output bytes staged per warp

// Words a span staged from bit rel0 of its first word reads (its bits
// start in a word at rel0; peek32 reads two words).
FDT_HD constexpr int dec_words(int32_t rel0, int32_t want) {
  return ((rel0 + 12 * (want - 1)) >> 5) + 2;
}

// K3's geometry, chosen from S alone: m threads decode a lane, about 64
// output bytes each (~40 symbols; fewer and the sync rounds outgrow the
// work), m a power of two up to 32, so a warp holds 32 / m lanes.  Each
// lane stages dec_tile(m) output bytes (S <= dec_tile(m) when m < 32) and
// the words a span of them can read.
FDT_HD constexpr int dec_threads(int S) {
  int m = 1;
  while (m < 32 && 64 * m < S) m <<= 1;
  return m;
}
FDT_HD constexpr int dec_tile(int m) { return kDecTile / (32 / m); }
FDT_HD constexpr int dec_lane_bytes(int m) {
  return (dec_tile(m) + 4 * dec_words(31, dec_tile(m)) + 15) / 16 * 16;
}
FDT_HD constexpr int dec_warp_bytes() {  // the most over every m
  int most = 0;
  for (int m = 1; m <= 32; m <<= 1) {
    int x = (32 / m) * dec_lane_bytes(m);
    most = x > most ? x : most;
  }
  return most;
}

FDT_HD uint32_t peek32(const uint32_t* sw, int32_t p) {
  int i = p >> 5, sh = p & 31;
  uint32_t lo = sw[i] >> sh;
  return sh ? lo | (sw[i + 1] << (32 - sh)) : lo;
}

// How a segment decode ended.
enum : int {
  kSegStop = 0,   // at a symbol boundary at or past `stop`
  kSegFill = 1,   // the span's bytes are all written (o0 + n >= want)
  kSegStall = 2,  // EOB or another non-literal, non-run entry
  kSegOff = 3,    // a symbol start past pmax (never reached in order)
};

struct SegDec {
  int32_t exit;  // bit after the last symbol (at the stall: its start)
  int32_t n;     // bytes decoded, runs uncut
  int end;
};

// K3 segment decode: symbols from bit p of the staged words until a
// boundary at or past `stop` (at least one symbol), a stall, a start past
// pmax, or o0 + n >= want.  With `out`, literal bytes land at out[o0 + n]
// (runs are zeros, already there).
FDT_HD SegDec decode_segment(const uint32_t* sw, int32_t p, int32_t stop,
                             int32_t pmax, int32_t o0, int32_t want,
                             const int32_t* dtab, uint8_t* out) {
  int32_t n = 0;
  int end = kSegStop;
  do {
    if (p > pmax) {
      end = kSegOff;
      break;
    }
    uint32_t bits = peek32(sw, p);
    int32_t e = dtab[bits & ((1u << kMaxL) - 1)];
    int L = (e >> 16) & 0x1F;
    int cls = (e >> 13) & 3;
    int val = e & 0x1FF;
    if (cls == 0) {
      if (out) out[o0 + n] = static_cast<uint8_t>(val);
      n += 1;
    } else if (cls == 2) {
      int extra = (e >> 9) & 0xF;
      n += val + static_cast<int>((bits >> L) & ((1u << extra) - 1));
      L += extra + 1;
    } else {
      end = kSegStall;
      break;
    }
    p += L;
    if (o0 + n >= want) {
      end = kSegFill;
      break;
    }
  } while (p < stop);
  return {p, n, end};
}

// K3 sync round, thread i's part: whether its segment no longer counts
// (an earlier segment ended the span, or the bytes before it fill it:
// `pre` bytes before it, `room` left in the span), and whether it must
// decode again from the previous segment's exit (it started elsewhere).
FDT_HD bool seg_dead(int i, bool ended_before, int32_t pre, int32_t room) {
  return i > 0 && (ended_before || pre >= room);
}

FDT_HD bool seg_redo(int i, bool dead, int32_t start, int32_t prev_exit) {
  return i > 0 && !dead && start != prev_exit;
}

// Thread i's sub-range start of a span of H bits from rel0.
FDT_HD int32_t sub_start(int32_t rel0, int32_t H, int i, int m) {
  return rel0 + static_cast<int32_t>(static_cast<int64_t>(H) * i / m);
}

// The span hint: a lane's first span takes the distance to the next
// lane's start (`next_span` > 0, scaled to the tile when the lane has
// several) or, for a stream's last lane, the bits up to the staged words'
// last nonzero one (`lastnz`, -1 if none); later spans the lane's bits
// per byte so far times the bytes still wanted.  Only where threads start
// depends on it, never the result.
FDT_HD int64_t lane_hint(int64_t next_span, int S, int T, int lastnz, int nw,
                         int32_t rel0) {
  if (next_span > 0) return S > T ? next_span * T / S : next_span;
  return static_cast<int64_t>(lastnz >= 0 ? lastnz + 1 : nw) * 32 - rel0;
}

FDT_HD int64_t rate_hint(int64_t bits_done, int64_t bytes_done, int32_t want) {
  return bytes_done > 0 ? (bits_done * want + bytes_done - 1) / bytes_done
                        : 12LL * want;
}

FDT_HD int32_t clamp_hint(int64_t H, int32_t rel0, int32_t pmax) {
  int64_t hi = static_cast<int64_t>(pmax) - rel0 + 1;
  return static_cast<int32_t>(H < 1 ? 1 : H > hi ? hi : H);
}

// K3 lane `lane` (stream lane / C, chunk lane % C; W words per stream)
// -> out[b, k*S : (k+1)*S] and bpos[lane], by the group g (warp.cuh) of m
// threads, with `tile` (tcap output bytes) and `sw` (dec_words(31, tcap)
// words) in shared memory; a null `chunk_starts` starts every lane at bit
// 0 (K8's windows, C = 1).  Per tile: zero it; per span: stage its words,
// split the hint, decode every segment, sync rounds until each thread
// starts at its predecessor's exit, the write pass at the scanned byte
// offsets, and the span's end (filled, stalled, or short: another span);
// store the tile.
//
// kSep: K6's lane instead (decode_sep_lane's semantics, `dtab` the sep
// tree's table, sep_entry).  Where no EOB is met the two agree: four
// sub-steps always fill a word, so K6's words are K3's bytes in order,
// and a run left over at the lane end is cut either way with its bits
// counted.  An EOB ends a segment as K3's stall does (a dead segment's
// EOB changes nothing); when the segment that ends a span stalls (an EOB
// on the serial decode's path), thread 0 decodes the whole lane again
// with K6's word steps (sep_serial) straight into `out`, over the tiles
// stored so far, and the group's serial_lane() counts it.
template <class G, bool kSep = false>
FDT_GROUP void decode2_group(const G& g, const uint32_t* words, int64_t W,
                             const int32_t* chunk_starts, int N, int C,
                             int64_t lane, const int32_t* dtab, int tcap,
                             uint8_t* tile, uint32_t* sw, uint8_t* out,
                             int32_t* bpos) {
  const int m = g.m;
  const int b = static_cast<int>(lane / C), k = static_cast<int>(lane % C);
  const int S = N / C;
  const uint32_t* row = words + static_cast<int64_t>(b) * W;
  const int64_t start = chunk_starts ? chunk_starts[lane] : 0;
  const int64_t next_span =
      chunk_starts && k + 1 < C ? chunk_starts[lane + 1] - start : -1;
  uint8_t* dst = out + static_cast<int64_t>(b) * N + static_cast<int64_t>(k) * S;
  typename G::template Var<int32_t> st, stop, pre, px;
  typename G::template Var<int> nz;
  typename G::template Var<SegDec> s, wr;
  typename G::template Var<bool> flag, dead, redo;
  auto plus = [](int32_t l, int32_t r) { return l + r; };
  int64_t P = start;
  int32_t pend = 0;  // zeros a run owes the next tile
  bool stalled = false, spanned = false;
  for (int toff = 0; toff < S; toff += tcap) {
    const int T = imin(tcap, S - toff);
    g.each([&](int i) {
      for (int j = i; j < (T + 15) >> 4; j += m) g.zero16(tile + 16 * j);
    });
    g.sync();
    int32_t o = imin(pend, T);
    pend -= o;
    while (o < T && !stalled) {
      const int32_t rel0 = static_cast<int32_t>(P & 31);
      const int64_t w0 = P >> 5;
      const int nw = dec_words(rel0, T - o);
      g.each([&](int i) {
        for (int j = i; j < nw; j += m) {
          const int64_t gi = w0 + j;
          if (gi >= 0 && gi < W) g.copy(sw + j, row + gi, 4);
          else sw[j] = 0u;
        }
      });
      g.wait();
      const int32_t pmax = rel0 + 12 * (T - o - 1);
      int64_t H;
      if (!spanned) {
        g.each([&](int i) {
          nz[i] = -1;
          for (int j = i; j < nw; j += m) nz[i] = sw[j] ? j : nz[i];
        });
        H = lane_hint(next_span, S, T, g.max(nz), nw, rel0);
        spanned = true;
      } else {
        H = rate_hint(P - start, toff + o, T - o);
      }
      const int32_t Hc = clamp_hint(g.hint(H), rel0, pmax);
      g.each([&](int i) {
        st[i] = sub_start(rel0, Hc, i, m);
        stop[i] = sub_start(rel0, Hc, i + 1, m);
        s[i] = decode_segment(sw, st[i], stop[i], pmax, o, T, dtab, nullptr);
      });
      int rounds = 0;
      while (true) {  // sync rounds
        g.each([&](int i) {
          px[i] = s[i].exit;
          pre[i] = s[i].n;
          flag[i] = s[i].end != kSegStop;
        });
        g.up(px, 0);
        g.excl_scan(pre, 0, plus);
        const uint32_t ended = g.ballot(flag);
        g.each([&](int i) {
          dead[i] = seg_dead(i, (ended & ((1u << i) - 1)) != 0, pre[i], T - o);
          redo[i] = seg_redo(i, dead[i], st[i], px[i]);
        });
        if (!g.any(redo)) break;
        ++rounds;
        g.each([&](int i) {
          if (!redo[i]) return;
          st[i] = px[i];
          s[i] = decode_segment(sw, st[i], stop[i], pmax, o, T, dtab, nullptr);
        });
      }
      g.each([&](int i) {
        wr[i] = SegDec{st[i], 0, kSegStop};
        if (!dead[i])
          wr[i] = decode_segment(sw, st[i], stop[i], pmax, o + pre[i], T, dtab,
                                 tile);
        flag[i] = !dead[i] && wr[i].end == kSegFill;
      });
      const uint32_t fill = g.ballot(flag);
      g.each([&](int i) {
        flag[i] = !dead[i] && (wr[i].end == kSegStall || wr[i].end == kSegOff);
      });
      const uint32_t halt = g.ballot(flag);
      const int64_t base = w0 << 5;
      if (fill) {  // the lane's tile is full; a cut run owes the rest
        const int j = ctz32(fill);
        const SegDec f = g.bcast(wr, j);
        P = base + f.exit;
        pend = o + g.bcast(pre, j) + f.n - T;
        o = T;
      } else if (halt) {  // zeros to the lane end
        P = base + g.bcast(wr, ctz32(halt)).exit;
        stalled = true;
      } else {  // every segment reached its stop: the hint was short
        const SegDec l = g.bcast(wr, m - 1);
        P = base + l.exit;
        o += g.bcast(pre, m - 1) + l.n;
      }
      g.span_done(rounds, !fill && !halt);
      g.sync();
    }
    if (kSep && stalled) break;
    uint8_t* d = dst + toff;
    const int n =
        (reinterpret_cast<uintptr_t>(d) & 15) == 0 && (T & 15) == 0 ? 16 : 4;
    g.each([&](int i) {
      for (int j = i; j < T / n; j += m) g.store(d + n * j, tile + n * j, n);
    });
    g.sync();
  }
  if (kSep && stalled) {
    g.each([&](int i) {
      if (i == 0)
        bpos[lane] = sep_serial(row, W, start, SepTable{dtab},
                                reinterpret_cast<uint32_t*>(dst), S);
    });
    g.serial_lane();
    g.sync();
    return;
  }
  g.each([&](int i) {
    if (i == 0) bpos[lane] = static_cast<int32_t>(P - start);
  });
}

// ---- K2, a group of threads per lane --------------------------------------
//
// Semantics of ops/repack.combine_plain for lanes in order along each
// stream (pos0 nondecreasing, payloads disjoint, window bits past
// chunk_bits zero, as lane_starts and K1 give them): output word w of a
// stream is the OR of every lane's first ceil(chunk_bits / 32) window
// words shifted to bit pos0, zero where no payload lies.  Each word is
// written once, by the lane that owns it, with no atomics and no zero
// fill beforehand: lane k of a stream owns words [ceil(pos0[k] / 32),
// ceil(pos0[k+1] / 32)) (the stream's first lane from word 0, its last to
// word W), i.e. the words whose first bit lies in its span.  An owned word
// takes the lane's window words j-1 and j by a funnel shift; the last one,
// when the next lane starts inside it, also ORs in the first window word
// of every following lane that starts there (lanes shorter than a word
// put three or more lanes into one word).

FDT_HD uint32_t funnel_l(uint32_t lo, uint32_t hi, int sh) {  // sh in 0..31
#ifdef __CUDA_ARCH__
  return __funnelshift_l(lo, hi, sh);
#else
  return sh ? (hi << sh) | (lo >> (32 - sh)) : hi;
#endif
}

// Stream b's trailing words, [combine_tail, W), hold no payload and are
// written as zeros by their own groups (combine_zero_group), kCombineZero
// words each: a stream's payload may fill only part of its W words, and
// the last lane alone would write the rest one warp step at a time.
constexpr int kCombineZero = 4096;

FDT_HD int64_t combine_tail(const int32_t* chunk_bits, const int32_t* pos0,
                            int64_t b, int C, int W) {
  const int64_t last = (b + 1) * C - 1;
  const int64_t t = (pos0[last] >> 5) + ((chunk_bits[last] + 31) >> 5) + 1;
  return t < W ? t : W;
}

// 16-byte stores of four words at flat word f (a multiple of 4) where all
// four lie in [lo, hi) of the row at flat word rowf, 4-byte stores of the
// others there.
template <class G>
FDT_GROUP void combine_store(const G& g, uint32_t* words, int64_t f,
                          int64_t rowf, int64_t lo, int64_t hi,
                          const uint32_t* v) {
  const int64_t w = f - rowf;
  if (w >= lo && w + 4 <= hi) {
    g.store(words + f, v, 16);
  } else {
    for (int q = 0; q < 4; ++q)
      if (w + q >= lo && w + q < hi) g.store(words + f + q, v + q, 4);
  }
}

// K2's zero fill: piece c of stream b's trailing words, the words of
// [c * kCombineZero, (c + 1) * kCombineZero) at or past combine_tail.
template <class G>
FDT_GROUP void combine_zero_group(const G& g, const int32_t* chunk_bits,
                                  const int32_t* pos0, uint32_t* words, int C,
                                  int W, int64_t b, int64_t c) {
  const int m = g.m;
  const int64_t t = combine_tail(chunk_bits, pos0, b, C, W);
  const int64_t lo = t > c * kCombineZero ? t : c * kCombineZero;
  const int64_t hi = (c + 1) * kCombineZero < W ? (c + 1) * kCombineZero : W;
  const int64_t rowf = b * W;
  alignas(16) const uint32_t zero[4] = {0u, 0u, 0u, 0u};
  g.each([&](int i) {
    for (int64_t f = ((rowf + lo) & ~int64_t{3}) + 4 * i; f < rowf + hi;
         f += 4 * m)
      combine_store(g, words, f, rowf, lo, hi, zero);
  });
}

// K2 lane `lane` (stream lane / C): its owned words of words[b, 0:W] (for
// the stream's last lane, up to combine_tail), four to a thread's step,
// 16-byte stores where four owned words are aligned.
template <class G>
FDT_GROUP void combine_group(const G& g, const uint32_t* win,
                             const int32_t* chunk_bits, const int32_t* pos0,
                             uint32_t* words, int C, int wwin, int W,
                             int64_t lane) {
  const int m = g.m;
  const int64_t b = lane / C;
  const int k = static_cast<int>(lane % C);
  const int32_t s = pos0[lane];
  const int nw = (chunk_bits[lane] + 31) >> 5;
  const int64_t w0 = s >> 5;
  const int sh = s & 31;
  const uint32_t* row = win + lane * wwin;
  int64_t lo = k == 0 ? 0 : (static_cast<int64_t>(s) + 31) >> 5;
  int64_t hi = combine_tail(chunk_bits, pos0, b, C, W);
  int64_t tw = -1;  // the owned word the next lane starts inside, if any
  if (k + 1 < C) {
    const int64_t s1 = pos0[lane + 1];
    hi = (s1 + 31) >> 5;
    if (s1 & 31) tw = s1 >> 5;
  }
  lo = lo < W ? lo : W;
  hi = hi < W ? hi : W;
  const int64_t rowf = b * W;
  auto at = [&](int64_t j) -> uint32_t {
    return j >= 0 && j < nw ? row[j] : 0u;
  };
  g.each([&](int i) {
    for (int64_t f = ((rowf + lo) & ~int64_t{3}) + 4 * i; f < rowf + hi;
         f += 4 * m) {
      const int64_t w = f - rowf;
      uint32_t x[5];
      for (int q = 0; q < 5; ++q) x[q] = at(w - w0 - 1 + q);
      alignas(16) uint32_t v[4];
      for (int q = 0; q < 4; ++q) {
        v[q] = funnel_l(x[q], x[q + 1], sh);
        if (w + q == tw && tw >= lo && tw < hi) {
          for (int64_t n = lane + 1; n < (b + 1) * C && (pos0[n] >> 5) == tw;
               ++n)
            if (chunk_bits[n] > 0) v[q] |= win[n * wwin] << (pos0[n] & 31);
        }
      }
      combine_store(g, words, f, rowf, lo, hi, v);
    }
  });
}

// ---- K6's and K8's serial paths: one lane per thread -----------------------

// K6: decode one lane of S bytes of a class-separated tree (ops/septree)
// starting at absolute bit `start` of the stream row `row` (W words; words
// at or past W read as 0), serially: sep_serial with the tree's entries
// computed from its (meta, vals) rows.  The kernel runs the lane through
// decode2_group<kSep>, which comes back here only for a lane whose decode
// meets an EOB.
FDT_HD int32_t decode_sep_lane(const uint32_t* row, int64_t W, int64_t start,
                               const int32_t* meta, const int32_t* vals,
                               uint32_t* dst, int S) {
  return sep_serial(row, W, start, SepRows{meta, vals}, dst, S);
}

// K8: decode one lane's window, T output words from bit 0 of `win` (wwin
// words; words at or past wwin read as 0), serially.  The kernel runs the
// lane through decode2_group with canon_table's table, and comes here for
// every lane of a table canon_table flags.
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

// K8's table: the entry in K3's format (val | extra << 9 | cls << 13 |
// L << 16) of the 12-bit LSB-first peek x under the canonical rows
// (bounds[0..12], kvals[0..12]) and the 512-entry symbol table `packed`
// (val | extra << 9 | cls << 13; an index outside it reads 0, a zero
// literal): decode_canon_lane's compare chain and lookup, once per peek.
// K8's class e >> 13 is 0 for a literal, 2 for a run and anything else a
// stall (K3's class 1).  Equals trees.decode_table for a canonical tree.
FDT_HD int32_t canon_entry(const int32_t* bounds, const int32_t* kvals,
                           const int32_t* packed, uint32_t x) {
  const int r12 = bitrev12(x);
  int L = 1;
  for (int l = 1; l < kMaxL; ++l) L += r12 >= bounds[l];
  const int idx = kvals[L] + (r12 >> (kMaxL - L));
  const int32_t e = (idx >= 0 && idx < 512) ? packed[idx] : 0;
  const int32_t cls = e >> 13;
  return (cls == 0 || cls == 2 ? e : 1 << 13) | (L << 16);
}

// Whether K3's group decode with entry e (K3's format) may differ from
// K8's word steps: a literal above 255 (K8 ORs it into the word, its high
// bit spilling into the next byte; K3 stores its low byte) or a run of
// base below 3 (K8's word may end short at a run of 0 bytes, and the
// staging bound, at most 12 bits read per byte written, needs >= 3 bytes
// for a run symbol's <= 28 bits).  A table with neither decodes the same
// both ways: four sub-steps always fill a word, a stall stalls both.
FDT_HD bool canon_unsafe(int32_t e) {
  const int cls = (e >> 13) & 3, val = e & 0x1FF;
  return (cls == 0 && val > 255) || (cls == 2 && val < 3);
}

// K8's prologue: entries x = i0, i0 + step, ... of the 4096-entry table
// into dtab; returns whether any of them is canon_unsafe.
FDT_HD bool canon_table(const int32_t* meta, const int32_t* packed,
                        int32_t* dtab, int i0, int step) {
  bool unsafe = false;
  for (int x = i0; x < (1 << kMaxL); x += step) {
    dtab[x] = canon_entry(meta, meta + 16, packed, static_cast<uint32_t>(x));
    unsafe |= canon_unsafe(dtab[x]);
  }
  return unsafe;
}

// ---- K9, a group of threads per lane --------------------------------------
//
// Semantics of pallas_pack._kernel, the all-pairs select-accumulate:
// win[lane, w] = OR over the lane's pairs p of (wi_p == w ? lo_p : 0) |
// (wi_p == w - 1 ? hi_p : 0).  OR commutes, so it is a scatter: pair p ORs
// lo_p into word wi_p and hi_p into word wi_p + 1, targets outside
// [0, wwin) dropped, for any int32 tokens (no order of rel is assumed: a
// pair with wi == -1 still ORs its hi into word 0; an empty pair, wi ==
// -3, touches nothing).  rel = t0 >> 18 lies in [-8192, 8192), so wi <=
// 255 and no pair reaches past word 256: the group ORs into a window of
// kPackWords words in shared memory, and a wider window's words past it
// are zero.

constexpr int kPackWords = 260;  // words 0..256, rounded up to 16 bytes

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

// Four tokens from p (16-byte aligned on the card).
FDT_HD void load4(const int32_t* p, int32_t* x) {
#ifdef __CUDA_ARCH__
  const int4 v = *reinterpret_cast<const int4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
#else
  memcpy(x, p, 16);
#endif
}

// K9 lane `lane` of tokens int32[L, S] -> win[lane, :wwin], by the group g
// (warp.cuh) of m threads, with `buf` (kPackWords words, 16-byte aligned)
// in shared memory: zero the window, OR each pair's two words in (four
// tokens, two pairs, to a thread's 16-byte load where the lane's row is
// aligned), store the window, 16 bytes to a store where the row is
// aligned.
template <class G>
FDT_GROUP void pack_v1_group(const G& g, const int32_t* tok, int S,
                             int64_t lane, uint32_t* buf, uint32_t* win,
                             int wwin) {
  const int m = g.m;
  const int nb = imin(wwin, kPackWords);
  const int32_t* t = tok + lane * S;
  g.each([&](int i) {
    for (int j = i; j < nb; j += m) buf[j] = 0u;
  });
  g.sync();
  auto put = [&](int32_t t0, int32_t t1) {
    int wi;
    uint32_t lo, hi;
    pack_pair(t0, t1, &wi, &lo, &hi);
    if (lo && wi >= 0 && wi < nb) or_word(buf + wi, lo);
    if (hi && wi + 1 >= 0 && wi + 1 < nb) or_word(buf + wi + 1, hi);
  };
  const int nq = (reinterpret_cast<uintptr_t>(t) & 15) == 0 ? S >> 2 : 0;
  g.each([&](int i) {
    for (int q = i; q < nq; q += m) {
      int32_t x[4];
      load4(t + 4 * q, x);
      put(x[0], x[1]);
      put(x[2], x[3]);
    }
    for (int p = 2 * nq + i; p < S / 2; p += m) put(t[2 * p], t[2 * p + 1]);
  });
  g.sync();
  uint32_t* d = win + lane * wwin;
  const int nv = (reinterpret_cast<uintptr_t>(d) & 15) == 0 ? wwin >> 2 : 0;
  g.each([&](int i) {
    for (int c = i; c < nv; c += m) {
      if (4 * c + 4 <= nb) {
        g.store(d + 4 * c, buf + 4 * c, 16);
      } else {
        alignas(16) uint32_t v[4];
        for (int q = 0; q < 4; ++q) v[q] = 4 * c + q < nb ? buf[4 * c + q] : 0u;
        g.store(d + 4 * c, v, 16);
      }
    }
    for (int j = 4 * nv + i; j < wwin; j += m) d[j] = j < nb ? buf[j] : 0u;
  });
  g.sync();
}

// ---- K7, a group of threads per 1024-byte tile ----------------------------
//
// Semantics of ops/adler32_pallas.adler32_tiles_plain and its fold: tile t
// of a row covers bytes [1024 t, 1024 t + 1024); bytes at or past the
// row's limit (min(length, n)) count as zero.  S_t = sum d_i and W_t = sum
// (1024 - i) d_i over the tile's positions i, both below 2^31.  The
// checksum folds the tiles: A = 1 + sum S_t, B = length + sum ((length -
// o_t - 1024) S_t + W_t), both mod 65521, the coefficient taken as its
// non-negative residue (it is negative for the tile that holds the
// length and every tile past it).

constexpr int kAdlerTile = 1024;
constexpr int64_t kAdlerMod = 65521;
constexpr int kAdlerAhead = 5;   // chunks a thread loads before summing them

// acc + the four byte products of x and w (__dp4a on the card).
FDT_HD uint32_t dot4(uint32_t x, uint32_t w, uint32_t acc) {
#ifdef __CUDA_ARCH__
  return __dp4a(x, w, acc);
#else
  for (int k = 0; k < 4; ++k)
    acc += ((x >> (8 * k)) & 0xFFu) * ((w >> (8 * k)) & 0xFFu);
  return acc;
#endif
}

// The four words of the 16-aligned chunk at p.
FDT_HD void load16(const uint8_t* p, uint32_t x[4]) {
#ifdef __CUDA_ARCH__
  const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
#else
  memcpy(x, p, 16);
#endif
}

// x's bytes outside [jlo, jhi) cleared.
FDT_HD void keep_bytes(uint32_t x[4], int jlo, int jhi) {
  for (int k = 0; k < 4; ++k) {
    uint32_t keep = 0;
    for (int j = 0; j < 4; ++j)
      if (4 * k + j >= jlo && 4 * k + j < jhi) keep |= 0xFFu << (8 * j);
    x[k] &= keep;
  }
}

// x mod 65521 in [0, 65521), for x of either sign (C++ % truncates).
FDT_HD int64_t mod_adler(int64_t x) {
  const int64_t r = x % kAdlerMod;
  return r < 0 ? r + kAdlerMod : r;
}

struct TileSums {
  int32_t s, w;
};

// Tile sums of row bytes [o, o + 1024) below `limit`.  The row need not be
// 16-byte aligned: the group reads the 16-aligned chunks that hold the
// tile's bytes (65 of them when the row is not aligned), each once, and
// clears the bytes of a chunk outside the tile or at or past the limit.
// A chunk is read only if it holds a byte of the row below the limit.
// Each thread loads up to kAdlerAhead of its chunks before it sums any
// (with 16 threads to a tile, all of them: one memory round trip a tile),
// then sums them with byte dot products: the plain sum, and sum p d with
// p = 16 q - mis + j the tile position of byte j of chunk q;
// W = 1024 S - sum p d.
template <class G>
FDT_GROUP TileSums adler_tile_group(const G& g, const uint8_t* row, int64_t o,
                                    int64_t limit) {
  const int m = g.m;
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(row) & 15);
  const uint8_t* base = row + o - mis;  // 16-aligned: o is a multiple of 1024
  const int64_t end = limit - o + mis;  // valid bytes of base: [mis, vhi)
  const int vhi = static_cast<int>(end < kAdlerTile + mis ? end
                                                          : kAdlerTile + mis);
  const int nq = vhi > mis ? (vhi + 15) >> 4 : 0;
  typename G::template Var<int> s, r;
  g.each([&](int i) {
    int si = 0, ri = 0;
    for (int q0 = i; q0 < nq; q0 += kAdlerAhead * m) {
      uint32_t x[kAdlerAhead][4];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
      for (int u = 0; u < kAdlerAhead; ++u)
        if (q0 + u * m < nq) load16(base + 16 * (q0 + u * m), x[u]);
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
      for (int u = 0; u < kAdlerAhead; ++u) {
        const int q = q0 + u * m;
        if (q >= nq) continue;
        const int jlo = mis - 16 * q, jhi = vhi - 16 * q;
        if (jlo > 0 || jhi < 16) keep_bytes(x[u], jlo, jhi);
        uint32_t cs = 0, cj = 0;
        for (int k = 0; k < 4; ++k) {
          cs = dot4(x[u][k], 0x01010101u, cs);
          cj = dot4(x[u][k], 0x03020100u + 0x04040404u * k, cj);  // j = 4k..
        }
        si += static_cast<int>(cs);
        ri += (16 * q - mis) * static_cast<int>(cs) + static_cast<int>(cj);
      }
    }
    s[i] = si;
    r[i] = ri;
  });
  const int S = g.sum(s);
  return {S, kAdlerTile * S - g.sum(r)};
}

// Tile t's term of B (at offset o, of a row of `length` bytes), in
// [0, 2 * 65521): the product reduced, then W_t reduced, as the JAX fold
// takes them.
FDT_HD uint64_t adler_term(int64_t length, int64_t o, TileSums t) {
  const uint64_t coef =
      static_cast<uint64_t>(mod_adler(length - o - kAdlerTile));
  return coef * static_cast<uint32_t>(t.s) % kAdlerMod +
         static_cast<uint32_t>(t.w) % kAdlerMod;
}

// The checksum from the row's sum of S_t (a) and of its terms (b).
FDT_HD int64_t adler_finish(int64_t length, uint64_t a, uint64_t b) {
  const uint64_t A = (1 + a) % kAdlerMod;
  const uint64_t B = (static_cast<uint64_t>(mod_adler(length)) + b) % kAdlerMod;
  return static_cast<int64_t>((B << 16) | A);
}

// ---- K10, a group of threads per 1024-word output slab --------------------
//
// K2's output (ops/repack.combine_plain), slab by slab: slab s of stream b
// is words [1024 s, 1024 s + 1024) of words[b, 0:W].  K2's precondition
// holds (lanes in order along the stream, each lane's payload ending at
// or before the next lane's start, window bits past chunk_bits zero), so
// along a stream both pos0 and pos0 + max(chunk_bits, 1) rise, and the
// lanes that can touch the slab are one range [lo, hi), found by two
// searches over the stream's C lanes: lo is the first lane whose last
// payload word (a 0-bit lane: its start word) is at or past the slab's
// start, hi the first lane starting at or past its end.  These are the
// ranges of ops/repack.slab_lanes.  The group stages the window words that
// reach the slab (16-byte copies where the windows are 16-byte aligned)
// for up to m lanes at a time, and each thread forms its own output words
// from the staged lanes that reach them; a slab with no lane is stored as
// zeros.

FDT_HD int popc32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

constexpr int kSlabWords = 1024;
constexpr int kSlabMeta = 8;        // ints of a staged lane's entry
constexpr int kSlabStage = 1152;    // staged words: one lane's reach + 128
constexpr int kSlabBuf = 32 * kSlabMeta + kSlabStage;  // a group's buffer

// The first i in [lo, hi) with pred(i), hi if none; pred is false, then
// true, along [lo, hi).  Each round, the m threads test m points that
// split the range into m + 1 parts (m = 1: a binary search).
template <class G, class P>
FDT_GROUP int64_t first_true(const G& g, int64_t lo, int64_t hi, P pred) {
  const int m = g.m;
  typename G::template Var<bool> p;
  while (lo < hi) {
    const int64_t n = hi - lo, a = lo;
    g.each([&](int i) { p[i] = pred(a + (i + 1) * n / (m + 1)); });
    const uint32_t hit = g.ballot(p);
    if (hit) {
      const int j = ctz64(hit);
      hi = a + (j + 1) * n / (m + 1);
      if (j) lo = a + j * n / (m + 1) + 1;
    } else {
      lo = a + m * n / (m + 1) + 1;
    }
  }
  return lo;
}

// The lanes [*lo, *hi) of stream b that can touch the slab at word s0.
template <class G>
FDT_GROUP void slab_range(const G& g, const int32_t* chunk_bits,
                          const int32_t* pos0, int64_t b, int C, int64_t s0,
                          int64_t* lo, int64_t* hi) {
  const int64_t first = b * C, end = first + C;
  // Past the last lane's key (the largest) no lane reaches: most slabs of
  // a stream that compresses well, settled by one load.
  const int32_t cl = C ? chunk_bits[end - 1] : 0;
  if (C == 0 || static_cast<int64_t>(pos0[end - 1]) + (cl > 0 ? cl : 1) <=
                    32 * s0) {
    *lo = *hi = end;
    return;
  }
  *lo = first_true(g, first, end, [&](int64_t i) {
    const int32_t c = chunk_bits[i];
    return static_cast<int64_t>(pos0[i]) + (c > 0 ? c : 1) > 32 * s0;
  });
  *hi = first_true(g, *lo, end, [&](int64_t i) {
    return static_cast<int64_t>(pos0[i]) >= 32 * (s0 + kSlabWords);
  });
}

// Slab `slab` of stream b: words [s0, s1) of words[b, 0:W], written once
// each (the first staging round stores, later rounds OR into the group's
// own words).  `buf`: kSlabBuf words, 16-byte aligned, the group's own.
template <class G>
FDT_GROUP void combine_slab_group(const G& g, const uint32_t* win,
                                  const int32_t* chunk_bits,
                                  const int32_t* pos0, uint32_t* words, int C,
                                  int wwin, int W, int64_t L, int64_t b,
                                  int64_t slab, uint32_t* buf) {
  const int m = g.m;
  const int64_t s0 = slab * kSlabWords;
  const int64_t s1 = s0 + kSlabWords < W ? s0 + kSlabWords : W;
  const int64_t rowf = b * W;
  int64_t lo, hi;
  slab_range(g, chunk_bits, pos0, b, C, s0, &lo, &hi);
  int32_t* meta = reinterpret_cast<int32_t*>(buf);
  uint32_t* stage = buf + 32 * kSlabMeta;
  const bool al16 = (reinterpret_cast<uintptr_t>(win) & 15) == 0;
  const int64_t total = L * wwin;
  typename G::template Var<int> sz;
  typename G::template Var<bool> fits;
  for (int64_t i0 = lo, round = 0; round == 0 || i0 < hi; ++round) {
    // Each thread takes lane i0 + i: the window words [ja, jb) that reach
    // the slab, staged from the 16-aligned word a0 on.
    g.each([&](int i) {
      const int64_t lane = i0 + i;
      int32_t* e = meta + i * kSlabMeta;
      sz[i] = 0;
      if (lane >= hi) return;
      const int32_t p = pos0[lane];
      const int64_t f = p >> 5;
      const int64_t nw = (chunk_bits[lane] + 31) >> 5;
      const int64_t ja = s0 - f - 1 > 0 ? s0 - f - 1 : 0;
      const int64_t jb = s1 - f < nw ? s1 - f : nw;
      const int64_t a = lane * wwin;
      const int64_t a0 = (a + (ja < jb ? ja : 0)) & ~int64_t{3};
      e[0] = static_cast<int32_t>(f - s0);  // may be negative
      e[1] = p & 31;
      e[2] = static_cast<int32_t>(ja);
      e[3] = static_cast<int32_t>(jb > ja ? jb : ja);
      e[5] = static_cast<int32_t>(a - a0);  // staged index of word 0, less off
      sz[i] = jb > ja ? static_cast<int>(((a + jb + 3) & ~int64_t{3}) - a0) : 0;
    });
    typename G::template Var<int> off = sz;
    g.excl_scan(off, 0, [](int x, int y) { return x + y; });
    g.each([&](int i) {
      fits[i] = i0 + i < hi && off[i] + sz[i] <= kSlabStage;
      meta[i * kSlabMeta + 4] = off[i];
      meta[i * kSlabMeta + 6] = sz[i];
    });
    const int nk = popc32(g.ballot(fits));
    g.sync();
    // Stage: the group's threads copy each lane's chunks in turn.
    for (int k = 0; k < nk; ++k) {
      const int32_t* e = meta + k * kSlabMeta;
      const int64_t a0 = (i0 + k) * wwin - e[5];
      uint32_t* dst = stage + e[4];
      const int n4 = e[6] >> 2;
      g.each([&](int i) {
        for (int c = i; c < n4; c += m) {
          const int64_t w = a0 + 4 * c;
          if (al16 && w + 4 <= total) {
            g.copy(dst + 4 * c, win + w, 16);
          } else {
            for (int q = 0; q < 4; ++q)
              if (w + q < total) g.copy(dst + 4 * c + q, win + w + q, 4);
          }
        }
      });
    }
    g.wait();
    // Each thread's quads of output words: the staged lanes that reach them.
    const int64_t fa = (rowf + s0) & ~int64_t{3};
    g.each([&](int i) {
      for (int64_t f = fa + 4 * i; f < rowf + s1; f += 4 * m) {
        const int64_t w = f - rowf;  // first word of the quad in the stream
        alignas(16) uint32_t v[4] = {0u, 0u, 0u, 0u};
        if (round) {
          for (int q = 0; q < 4; ++q)
            if (w + q >= s0 && w + q < s1) v[q] = words[f + q];
        }
        for (int k = 0; k < nk; ++k) {
          const int32_t* e = meta + k * kSlabMeta;
          const int64_t lf = s0 + e[0];        // the lane's first word
          const int ja = e[2], jb = e[3];
          if (w + 3 < lf + ja || w > lf + jb) continue;
          const uint32_t* row = stage + e[4] + e[5];
          uint32_t x[5];
          for (int q = 0; q < 5; ++q) {
            const int64_t j = w - lf - 1 + q;
            x[q] = j >= ja && j < jb ? row[j] : 0u;
          }
          for (int q = 0; q < 4; ++q) v[q] |= funnel_l(x[q], x[q + 1], e[1]);
        }
        combine_store(g, words, f, rowf, s0, s1, v);
      }
    });
    g.sync();
    i0 += nk;
  }
}

}  // namespace fdt
