// Lane code of K12 header_tables: one validated dynamic-block header per
// group (a warp on the card), parsed and turned into K4's tables.
//
// Semantics of ops/header_tables.header_tables_plain, the host's parse
// (_HostBitReader, _parse_dynamic_lengths) and table build (block_tables,
// foreign_meta) of ops/inflate_host.py:
//   * the header at absolute bit c of a stream whose payload ends at bit
//     `bit_end` (words at or past `wend` read as 0) is parsed as RFC 1951
//     reads it (a code 16 repeats the length before it, 0 after a 17 or an
//     18, which K5's val_sections does not);
//   * status kHdrSkipped where the parse fails: BTYPE not 2, HLIT > 286,
//     HDIST > 30, a code-length code that is not exactly complete, a 16
//     first, a repeat past HLIT + HDIST, a field or section past bit_end
//     (7 bits left before each section), or no end-of-block code;
//     kHdrDropped where the table build fails: a literal/length code, or a
//     distance code of two or more codes, that is not exactly complete;
//     else kHdrLane, with foreign_meta's meta[64] and tab[160] (its special
//     cases for no and for one distance code included);
//   * host_ok 1 where the host's own tree rule (_check_trees) takes the
//     lane's trees too: it refuses a single distance code longer than 1
//     bit, which foreign_meta takes.  0 for every header that is not a
//     lane.
//
// The parse is one serial chain; every thread of the group runs it in step
// (the same loads, broadcast, and the same branches), so each holds the
// header's fields in registers, while a repeat's lengths are stored by the
// threads in turn.  The table build is the group's: per chunk of 32
// symbols and per code length a ballot gives each symbol its rank among
// the symbols of its length before it and the count of each length; one
// thread writes the canonical bounds and kvals (_canonical15), and each
// thread places its symbols' 15-bit entries at their canonical index.
// Plain C++ apart from warp.cuh's policy and bit intrinsics, so the same
// source also compiles for the host (tests/test_torch_header_tables.py).
#pragma once

#include "inflate_lanes.cuh"

namespace fdt {

constexpr int32_t kHdrLane = 0;
constexpr int32_t kHdrSkipped = 1;
constexpr int32_t kHdrDropped = 2;
constexpr int kHdrLitSyms = 288;  // litlen lengths at [0, 288), distance after
constexpr int kHdrLens = 320;
constexpr int kLitBase = 32;          // foreign_meta's _LIT_BASE
constexpr uint16_t kSentinel = 0x7FFF;  // foreign_meta's invalid-code entry

// One header's shared memory.
struct HdrScratch {
  int32_t meta[kMetaRows];
  int32_t acc[32];  // symbols of shorter codes: litlen [0, 16), distance after
  uint16_t ent[kTabEntries];
  uint8_t cl[128];  // the CL decode (cl_table), 4-byte aligned
  uint8_t lens[kHdrLens];
};

// foreign_meta's table entry of literal/length symbol s.
FDT_HD uint16_t lit_entry(int s) {
  if (s < 256) return static_cast<uint16_t>(s);
  if (s == 256) return 1 << 13;
  if (s > 285) return kSentinel;
  const int k = s - 257;
  const int e = (k < 4 || k == 28) ? 0 : (k >> 2) - 1;
  const int base = k == 28 ? 258 : k < 4 ? k + 3 : ((4 + (k & 3)) << e) + 3;
  return static_cast<uint16_t>(base | (e << 9) | (2 << 13));
}

// Whether the code of cnt[1..15] symbols per length is exactly complete.
FDT_HD bool complete15(const int* cnt) {
  int32_t code = 0;
#pragma unroll
  for (int L = 1; L <= 15; ++L) code = (code + cnt[L]) << 1;
  return code == 1 << 16;
}

// _canonical15 of a complete code: bounds at b[0..15], kvals + kbase at
// k[0..15]; acc[L] the symbols of codes shorter than L.
FDT_HD void canon_rows(const int* cnt, int32_t* b, int32_t* k, int32_t* acc,
                       int32_t kbase) {
  int32_t code = 0, a = 0;
  b[0] = 0;
  k[0] = kbase;
  acc[0] = 0;
#pragma unroll
  for (int L = 1; L <= 15; ++L) {
    b[L] = (code + cnt[L]) << (15 - L);
    k[L] = a - code + kbase;
    acc[L] = a;
    a += cnt[L];
    code = (code + cnt[L]) << 1;
  }
}

// The header at bit c: info[0] its status, info[H] BFINAL, info[2 * H]
// its symbol start (0 and -1 when skipped) and info[3 * H] host_ok;
// meta[64] and tab[160] its tables, zero unless it is a lane.
template <class G>
FDT_GROUP void header_group(const G& g, const uint32_t* words, int64_t wend,
                            int64_t c, int64_t bit_end, HdrScratch& sh,
                            int64_t* info, int64_t H, int32_t* meta,
                            int32_t* tab) {
  const int kClcl[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5,
                         11, 4, 12, 3, 13, 2, 14, 1, 15};
  g.each([&](int i) {
    for (int k = i; k < kHdrLens; k += g.m) sh.lens[k] = 0;
  });
  int32_t status = kHdrSkipped;
  int bfinal = 0;
  int64_t pos = c;
  HeaderBits hb(words, wend, c);
  do {  // the parse, up to its first failure
    if (c + 17 > bit_end) break;  // BFINAL, BTYPE, HLIT, HDIST, HCLEN
    const uint32_t h = hb.peek();
    bfinal = static_cast<int>(h & 1);
    const int hlit = static_cast<int>((h >> 3) & 31) + 257;
    const int hdist = static_cast<int>((h >> 8) & 31) + 1;
    const int ncl = static_cast<int>((h >> 13) & 15) + 4;
    if (((h >> 1) & 3) != 2 || hlit > 286 || hdist > 30) break;
    hb.skip(3);
    hb.skip(14);
    pos = c + 17;
    if (pos + 3 * ncl > bit_end) break;
    uint64_t clp = 0;
#pragma unroll
    for (int j = 0; j < 19; ++j) {
      if (j < ncl) {
        clp |= static_cast<uint64_t>(hb.peek() & 7) << (3 * kClcl[j]);
        hb.skip(3);
      }
    }
    pos += 3 * ncl;
    int kraft = 0;
#pragma unroll
    for (int s = 0; s < 19; ++s) {
      const int l = cl_len(clp, s);
      kraft += l ? 128 >> l : 0;
    }
    if (kraft != 128) break;  // the CL code is not exactly complete
    g.each([&](int i) {
      if (i == 0) cl_table(clp, sh.cl);
    });
    g.sync();
    const int total = hlit + hdist;
    int n = 0, prev = 0, len256 = 0;
    bool ok = true;
    while (n < total) {
      if (pos + 7 > bit_end) {
        ok = false;
        break;
      }
      const uint32_t v = hb.peek();
      const uint32_t e = sh.cl[bitrev7(v & 0x7F)];  // complete: never kClBad
      const int L = static_cast<int>(e >> 5) & 7;
      const int sym = static_cast<int>(e & 31);
      int rep = 1, value = sym, used = L;
      if (sym > 15) {
        const int eb = sym == 16 ? 2 : (sym == 17 ? 3 : 7);
        if ((sym == 16 && n == 0) || pos + L + eb > bit_end) {
          ok = false;
          break;
        }
        rep = (sym == 18 ? 11 : 3) +
              static_cast<int>((v >> L) & ((1u << eb) - 1));
        value = sym == 16 ? prev : 0;
        used = L + eb;
        if (n + rep > total) {
          ok = false;
          break;
        }
      }
      g.each([&](int i) {
        for (int j = i; j < rep; j += g.m) {
          const int k = n + j;
          sh.lens[k < hlit ? k : kHdrLitSyms + k - hlit] =
              static_cast<uint8_t>(value);
        }
      });
      if (n <= 256 && 256 < n + rep) len256 = value;
      n += rep;
      prev = value;
      pos += used;
      hb.skip(used);
    }
    if (ok && len256 > 0) status = kHdrLane;
  } while (false);

  // Symbols per code length, and each symbol's rank among those of its
  // length before it: chunks 0-8 the literal/length code, 9 the distance.
  int cnt[2][16] = {};
  int nz_d = 0;
  bool host_ok = false;
  if (status == kHdrLane) {
    g.sync();
    typename G::template Var<int> rk[10];
#pragma unroll
    for (int ch = 0; ch < 10; ++ch) {
      typename G::template Var<int> l;
      g.each([&](int i) { l[i] = sh.lens[32 * ch + i]; });
      int* run = cnt[ch == 9];
#pragma unroll
      for (int L = 1; L <= 15; ++L) {
        typename G::template Var<bool> p;
        g.each([&](int i) { p[i] = l[i] == L; });
        const uint32_t b = g.ballot(p);
        g.each([&](int i) {
          if (l[i] == L) rk[ch][i] = run[L] + popc32(b & ((1u << i) - 1u));
        });
        run[L] += popc32(b);
      }
    }
#pragma unroll
    for (int L = 1; L <= 15; ++L) nz_d += cnt[1][L];
    if (!complete15(cnt[0]) || (nz_d >= 2 && !complete15(cnt[1])))
      status = kHdrDropped;
    host_ok = status == kHdrLane && (nz_d != 1 || cnt[1][1] == 1);
    if (status == kHdrLane) {
      g.each([&](int i) {
        for (int k = i; k < kTabEntries; k += g.m) sh.ent[k] = kSentinel;
        if (i != 0) return;
        canon_rows(cnt[0], sh.meta, sh.meta + 16, sh.acc, kLitBase);
        if (nz_d >= 2) {
          canon_rows(cnt[1], sh.meta + 32, sh.meta + 48, sh.acc + 16, 0);
          return;
        }
        // No distance code: every distance decode errs (kvals[1] points
        // at the sentinels).  One: it is code '0', a '1' is invalid.
        for (int L = 0; L < 16; ++L) {
          sh.meta[32 + L] = L ? 1 << 15 : 0;
          sh.meta[48 + L] = 0;
        }
        if (nz_d == 0) {
          sh.meta[49] = 30;
        } else {
          sh.meta[33] = 1 << 14;
          sh.meta[50] = 28;
        }
      });
      g.sync();
#pragma unroll
      for (int ch = 0; ch < 10; ++ch) {
        g.each([&](int i) {
          const int s = 32 * ch + i;
          const int l = sh.lens[s];
          if (!l) return;
          if (ch < 9)
            sh.ent[kLitBase + sh.acc[l] + rk[ch][i]] = lit_entry(s);
          else if (nz_d >= 2)
            sh.ent[sh.acc[16 + l] + rk[ch][i]] = static_cast<uint16_t>(i);
          else
            sh.ent[0] = static_cast<uint16_t>(i);
        });
      }
      g.sync();
    }
  }

  g.each([&](int i) {
    const bool lane = status == kHdrLane;
    for (int r = i; r < kMetaRows; r += g.m) meta[r] = lane ? sh.meta[r] : 0;
    for (int k = i; k < kTabPairs; k += g.m)
      tab[k] = lane ? static_cast<int32_t>(
                          sh.ent[2 * k] |
                          (static_cast<uint32_t>(sh.ent[2 * k + 1]) << 16))
                    : 0;
    if (i == 0) {
      info[0] = status;
      info[H] = status == kHdrSkipped ? 0 : bfinal;
      info[2 * H] = status == kHdrSkipped ? -1 : pos;
      info[3 * H] = host_ok ? 1 : 0;
    }
  });
}

}  // namespace fdt
