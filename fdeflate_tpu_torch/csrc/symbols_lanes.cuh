// Lane code of K11 decode_symbols: the table-gather symbol engine of
// fdeflate_tpu/ops/inflate.py:64 (an XLA while_loop), one lane at a time.
//
// sym_step is one iteration of the JAX loop body for one lane, written
// expression for expression: the same 96-bit window of three words, the
// same peeks, chained literal entries, secondary lookups, status precedence
// and refill.  Values are u32 or i32 as in JAX; every shift whose count can
// reach 32 goes through sym_shr / sym_shl, which give 0 there as XLA's
// logical shifts do (a C++ shift by 32 is undefined), and i32 sums wrap as
// XLA's do (add32).  decode_symbols_lane runs a lane while it runs (at most
// max_steps steps), writing one record a step, and counts its steps; with
// ``fill`` it goes on to max_steps and the rows where it no longer runs get
// the records' initial values (0, 0, 0, 0, 0, -1): JAX's full
// [max_steps, L] form.  Without it the lane stops with its group's vote and
// those rows are left unwritten (the live form).  Plain C++, so the same
// source compiles for the host (tests/test_torch_symbols_host.py); the
// kernel passes a warp vote as ``any``, so a warp steps while any of its
// lanes runs.
#pragma once

#include "lanes.cuh"

namespace fdt {

// Lane statuses (ops/decode_symbols.py; JAX ops/inflate.py:50-56).  A
// truncated lane reads 2, as a stopped one does: both are JAX's values.
constexpr int8_t kSymOk = 0, kSymEob = 1, kSymStopped = 2;
constexpr int8_t kSymErrLitlen = 11, kSymErrDist = 12, kSymErrTooFar = 14;
constexpr int8_t kSymErrTrunc = 2;
constexpr int kSymLitlen = 4096, kSymDist = 512;

// One lane's tables: the entries of its table row (litlen_first may be
// null) and its secondary rows with their widths (>= 1).
struct SymTables {
  const uint32_t* litlen;
  const int32_t* first;
  const uint32_t* dist;
  const uint32_t* lsec;
  int nsec;
  const uint32_t* dsec;
  int ndsec;
};

// Where a lane writes: record i at rec[i * stride] of each array.
struct SymOut {
  uint32_t* lo;
  uint32_t* hi;
  int8_t* cnt;
  int32_t* len;
  int32_t* dist;
  int32_t* pos;
  int64_t stride;
};

struct SymState {
  int32_t bpos, opos;
  int8_t status;
  int32_t base;          // window words are row[base .. base + 2]
  uint32_t w0, w1, w2;
};

FDT_HD uint32_t sym_shr(uint32_t x, uint32_t s) { return s >= 32 ? 0u : x >> s; }
FDT_HD uint32_t sym_shl(uint32_t x, uint32_t s) { return s >= 32 ? 0u : x << s; }
FDT_HD int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
FDT_HD int32_t iclamp(int32_t x, int32_t lo, int32_t hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// The row's word at widx, reading its last word for any index past it.
FDT_HD uint32_t sym_load(const uint32_t* row, int32_t wlast, int32_t widx) {
  return row[iclamp(widx, 0, wlast)];
}

// 32 bits at bpos + off from the window (JAX make_peek).
FDT_HD uint32_t sym_peek(const SymState& st, int32_t off) {
  const int32_t o = add32(st.bpos - (st.base << 5), off);
  const bool sel = o >= 32;
  const uint32_t a = sel ? st.w1 : st.w0, b = sel ? st.w2 : st.w1;
  const uint32_t oo = static_cast<uint32_t>(o & 31);
  return (a >> oo) | (oo == 0 ? 0u : b << (32 - oo));
}

// OR a literal pair into the step's 64-bit literal word at byte_off (JAX
// place(), its clamped shifts included).
FDT_HD void sym_place(uint32_t& lo, uint32_t& hi, uint32_t lit,
                      int32_t byte_off, bool m) {
  const uint32_t sh = static_cast<uint32_t>(8 * byte_off);
  const uint32_t sh_a = sh < 31 ? sh : 31;
  const int32_t sh_b = iclamp(static_cast<int32_t>(sh) - 32, 0, 31);
  const uint32_t lo_c = sh < 32 ? lit << sh_a : 0u;
  const uint32_t hi_c = sh < 32 ? (lit >> 1) >> (31 - sh_a) : lit << sh_b;
  if (m) {
    lo |= lo_c;
    hi |= hi_c;
  }
}

// Closed forms of RFC 1951's length and distance symbol tables (JAX
// len_sym_decode / dist_sym_decode).
FDT_HD void sym_len(int32_t li, int32_t* base, int32_t* extra) {
  const int32_t e = li < 8 ? 0 : imin((li - 4) >> 2, 5);
  const int32_t b = li < 8 ? li + 3 : ((4 + (li & 3)) << imax((li - 4) >> 2, 0)) + 3;
  *extra = li >= 28 ? 0 : e;
  *base = li >= 28 ? 258 : b;
}

FDT_HD void sym_dist(int32_t s, int32_t* base, int32_t* extra) {
  *extra = imax(s / 2 - 1, 0);
  *base = s < 2 ? s + 1 : ((2 + (s & 1)) << *extra) + 1;
}

FDT_HD SymState sym_init(const uint32_t* row, int32_t wlast, int32_t bit_pos,
                         int32_t out_pos, bool active) {
  SymState st;
  st.bpos = bit_pos;
  st.opos = out_pos;
  st.status = active ? kSymOk : kSymEob;
  st.base = bit_pos >> 5;
  st.w0 = sym_load(row, wlast, st.base);
  st.w1 = sym_load(row, wlast, st.base + 1);
  st.w2 = sym_load(row, wlast, st.base + 2);
  return st;
}

// One decode step of a running lane: writes its record at out[i] and
// advances the state (JAX body()).
FDT_HD void sym_step(SymState& st, const uint32_t* row, int32_t wlast,
                     int32_t bit_end, int32_t bit_stop, const SymTables& tb,
                     int chain, const SymOut& out, int64_t i) {
  const uint32_t ubits = sym_peek(st, 0);
  const uint32_t e = tb.litlen[ubits & 4095];
  int32_t ecode_bits = static_cast<int32_t>(e & 0xFF);
  const bool is_lit = (e & 0x8000) != 0;
  int32_t cnt1 = static_cast<int32_t>((e >> 8) & 0xF);
  uint32_t lit1 = (e >> 16) & 0xFFFF;
  bool cross = false;
  if (tb.first != nullptr) {
    cross = is_lit && add32(st.bpos, ecode_bits) > bit_stop;
    if (cross) {
      ecode_bits = tb.first[ubits & 4095];
      cnt1 = 1;
      lit1 &= 0xFF;
    }
  }
  uint32_t lit_lo = 0, lit_hi = 0;
  sym_place(lit_lo, lit_hi, lit1, 0, is_lit);
  int32_t lit_count = is_lit ? cnt1 : 0;
  int32_t lit_bits = is_lit ? ecode_bits : 0;
  bool chained = is_lit && !cross;

  // One chained literal lookup with its stop handling (JAX chain_level).
  auto level = [&](uint32_t idx_bits) {
    const uint32_t e_n = tb.litlen[idx_bits & 4095];
    const bool ok_n = chained && (e_n & 0x8000) != 0 &&
                      add32(st.bpos, lit_bits) < bit_stop;
    int32_t bits_n = static_cast<int32_t>(e_n & 0xFF);
    int32_t cnt_n = static_cast<int32_t>((e_n >> 8) & 0xF);
    uint32_t lit_n = (e_n >> 16) & 0xFFFF;
    bool cross_n = false;
    if (tb.first != nullptr) {
      cross_n = ok_n && add32(add32(st.bpos, lit_bits), bits_n) > bit_stop;
      if (cross_n) {
        bits_n = tb.first[idx_bits & 4095];
        cnt_n = 1;
        lit_n &= 0xFF;
      }
    }
    sym_place(lit_lo, lit_hi, lit_n, lit_count, ok_n);
    if (ok_n) {
      lit_count = add32(lit_count, cnt_n);
      lit_bits = add32(lit_bits, bits_n);
    }
    chained = ok_n && !cross_n;
  };
  if (chain >= 2) level(sym_shr(ubits, static_cast<uint32_t>(ecode_bits)));
  if (chain >= 4) {
    const int32_t before3 = lit_bits;
    const uint32_t bits3 = sym_peek(st, lit_bits);
    level(bits3);
    level(sym_shr(bits3, static_cast<uint32_t>(lit_bits - before3)));
  }

  // Non-literal: secondary table, length entry, EOF or invalid.
  const bool exceptional = (e & 0x4000) != 0;
  const bool has_sec = (e & 0x2000) != 0;
  const int32_t sec_idx = iclamp(
      static_cast<int32_t>(e >> 16) +
          static_cast<int32_t>((ubits >> 12) & (e & 0xFF)),
      0, tb.nsec - 1);
  const int32_t se = static_cast<int32_t>(tb.lsec[sec_idx]);
  const int32_t sec_sym = se >> 4, sec_bits = se & 0xF;
  const bool sec_is_lit = has_sec && sec_sym < 256;
  const bool sec_is_eof = has_sec && sec_sym == 256;
  const bool sec_is_len = has_sec && sec_sym > 256;
  const bool plain_len = !is_lit && !exceptional;
  const bool plain_eof = !is_lit && exceptional && !has_sec && ecode_bits != 0;
  const bool invalid_ll = !is_lit && exceptional && !has_sec && ecode_bits == 0;

  int32_t lb_f, le_f;
  sym_len(iclamp(sec_sym - 257, 0, 30), &lb_f, &le_f);
  const int32_t length_base = plain_len ? static_cast<int32_t>(e >> 16) : lb_f;
  const int32_t length_extra =
      plain_len ? static_cast<int32_t>((e >> 8) & 0xFF) : le_f;
  const int32_t ll_bits = plain_len ? ecode_bits : sec_bits;
  const bool is_len = plain_len || sec_is_len;
  const uint32_t rem = sym_shr(ubits, static_cast<uint32_t>(ll_bits));
  const int32_t length = add32(
      length_base,
      static_cast<int32_t>(
          rem & (sym_shl(1u, static_cast<uint32_t>(length_extra)) - 1u)));

  // Distance at bpos + ll_bits + length_extra.
  const uint32_t dbits = sym_peek(st, add32(ll_bits, length_extra));
  const uint32_t de = tb.dist[dbits & 511];
  const bool d_prim = (de & 0x8000) != 0;
  const int32_t d_sec_idx = iclamp(
      static_cast<int32_t>(de >> 16) +
          static_cast<int32_t>((dbits >> 9) & (de & 0xFF)),
      0, tb.ndsec - 1);
  const int32_t dse = static_cast<int32_t>(tb.dsec[d_sec_idx]);
  const int32_t d_sec_sym = dse >> 4;
  const bool d_invalid = !d_prim && ((de >> 8) == 0 || d_sec_sym >= 30);
  int32_t db_f, de_f;
  sym_dist(iclamp(d_sec_sym, 0, 29), &db_f, &de_f);
  const int32_t dist_base = d_prim ? static_cast<int32_t>(de >> 16) : db_f;
  const int32_t dist_extra =
      d_prim ? static_cast<int32_t>((de >> 8) & 0xF) : de_f;
  const int32_t d_code_bits = d_prim ? static_cast<int32_t>(de & 0xFF) : (dse & 0xF);
  const uint32_t drem = sym_shr(dbits, static_cast<uint32_t>(d_code_bits));
  const int32_t distance = add32(
      dist_base,
      static_cast<int32_t>(
          drem & (sym_shl(1u, static_cast<uint32_t>(dist_extra)) - 1u)));

  const int32_t consumed =
      is_lit ? lit_bits
             : (sec_is_lit || sec_is_eof)
                   ? sec_bits
                   : plain_eof ? ecode_bits
                               : add32(add32(add32(ll_bits, length_extra),
                                             d_code_bits),
                                       dist_extra);
  const bool truncated = add32(st.bpos, consumed) > bit_end;
  const bool is_eof = plain_eof || sec_is_eof;
  const bool too_far = is_len && distance > st.opos;
  int8_t err = invalid_ll              ? kSymErrLitlen
               : (is_len && d_invalid) ? kSymErrDist
               : (is_len && too_far)   ? kSymErrTooFar
                                       : kSymOk;
  if (truncated) err = kSymErrTrunc;
  const bool commit = !truncated && err == kSymOk && !is_eof;

  uint32_t out_lit = commit && is_lit ? lit_lo : 0u;
  const uint32_t out_hi = commit && is_lit ? lit_hi : 0u;
  if (commit && sec_is_lit) out_lit = static_cast<uint32_t>(sec_sym);
  const int8_t out_cnt = static_cast<int8_t>(
      commit ? (is_lit ? lit_count : (sec_is_lit ? 1 : 0)) : 0);
  const int32_t out_len = commit && is_len ? length : 0;
  const int32_t out_dst = commit && is_len ? distance : 0;
  const int64_t r = i * out.stride;
  out.lo[r] = out_lit;
  out.hi[r] = out_hi;
  out.cnt[r] = out_cnt;
  out.len[r] = out_len;
  out.dist[r] = out_dst;
  out.pos[r] = st.bpos;

  const int32_t new_bpos =
      (commit || (is_eof && !truncated)) ? add32(st.bpos, consumed) : st.bpos;
  st.opos = add32(add32(st.opos, out_cnt), out_len);
  st.status = (truncated || err != kSymOk)
                  ? err
                  : is_eof ? kSymEob
                           : new_bpos >= bit_stop ? kSymStopped : kSymOk;
  st.bpos = new_bpos;
  for (int k = 0; k < 2; ++k) {
    if ((st.bpos >> 5) > st.base) {
      st.w0 = st.w1;
      st.w1 = st.w2;
      ++st.base;
      st.w2 = sym_load(row, wlast, st.base + 2);
    }
  }
}

// The records' initial values, written (with ``fill``) for a step the lane
// does not run.
FDT_HD void sym_idle(const SymOut& out, int64_t i) {
  const int64_t r = i * out.stride;
  out.lo[r] = 0;
  out.hi[r] = 0;
  out.cnt[r] = 0;
  out.len[r] = 0;
  out.dist[r] = 0;
  out.pos[r] = -1;
}

// A lane steps while it runs: the host's ``any``.
struct LaneVote {
  FDT_HD bool operator()(bool running) const { return running; }
};

// A lane's whole run: its records and final state, and in *steps the
// number of steps it ran (its records are rows [0, *steps)).  Without
// ``fill`` the lane steps while ``any(running)`` holds for its group (all
// lanes of a group see one i); with it, to max_steps, writing the initial
// values at the rows where it no longer runs, so a group of lanes writes
// each row together and the writes overlap the steps of its other lanes.
template <class Vote>
FDT_HD void decode_symbols_lane(const uint32_t* row, int32_t W,
                                int32_t bit_pos, int32_t bit_end,
                                int32_t out_pos, bool active,
                                int32_t bit_stop, const SymTables& tb,
                                int chain, int max_steps, bool fill,
                                const SymOut& out, int32_t* steps,
                                int32_t* bpos, int32_t* opos,
                                int8_t* status, Vote any) {
  const int32_t wlast = W - 1;
  SymState st = sym_init(row, wlast, bit_pos, out_pos, active);
  int32_t n = 0;
  for (int i = 0; i < max_steps && (fill || any(st.status == kSymOk)); ++i) {
    if (st.status == kSymOk) {
      sym_step(st, row, wlast, bit_end, bit_stop, tb, chain, out, i);
      n = i + 1;
    } else if (fill) {
      sym_idle(out, i);
    }
  }
  *steps = n;
  *bpos = st.bpos;
  *opos = st.opos;
  *status = st.status;
}

}  // namespace fdt
