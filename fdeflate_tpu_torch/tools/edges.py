"""Edge inputs of K1 (assign_pack), K2 (combine), K3 (decode2), K4
(inflate_records), K5 (validate_headers), K6 (decode_sep), K8
(decode2_canon), K9 (pack_v1) and K12 (header_tables), and streams with bad
dynamic headers for the sequential path that launches K12.

These kernels put a group of threads on each lane: thread segments,
staged tiles, spans and lane ownership have edges the headline corpus may
never hit.  These inputs put runs, stalls, EOBs at every word phase, short
lanes, errors, exhausted budgets and stream ends in a batch on them.
``chip_smoke.py`` holds the kernels to their plain versions on them;
tests/test_torch_lanes_host.py holds the kernels' lane code, run on the
host, to the same.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from .corpus import make_idat_corpus


def _ragged(d: np.ndarray, lengths) -> np.ndarray:
    for b, n in enumerate(lengths):
        d[b, n:] = 0
    return d


def edge_runs(B: int, N: int, seed: int) -> np.ndarray:
    """Nonzero filler with zero runs of 258 n - 1, 258 n and 258 n + 1
    bytes (n = 1..3) starting and ending on 64-byte segment edges and on
    2048-byte tile edges, a run of one whole segment, one of a whole tile,
    and runs crossing a tile edge."""
    rng = np.random.default_rng(seed)
    d = rng.integers(1, 256, (B, N)).astype(np.uint8)
    for b in range(B):
        runs = [258 * n + e for n in (1, 2, 3) for e in (-1, 0, 1)]
        rng.shuffle(runs)
        edges = np.arange(64, N - 1024, 64 * int(rng.integers(5, 12)))
        for at, r in zip(edges, runs * 4):
            if rng.random() < 0.5:       # end on the edge
                d[b, max(at - r, 0):at] = 0
            else:                        # start on it
                d[b, at:at + r] = 0
        if N >= 8192:
            d[b, 4096:6144] = 0          # a whole tile
            d[b, 2048 - 300:2048 + 301] = 0
            d[b, 6144 - 64:6144 + 5] = 0
        d[b, 128:192] = 0                # a whole segment
    return d


def k1_edge_inputs():
    """[(label, u8[B, N], lengths, C)]: the batches K1 is held to its plain
    version on (S % 8 == 0)."""
    rng = np.random.default_rng(40)
    zeros = np.zeros((2, 8192), np.uint8)
    noruns = rng.integers(1, 256, (2, 8192)).astype(np.uint8)
    sparse = np.where(rng.random((2, 4096)) < 0.5, 0,
                      rng.integers(0, 256, (2, 4096))).astype(np.uint8)
    head = make_idat_corpus(3, 8192, seed=41)
    head[:, :40] = 0                     # a run opening lane 0 (k = 0)
    head[1, 2047] = 0                    # lane 1 entered after a zero byte
    head[1, 2048:2060] = 0
    return [
        ("all zeros, ragged", _ragged(zeros, [8192, 8179]), [8192, 8179], 4),
        ("random bytes, no runs", _ragged(noruns, [8192, 5003]), [8192, 5003], 4),
        ("runs of 258n-1..258n+1 on segment and tile edges, S = 4096",
         edge_runs(3, 16384, 42), [16384] * 3, 4),
        ("S = 8", _ragged(sparse, [4096, 4091]), [4096, 4091], 512),
        ("lanes past the stream's length, runs at lane 0",
         _ragged(head, [8192, 8192, 1000]), [8192, 8192, 1000], 8),
    ]


def k1_long_lane():
    """One 1 MiB lane (C = 1, as ``compress_batch_ultra_fast`` runs K1)."""
    return ("C = 1, one 1 MiB lane", make_idat_corpus(1, 1 << 20, seed=43),
            [1 << 20], 1)


def corrupt_words(words: torch.Tensor, total_bits: torch.Tensor, n: int,
                  seed: int) -> torch.Tensor:
    """A copy of the stream words with ``n`` random payload words per stream
    XORed with random nonzero values."""
    rng = np.random.default_rng(seed)
    w = words.clone()
    for b in range(w.shape[0]):
        hi = max(2, int(total_bits[b]) // 32)
        idx = torch.from_numpy(rng.integers(1, hi, n)).to(w.device)
        val = torch.from_numpy(rng.integers(1, 2**31, n).astype(np.int32))
        w[b, idx] ^= val.to(w.device)
    return w


def splice_eob(words: torch.Tensor, bit: int, row: int, code: int,
               nbits: int) -> torch.Tensor:
    """A copy of ``words`` with the ``nbits``-bit EOB code written at
    absolute bit ``bit`` of ``row`` (LSB first)."""
    w = words.clone()
    for i in range(nbits):
        p = bit + i
        cur = int(w[row, p >> 5]) & 0xFFFFFFFF
        if (code >> i) & 1:
            cur |= 1 << (p & 31)
        else:
            cur &= ~(1 << (p & 31))
        w[row, p >> 5] = cur - (1 << 32) if cur >= 1 << 31 else cur
    return w


def mid_lane_bit(data: torch.Tensor, lengths: torch.Tensor, C: int, t,
                 starts: torch.Tensor, lane: int) -> int:
    """Absolute bit of a symbol boundary in the middle of ``lane``: where
    the first byte at or past the lane's middle that emits a symbol puts
    it."""
    from ..ops.assign_pack import assign_tokens, token_symbols

    B, N = data.shape
    S = N // C
    _v, nb, _x = assign_tokens(data, lengths, S, t)
    b, k = divmod(lane, C)
    nb = nb[b, k * S:(k + 1) * S]
    sym = token_symbols(data, lengths, S)[b, k * S:(k + 1) * S]
    j = S // 2 + int(torch.nonzero(sym[S // 2:] >= 0)[0, 0])
    return int(starts.reshape(-1)[lane]) + int(nb[:j].sum())


def k3_edge_cases(data: torch.Tensor, lengths: torch.Tensor, C: int):
    """K3's inputs from one K1 edge batch on its device, with the trained
    tree: [(label, words, chunk_starts, dtab, N, C, clean bytes or None)]
    for the clean streams, 64 words corrupted per stream, an EOB spliced
    into the middle of lane 1, random unordered chunk starts (wrong span
    hints) and, for S = 8, lanes of 4 bytes (K1's windows read 4 bytes,
    and random ordered starts)."""
    from ..parallel.device_pipeline import zlib_encode_step
    from ..trees import trained_tables

    dev = data.device
    t = trained_tables(str(dev))
    B, N = data.shape
    S = N // C
    words, tb, _ad, starts, _eof = zlib_encode_step(C)(data, lengths)
    cases = [("clean", words, starts, N, C, data),
             ("64 words corrupted per stream", corrupt_words(words, tb, 64, 3),
              starts, N, C, None)]
    if int(lengths[0]) > S + S // 2 + 8:
        bit = mid_lane_bit(data.cpu(), lengths.cpu(), C, trained_tables(),
                           starts.cpu(), 1)
        cases.append(("EOB spliced into lane 1",
                      splice_eob(words, bit, 0, t.eof_code, t.eof_bits),
                      starts, N, C, None))
    rng = np.random.default_rng(4)
    rand = rng.integers(0, int(tb.max()) + 64, (B, C)).astype(np.int32)
    cases.append(("random unordered starts", words,
                  torch.from_numpy(rand).to(dev), N, C, None))
    if S == 8:
        from ..ops.assign_pack import assign_pack

        win, _b = assign_pack(data, lengths, C, t)
        cases.append(("S = 4: K1's windows", win,
                      torch.zeros(win.shape[0], 1, dtype=torch.int32,
                                  device=dev), 4, 1, None))
        st = np.sort(rng.integers(0, int(tb.min()), (B, N // 4)), axis=1)
        cases.append(("S = 4: random ordered starts", words,
                      torch.from_numpy(st.astype(np.int32)).to(dev), N,
                      N // 4, None))
    return [(lab, w, s, t.dtab, n, c, want) for lab, w, s, n, c, want in cases]


def sep_decode_events(row, start: int, dtab, S: int):
    """K6's word steps (``csrc/lanes.cuh`` ``sep_serial``) over one lane of
    S bytes from absolute bit ``start`` of the stream row ``row`` (words,
    zero past its end) under the decode table ``dtab``: [(bit, word,
    sub-step, entry)] of every symbol it decodes."""
    row = [int(x) & 0xFFFFFFFF for x in row]
    tab = [int(x) for x in dtab]

    def peek(p):
        i, sh = p >> 5, p & 31
        lo = row[i] if 0 <= i < len(row) else 0
        hi = row[i + 1] if 0 <= i + 1 < len(row) else 0
        return ((lo | hi << 32) >> sh) & 0xFFFFFFFF

    events, pos, run = [], start, 0
    for u in range(S // 4):
        filled = 0
        for s in range(4):
            take = min(run, 4 - filled)
            filled, run = filled + take, run - take
            if filled == 4 or run:
                continue
            bits = peek(pos)
            e = tab[bits & 0xFFF]
            n, cls = (e >> 16) & 0x1F, (e >> 13) & 3
            events.append((pos, u, s, e))
            if cls == 0:
                filled += 1
            elif cls == 2:
                extra = (e >> 9) & 0xF
                run = (e & 0x1FF) + ((bits >> n) & ((1 << extra) - 1))
                n += extra + 1
            pos += n
        run -= min(run, 4 - filled)
    return events


def dec_tile_bytes(S: int) -> int:
    """Output bytes a K3/K6 group stages per tile for lanes of S bytes
    (``lanes.cuh`` ``dec_tile(dec_threads(S))``)."""
    m = 1
    while m < 32 and 64 * m < S:
        m *= 2
    return 2048 // (32 // m)


def k6_edge_cases(data: torch.Tensor, lengths: torch.Tensor, C: int, tree):
    """K6's inputs from one K1 edge batch on its device, encoded with the
    class-separated ``tree`` (``ops/septree``): [(label, words,
    chunk_starts, meta, vals, N, C, clean bytes or None)] for the clean
    streams (ragged ones meet their EOF token), 64 words corrupted per
    stream, an EOB spliced into lane 1 at a symbol its word decodes at
    sub-step 0, 1, 2 and 3 (past the lane's middle), at its first symbol,
    at the first symbol of its second staged tile and at its last symbol,
    and random unordered chunk starts."""
    from ..parallel.device_pipeline import zlib_encode_step
    from ..trees import profile_tables, sep_tables

    dev = data.device
    t = profile_tables(tree, str(dev))
    meta, vals = sep_tables(tree.lens, dev)
    B, N = data.shape
    S = N // C
    words, tb, _ad, starts, _eof = zlib_encode_step(C, tree=tree)(data, lengths)
    cases = [("clean", words, starts, data),
             ("64 words corrupted per stream", corrupt_words(words, tb, 64, 5),
              starts, None)]
    if int(lengths[0]) > 2 * S:
        st = int(starts[0, 1])
        ev = sep_decode_events(words[0].cpu().numpy(), st,
                               t.dtab.cpu().numpy(), S)
        at = {}
        for bit, u, s, _e in ev:
            if u >= S // 8:
                at.setdefault(f"sub-step {s}", bit)
        at["the lane's first symbol"] = ev[0][0]
        tile = dec_tile_bytes(S)
        if S > tile:
            at["its second tile's first symbol"] = ev[
                next(i for i, e in enumerate(ev) if 4 * e[1] >= tile)][0]
        at["the lane's last symbol"] = ev[-1][0]
        for where, bit in sorted(at.items()):
            cases.append((f"EOB spliced into lane 1 at {where}",
                          splice_eob(words, bit, 0, t.eof_code, t.eof_bits),
                          starts, None))
    rng = np.random.default_rng(7)
    rand = rng.integers(0, int(tb.max()) + 64, (B, C)).astype(np.int32)
    cases.append(("random unordered starts", words,
                  torch.from_numpy(rand).to(dev), None))
    return [(lab, w, s, meta, vals, N, C, want) for lab, w, s, want in cases]


def k9_noise_tokens(S: int, L: int, seed: int) -> torch.Tensor:
    """Random token words int32[L, S] at K9's edges: offsets over the whole
    13-bit range, negative ones included; offsets in [-64, 64) (pairs with
    wi == -1, whose hi lands in word 0); offsets at the top (words 255 and
    256); bit counts up to 31; one pair in eight empty (both counts 0)."""
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << 13, (L, S))
    nb = rng.integers(0, 32, (L, S))
    nb[np.repeat(rng.random((L, S // 2)) < 0.125, 2, axis=1)] = 0
    kind = rng.integers(0, 3, (L, S))
    rel = np.where(kind == 0, rng.integers(-8192, 8192, (L, S)),
                   np.where(kind == 1, rng.integers(-64, 64, (L, S)),
                            rng.integers(8100, 8192, (L, S))))
    tok = (v | (nb << 13) | (rel << 18)) & 0xFFFFFFFF
    return torch.from_numpy(tok.astype(np.uint32).view(np.int32))


K8_UNSAFE = ("literal above 255", "run of base 0", "run of base 2")


def k8_unsafe_packed(packed: torch.Tensor, kind: str) -> torch.Tensor:
    """K8's packed symbol table with every literal above 255, or every
    run's base set to 0 or 2 (``K8_UNSAFE``): tables K8's kernel must
    decode serially (``ops/decode2.canon_unsafe``)."""
    cls = packed >> 13
    if kind == "literal above 255":
        return torch.where(cls == 0, packed | 256, packed)
    base = {"run of base 0": 0, "run of base 2": 2}[kind]
    return torch.where(cls == 2, (packed & ~0x1FF) | base, packed)


def k5_cross_stream(a: bytes, b: bytes):
    """K5's candidates over two streams' concatenated words (``pad_words``),
    as ``try_foreign_batch`` validates a batch: every bit from 96 bits
    before the end of ``a``'s payload to the end of its padded words
    (candidates that would read ``b``'s words but for their own word end),
    then ``b``'s stage-1 survivors and its first 400 bits.  Returns (words
    int32[W], cands, wend, n_bits int64[L], parts): each part (lo, hi,
    stream, its candidates stream-local, its first bit) the candidates
    [lo, hi) of one stream, CPU tensors."""
    from ..ops.inflate import pad_words
    from ..parallel.discovery import scan_stage1_device

    words, base = pad_words([a, b])
    ca = np.arange(max(0, len(a) * 8 - 96), int(base[1]) * 32, dtype=np.int64)
    cb = np.unique(np.concatenate([scan_stage1_device(b, device="cpu"),
                                   np.arange(0, 400)])).astype(np.int64)
    n = [len(ca), len(cb)]
    col = torch.from_numpy
    return (col(words), col(np.concatenate([ca, cb + base[1] * 32])),
            col(np.repeat(base[1:], n)),
            col(np.repeat([len(a) * 8, base[1] * 32 + len(b) * 8], n)),
            [(0, n[0], a, ca, 0), (n[0], n[0] + n[1], b, cb, int(base[1]) * 32)])


def _k2_case(label, rng, bits, header, extra_words):
    """K2's inputs from per-lane payload bits [B, C] and per-stream header
    bits: windows of random payload bits, zero past each lane's bits, the
    lanes placed one after another from the header (``lane_starts``'s
    order), W the words the payload reaches plus ``extra_words``."""
    bits = np.asarray(bits, np.int64)
    B, C = bits.shape
    flat = bits.reshape(-1)
    ww = max(1, int(((flat + 31) >> 5).max())) + 2
    keep = np.clip(flat[:, None] - 32 * np.arange(ww)[None, :], 0, 32)
    mask = (np.left_shift(np.uint64(1), keep.astype(np.uint64))
            - np.uint64(1)).astype(np.uint64)
    raw = rng.integers(0, 2**32, (B * C, ww), dtype=np.uint64) & mask
    win = raw.astype(np.uint32).view(np.int32)
    header = np.asarray(header, np.int64)
    pos0 = header[:, None] + np.cumsum(bits, axis=1) - bits
    W = int((int((header + bits.sum(axis=1)).max()) + 31) >> 5) + extra_words
    return (label, torch.from_numpy(np.ascontiguousarray(win)),
            torch.from_numpy(flat.astype(np.int32)),
            torch.from_numpy(pos0.reshape(-1).astype(np.int32)), B, W)


def k2_edge_cases():
    """[(label, win int32[L, wwin], chunk_bits int32[L], pos0 int32[L], B,
    W)] (CPU tensors): lanes of 0 bits (the first and the last of a stream
    among them), lanes shorter than a word (three or more lanes in one
    output word), word-aligned starts (pos0 & 31 == 0), the last payload
    word's high half landing at word W, trailing words past the payload
    (more than two of K2's 4096-word zero-fill pieces), and a random mix
    of short and long lanes."""
    rng = np.random.default_rng(60)
    zero = rng.integers(1, 300, (3, 24))
    zero[:, ::3] = 0
    zero[:, 0] = zero[:, -1] = 0
    zero[1] = 0                                  # a stream of no payload
    mix = rng.choice([0, 1, 7, 31, 32, 33, 64, 95, 1000, 4099], (4, 32))
    return [
        _k2_case("lanes of 0 bits, an empty stream", rng, zero, [37, 0, 64], 3),
        _k2_case("lanes shorter than a word", rng,
                 rng.integers(0, 13, (2, 96)), [5, 31], 0),
        _k2_case("word-aligned starts", rng,
                 32 * rng.integers(0, 9, (2, 16)), [0, 64], 0),
        _k2_case("last word's high half at W", rng,
                 rng.integers(40, 700, (3, 8)), [3, 17, 29], 0),
        _k2_case("trailing words past the payload, over several pieces",
                 rng, rng.integers(0, 500, (2, 8)), [32037 % 97, 11], 9001),
        _k2_case("random mix of short and long lanes", rng, mix,
                 rng.integers(0, 200, 4), 1),
    ]


def _blocked_stream(data: bytes, level: int, strategy: int, every: int):
    """zlib stream of ``data`` with a block ended (``Z_BLOCK``) after every
    ``every`` input bytes: a few thousand records per block."""
    import zlib

    co = zlib.compressobj(level, zlib.DEFLATED, 15, 9, strategy)
    out = [co.compress(data[i:i + every]) + co.flush(zlib.Z_BLOCK)
           for i in range(0, len(data), every)]
    return b"".join(out) + co.flush()


def k4_streams():
    """The zlib streams of K4's edge inputs: text at levels 1, 6 and 9,
    IDAT bytes at level 1 and text with Huffman coding only (every record
    a pair of literals where it can be), blocks ended every 2-3 KB."""
    import zlib

    rng = np.random.default_rng(61)
    words = [rng.bytes(int(rng.integers(2, 10))) for _ in range(120)]
    text = b"".join(words[int(rng.integers(120))] for _ in range(2500))[:12000]
    idat = make_idat_corpus(1, 9000, seed=62)[0].tobytes()
    return [
        ("text, level 1", _blocked_stream(text, 1, zlib.Z_DEFAULT_STRATEGY, 2500)),
        ("text, level 6", _blocked_stream(text, 6, zlib.Z_DEFAULT_STRATEGY, 3000)),
        ("text, level 9", _blocked_stream(text, 9, zlib.Z_DEFAULT_STRATEGY, 2000)),
        ("IDAT, level 1", _blocked_stream(idat, 1, zlib.Z_DEFAULT_STRATEGY, 3000)),
        ("text, Huffman only", _blocked_stream(text, 6, zlib.Z_HUFFMAN_ONLY, 3000)),
    ]


K4_KINDS = ("blocks", "corrupted words", "slots run out", "too far",
            "bit_end mid-block", "false starts")


def k4_edge_case(kind: str):
    """K4's inputs of one kind, on the CPU: (args = (words, start, wend,
    bit_end, out0, meta, tab), K).  Every lane block discovery finds in
    the ``k4_streams`` (its false candidates included), over the
    concatenated stream words as ``try_foreign_batch`` lays them out, and:
    as they are; with words corrupted; with too few record slots (done 0);
    with out0 = 0, so a match reaching before the block is too far (5);
    with bit_end inside each block (4); or started at random bits, some
    with no distance codes (3) or under the fixed code whose symbols
    286/287 are invalid (2)."""
    from ..ops.inflate import pad_words
    from ..ops.inflate_host import _fixed_foreign_meta
    from ..ops.inflate_records import NO_LIMIT, block_tables, pack_tables
    from ..parallel.discovery import _parse_lanes, find_block_boundaries

    streams = [z for _label, z in k4_streams()]
    words, base = pad_words(streams)
    rng = np.random.default_rng(63 + K4_KINDS.index(kind))
    rows = []
    for si, z in enumerate(streams):
        found = _parse_lanes(z, find_block_boundaries(z, device="cpu")[0])
        if found is not None:
            rows += [(si, lane[2], tabs, *lane[3:])
                     for lane, tabs in zip(found[0], found[1])]
    if kind == "false starts":
        picked = []
        for _ in range(48):
            si, _s, tabs, lengths, hlit = rows[int(rng.integers(len(rows)))]
            r = rng.random()
            if r < 0.3:
                nodist = lengths.copy()
                nodist[288:320] = 0
                tabs = block_tables(nodist, hlit)
            elif r < 0.5:   # symbols 286/287 are invalid codes here
                tabs = _fixed_foreign_meta()
            picked.append((si, int(rng.integers(0, len(streams[si]) * 8)),
                           tabs, lengths, hlit))
        rows = sorted(picked, key=lambda r: (r[0], r[1]))
    L = len(rows)
    start = np.array([base[si] * 32 + s for si, s, *_ in rows], np.int64)
    wend = np.array([base[si + 1] for si, *_ in rows], np.int64)
    bit_end = np.array([base[si] * 32 + len(streams[si]) * 8
                        for si, *_ in rows], np.int64)
    out0 = np.full(L, NO_LIMIT, np.int64)
    K = 4096
    if kind == "corrupted words":
        idx = rng.integers(4, len(words) - 4, len(words) // 300)
        words = words.copy()
        words[idx] ^= rng.integers(1, 2**31, idx.size).astype(np.int32)
    elif kind == "slots run out":
        K = 96
    elif kind == "too far":
        out0[:] = 0
    elif kind == "bit_end mid-block":
        bit_end = start + rng.integers(1, 12000, L)
    meta, tab = pack_tables([r[2] for r in rows], "cpu")
    col = torch.from_numpy
    return (col(words), col(start), col(wend), col(bit_end), col(out0), meta,
            tab), K


# ---- K12 header_tables -----------------------------------------------------

# A complete code over the 19 code-length symbols: 13 of 4 bits, 6 of 5.
_CL_LENS = np.array([4] * 13 + [5] * 6, np.int64)
_REP_BITS = {16: 2, 17: 3, 18: 7}


def _sections(lengths):
    """RFC 1951's code-length sections of ``lengths``: [(symbol, extra)],
    zero runs as 17/18 and runs of a length as 16 after its first."""
    out, i, n = [], 0, len(lengths)
    while i < n:
        v = int(lengths[i])
        run = 1
        while i + run < n and int(lengths[i + run]) == v:
            run += 1
        if v == 0 and run >= 11:
            k = min(run, 138)
            out.append((18, k - 11))
        elif v == 0 and run >= 3:
            k = min(run, 10)
            out.append((17, k - 3))
        else:
            out.append((v, 0))
            k = 1
            while run - k >= 3:
                r = min(run - k, 6)
                out.append((16, r - 3))
                k += r
        i += k
    return out


def _header_bits(lit, dist, *, btype=2, hlit=None, hdist=None, cl=_CL_LENS,
                 sections=None):
    """A dynamic block header as (value, bits), LSB first: BFINAL 1,
    ``btype``, HLIT, HDIST (``hlit`` / ``hdist`` or the lengths' counts),
    HCLEN 19 and the ``cl`` code-length code lengths, then ``sections``
    (or ``_sections`` of the lengths) under that code."""
    from ..tables import CLCL_ORDER, canonical_codes

    hlit = len(lit) if hlit is None else hlit
    hdist = len(dist) if hdist is None else hdist
    fields = [(1, 1), (btype, 2), (hlit - 257, 5), (hdist - 1, 5), (15, 4)]
    fields += [(int(cl[s]), 3) for s in CLCL_ORDER]
    if sections is None:
        sections = _sections(list(lit) + list(dist))
    codes = canonical_codes(cl) if sections else None
    for sym, extra in sections:
        fields.append((int(codes[sym]), int(cl[sym])))
        if sym >= 16:
            fields.append((extra, _REP_BITS[sym]))
    value, n = 0, 0
    for v, k in fields:
        value |= (v & ((1 << k) - 1)) << n
        n += k
    return value, n


def k12_headers():
    """[(label, (value, bits) of the header, status, (lit, dist) or None)]:
    K12's crafted headers, each with the status ``header_tables`` gives
    it (0 a lane, 1 skipped, 2 dropped) and, for a lane, the code lengths
    whose ``foreign_meta`` its tables are.  The lanes with a single
    distance code of 2, 3 or 5 bits are trees the host's own rule refuses
    (``host_ok`` 0, ``BadDistanceHuffmanTree``); one of 1 bit it takes."""
    lit = [8] * 254 + [9] * 4                    # 258 symbols, complete
    runs = [7] * 127 + [0] * 129 + [8, 8]        # a zero run of 129
    two, one, none = [1, 1], [0, 0, 3], [0]
    one1, one2, one5 = [0, 1], [0, 2], [0, 0, 0, 0, 5]
    # a 17, then a 16 that repeats 0 (RFC 1951; K5 repeats the last 7)
    after17 = ([(7, 0)] + [(16, 3)] * 21 + [(17, 7), (16, 3), (18, 102)]
               + [(8, 0), (8, 0)] + _sections(two))
    incomplete_cl = np.zeros(19, np.int64)
    incomplete_cl[[0, 8]] = 2
    cases = [
        ("two distance codes", _header_bits(lit, two), 0, (lit, two)),
        ("one distance code", _header_bits(lit, one), 0, (lit, one)),
        ("no distance code", _header_bits(lit, none), 0, (lit, none)),
        ("a single 1-bit distance code", _header_bits(lit, one1), 0,
         (lit, one1)),
        ("a single 2-bit distance code", _header_bits(lit, one2), 0,
         (lit, one2)),
        ("a single 5-bit distance code", _header_bits(lit, one5), 0,
         (lit, one5)),
        ("runs of 16, 17 and 18", _header_bits(runs, [2, 0, 0, 2, 2, 0, 2]),
         0, (runs, [2, 0, 0, 2, 2, 0, 2])),
        ("a 16 after a 17 repeats 0",
         _header_bits(runs, two, sections=after17), 0, (runs, two)),
        ("BTYPE 1", _header_bits(lit, two, btype=1), 1, None),
        ("HLIT 287", _header_bits(lit, two, hlit=287, sections=[]), 1, None),
        ("HDIST 31", _header_bits(lit, two, hdist=31, sections=[]), 1, None),
        ("incomplete code-length code",
         _header_bits(lit, two, cl=incomplete_cl, sections=[]), 1, None),
        ("a 16 first", _header_bits(lit, two, sections=[(16, 0)]
                                    + _sections(lit + two)), 1, None),
        ("a repeat past the end",
         _header_bits(lit, two, sections=_sections(lit) + [(18, 127)]), 1,
         None),
        ("no end-of-block code", _header_bits([8] * 256 + [0, 0], two), 1,
         None),
        ("incomplete literal/length code",
         _header_bits([8] * 254 + [9] * 3 + [0], two), 2, None),
    ]
    return cases


def k12_edge_case():
    """K12's inputs on the CPU: (words, offs, wend, bit_end, labels, status,
    tables).  Each crafted header (``k12_headers``) is a stream of its own,
    at bit 5 of it, with a few random bytes after it; three more take the
    first header cut 3 bits before its end, 2 bits after it (6 bits left
    before its last section, a 4-bit code: the parse wants 7) and inside
    its HLIT field (status 1).  ``tables`` holds each lane's (lit, dist) lengths, else
    None."""
    from ..ops.inflate import pad_words

    rng = np.random.default_rng(64)
    cases = k12_headers()
    value, n = cases[0][1]
    cases += [("truncated in its sections", (value, n), 1, None, n - 3),
              ("6 bits left before its last section", (value, n), 1, None,
               n + 2),
              ("truncated in its fields", (value, n), 1, None, 10)]
    streams = []
    for case in cases:
        value, n = case[1]
        value = (value << 5) | int(rng.integers(0, 32))
        nbytes = (n + 5 + 7) // 8
        streams.append(value.to_bytes(nbytes, "little") + rng.bytes(8))
    words, base = pad_words(streams)
    offs = np.asarray(base[:-1], np.int64) * 32 + 5
    bit_end = np.array([o + (c[4] if len(c) > 4 else 8 * len(s) - 5)
                        for o, c, s in zip(offs, cases, streams)], np.int64)
    col = torch.from_numpy
    return (col(words), col(offs), col(np.asarray(base[1:], np.int64)),
            col(bit_end), [c[0] for c in cases], [c[2] for c in cases],
            [c[3] for c in cases])


# Crafted headers of ``k12_headers`` that a stream must not get past, and the
# error class the host's parse gives each.
BAD_HEADERS = {
    "incomplete code-length code": "BadCodeLengthHuffmanTree",
    "HLIT 287": "InvalidHlit",
    "a 16 first": "InvalidCodeLengthRepeat",
    "no end-of-block code": "BadLiteralLengthHuffmanTree",
    "incomplete literal/length code": "BadCodeLengthHuffmanTree",
    "a single 2-bit distance code": "BadDistanceHuffmanTree",
}


def bad_header_streams(data: bytes, seed: int = 26):
    """{label: (zlib stream, error class)}: each of ``BAD_HEADERS`` as a
    stream's first block (bit 16) and after a good dynamic block of
    ``data`` and an empty stored block (so that a second round of the
    sequential path meets it), random bytes after it; and a good header cut
    in its fields and in its sections, the stream's last bits
    (``InsufficientInput``)."""
    rng = np.random.default_rng(seed)
    headers = {label: bits for label, bits, _st, _l in k12_headers()}
    co = zlib.compressobj(6)
    prefix = co.compress(data) + co.flush(zlib.Z_SYNC_FLUSH)
    out = {}
    for label, cls in BAD_HEADERS.items():
        value, n = headers[label]
        block = value.to_bytes((n + 7) // 8, "little") + rng.bytes(16)
        out[f"{label}, first"] = (b"\x78\x9c" + block, cls)
        out[f"{label}, second"] = (prefix + block, cls)
    value, n = headers["two distance codes"]
    good = value.to_bytes((n + 7) // 8, "little")
    out["a header cut in its fields"] = (prefix + good[:1],
                                         "InsufficientInput")
    out["a header cut in its sections"] = (prefix + good[: n // 16],
                                           "InsufficientInput")
    return out


# ---- K11 decode_symbols ----------------------------------------------------


def _long_code_lengths(n: int, top: int) -> np.ndarray:
    """A complete code over n symbols whose lengths spread from 1 to 15
    (the length-limited DP on geometric frequencies): many codes longer
    than the primary table's bits, so secondary tables are in use."""
    from ..huffman import compute_code_lengths

    freqs = np.maximum(1, 2.0 ** (top - top * np.arange(n) / n)).astype(np.uint64)
    return compute_code_lengths(freqs, np.ones(n, np.int64),
                                np.full(n, 15, np.int64))


def symbol_stream(ll_lengths, d_lengths, nsym: int, seed: int,
                  match_share: float = 0.3) -> bytes:
    """Random symbols under the code of ``ll_lengths`` (288) and
    ``d_lengths`` (32), drawn uniformly over the coded valid symbols (not
    distance symbols 30/31), so long codes are as common as short ones,
    with random extra bits, then the end of block; LSB first, no
    header."""
    from ..tables import (DIST_SYM_TO_DIST_EXTRA, LEN_SYM_TO_LEN_EXTRA,
                          canonical_codes)

    rng = np.random.default_rng(seed)
    ll_codes = canonical_codes(ll_lengths)
    d_codes = canonical_codes(d_lengths)
    lits = [s for s in np.nonzero(ll_lengths)[0] if s < 256]
    lens = [s for s in np.nonzero(ll_lengths)[0] if 257 <= s <= 285]
    dists = [s for s in np.nonzero(d_lengths)[0] if s < 30]
    acc, nbits = 0, 0

    def put(v: int, n: int):
        nonlocal acc, nbits
        n = int(n)
        acc |= (int(v) & ((1 << n) - 1)) << nbits
        nbits += n

    for _ in range(nsym):
        if lens and dists and rng.random() < match_share:
            s = int(lens[int(rng.integers(len(lens)))])
            put(ll_codes[s], ll_lengths[s])
            ex = int(LEN_SYM_TO_LEN_EXTRA[s - 257]) if s < 286 else 0
            put(int(rng.integers(1 << ex)), ex)
            ds = int(dists[int(rng.integers(len(dists)))])
            put(d_codes[ds], d_lengths[ds])
            ex = int(DIST_SYM_TO_DIST_EXTRA[ds]) if ds < 30 else 0
            put(int(rng.integers(1 << ex)), ex)
        else:
            s = int(lits[int(rng.integers(len(lits)))])
            put(ll_codes[s], ll_lengths[s])
    put(ll_codes[256], ll_lengths[256])
    return acc.to_bytes((nbits + 7) // 8 + 4, "little")


def _stream_words(z: bytes, W: int | None = None) -> torch.Tensor:
    padded = z + bytes((-len(z)) % 4) + bytes(8)
    w = np.frombuffer(padded, "<u4").view(np.int32)
    return torch.from_numpy(w[:W].copy())


def k11_tables():
    """Reference decode tables of K11's edge inputs: (litlen u32[4096],
    litlen_sec, dist u32[512], dist_sec, first_len i32[4096], ll_lengths,
    d_lengths) for a code of long literal/length codes (secondary tables
    of both trees; distance symbols 30 and 31 coded, so invalid) and for
    the fixed code."""
    from ..huffman import build_table
    from ..ops.decode_symbols import tables_from_lengths
    from ..tables import FIXED_CODE_LENGTHS, LITLEN_TABLE_ENTRIES

    ll = np.zeros(288, np.int64)
    ll[:286] = _long_code_lengths(286, 14)
    d = _long_code_lengths(32, 15)
    fixed = np.asarray(FIXED_CODE_LENGTHS, np.int64)
    out = {}
    for name, (lls, ds) in {"long codes": (ll, d),
                            "fixed": (fixed[:288], fixed[288:320])}.items():
        lengths = np.zeros(320, np.int64)
        lengths[:288] = lls
        lengths[288:320] = ds
        t = tables_from_lengths(lengths, 288)
        first = build_table(lls, LITLEN_TABLE_ENTRIES, 4096,
                            is_distance_table=False,
                            double_literal=True).first_len.astype(np.int32)
        out[name] = (*t, first, lls, ds)
    return out


K11_KINDS = ("long codes", "truncated", "fixed code, corrupted",
             "invalid and garbage entries", "stacked tables", "steps run out",
             "split at bit_stop")


def k11_edge_case(kind: str) -> dict:
    """K11's inputs of one kind, on the CPU, as ``decode_symbols``
    keywords (tables as numpy arrays): lanes started at the symbol stream's
    first bit and at random bits (not symbol boundaries), with ``bit_stop``
    inside the stream for some, ``out_pos`` 0 for some (a distance too far
    back), some inactive, and:
      * "long codes": a stream of codes of 1-15 bits (secondary tables);
      * "truncated": the same with ``bit_end`` inside it, and lanes reading
        a row cut short (reads past its last word);
      * "fixed code, corrupted": the fixed code, words corrupted (distance
        symbols 30/31, literal/length 286/287), and lanes that end at an
        invalid code given a ``bit_end`` inside that code (truncation
        wins);
      * "invalid and garbage entries": table entries replaced by the
        invalid entry (EXCEPTIONAL_ENTRY, 0 bits) and by random 32-bit
        words (code lengths and extra bits past 31, flags together);
      * "stacked tables": both tables and the trained one stacked (T = 3)
        with ``table_id`` and two rows read through ``stream_row``;
      * "steps run out": every lane at the first bit, 24 steps (OK);
      * "split at bit_stop": the chunk lanes of the indexed codec (trained
        tables, ``litlen_first``, chain 1) over bytes whose literal codes
        are mostly 3-5 bits, so a lane's last double-literal entry often
        holds the next lane's first symbol and is split.
    ``chain`` cycles 4, 2, 1 over the kinds."""
    from ..ops.decode_symbols import stack_tables
    from ..tables import EXCEPTIONAL_ENTRY, HUFFMAN_LENGTHS

    i = K11_KINDS.index(kind)
    rng = np.random.default_rng(110 + i)
    if kind == "split at bit_stop":
        return _k11_split_case(rng)
    tabs = k11_tables()
    name = "fixed" if kind == "fixed code, corrupted" else "long codes"
    ll_t, ls_t, d_t, ds_t, first, lls, ds = tabs[name]
    z = symbol_stream(lls, ds, 900, 120 + i)
    words = _stream_words(z)[None, :]
    nbits = len(z) * 8
    L = 32
    max_steps = 24 if kind == "steps run out" else 640
    chain = (4, 2, 1)[i % 3]
    bit_pos = rng.integers(0, nbits, L)
    bit_pos[:4] = 0
    if kind == "steps run out":
        bit_pos[:] = 0
    bit_end = np.full(L, nbits)
    stop = np.where(rng.random(L) < 0.5, bit_pos + rng.integers(1, 3000, L),
                    0x7FFFFFFF)
    out_pos = np.where(rng.random(L) < 0.25, 0, 1 << 30)
    active = rng.random(L) < 0.9
    active[0] = True
    table_id = np.zeros(L, np.int32)
    rows = None
    if kind == "truncated":
        # The words stop halfway through the stream: a lane that reads past
        # the last word reads it again (JAX's load_word clamps), and runs
        # out of bits at bit_end, inside the stream or past the words.
        words = words[:, : words.shape[1] // 2].clone()
        bit_end = np.where(rng.random(L) < 0.5, nbits,
                           bit_pos + rng.integers(0, 2000, L))
    if kind == "fixed code, corrupted":
        idx = rng.integers(0, words.shape[1] - 2, words.shape[1] // 12)
        words = words.clone()
        words[0, idx] ^= torch.from_numpy(
            rng.integers(1, 2**31, idx.size).astype(np.int32))
    if kind == "invalid and garbage entries":
        ll_t, d_t = ll_t.copy(), d_t.copy()
        ll_t[rng.integers(0, 4096, 60)] = EXCEPTIONAL_ENTRY
        ll_t[rng.integers(0, 4096, 150)] = rng.integers(0, 2**32, 150)
        # length entries with code lengths and extra bits past 31
        ll_t[rng.integers(0, 4096, 150)] = rng.integers(0, 2**32, 150) & ~0xC000
        # lane 0's first symbol: a length entry of 3 bits with 40 extra
        # bits, whose mask is all ones (XLA's 1 << 40 is 0)
        ll_t[int(words[0, 0]) & 4095] = (100 << 16) | (40 << 8) | 3
        out_pos[0], stop[0] = 1 << 30, 0x7FFFFFFF
        d_t[rng.integers(0, 512, 40)] = rng.integers(0, 2**32, 40)
    litlen, lsec, dist, dsec = (x[None] if x.ndim == 1 else x for x in
                                stack_tables([(ll_t, ls_t, d_t, ds_t)]))
    first = first[None]
    if kind == "stacked tables":
        from ..huffman import build_table
        from ..ops.decode_symbols import tables_from_lengths
        from ..tables import LITLEN_TABLE_ENTRIES

        fx = tabs["fixed"]
        trained = np.zeros(320, np.int64)
        trained[:286] = HUFFMAN_LENGTHS
        trained[288] = 1
        tt = tables_from_lengths(trained, 286)
        t_first = build_table(HUFFMAN_LENGTHS, LITLEN_TABLE_ENTRIES, 4096,
                              is_distance_table=False,
                              double_literal=True).first_len.astype(np.int32)
        litlen, lsec, dist, dsec = stack_tables(
            [(ll_t, ls_t, d_t, ds_t), fx[:4], tt])
        first = np.stack([tabs["long codes"][4], fx[4], t_first])
        z2 = symbol_stream(fx[5], fx[6], 700, 130)
        w2 = _stream_words(z2)
        W = max(words.shape[1], w2.numel())
        both = torch.zeros((2, W), dtype=torch.int32)
        both[0, : words.shape[1]] = words[0]
        both[1, : w2.numel()] = w2
        words = both
        rows = rng.integers(0, 2, L)
        table_id = np.where(rows == 1, 1, 2 * rng.integers(0, 2, L))
        bit_end = np.where(rows == 1, len(z2) * 8, bit_end)
        bit_pos = np.minimum(bit_pos, bit_end - 1)
    col = lambda a, dt=torch.int32: torch.from_numpy(np.asarray(a)).to(dt)
    if kind == "fixed code, corrupted":
        # Lanes that stop at an invalid distance code stop again with their
        # bit_end 6 bits past the code's start: the code is also truncated.
        from ..ops.decode_symbols import ERR_DIST, decode_symbols

        _rec, (bp, _op, st) = decode_symbols(
            words, col(bit_pos), col(bit_end), col(out_pos),
            col(active, torch.bool), col(table_id), litlen, lsec, dist, dsec,
            max_steps, bit_stop=col(stop), chain=chain, litlen_first=first)
        cut = (st.numpy() == ERR_DIST) & (np.arange(L) % 2 == 0)
        bit_end = np.where(cut, bp.numpy() + 6, bit_end)
    return dict(
        words=words, bit_pos=col(bit_pos), bit_end=col(bit_end),
        out_pos=col(out_pos), active=col(active, torch.bool),
        table_id=col(table_id), litlen=litlen, litlen_sec=lsec, dist=dist,
        dist_sec=dsec, max_steps=max_steps, bit_stop=col(stop), chain=chain,
        stream_row=None if rows is None else col(rows), litlen_first=first)


def _k11_split_case(rng) -> dict:
    """The chunk lanes of 3 x 4096 bytes of short-code literals, C = 16;
    a few long-code literals (byte 128) break the pairs, so a lane's
    symbols before the next lane's start are not always an even count."""
    from ..ops.ultrafast import encode_ultrafast_batch
    from ..parallel.device_pipeline import chunk_lanes, trained_symbol_tables

    B, N, C = 3, 4096, 16
    data = torch.from_numpy(rng.choice(
        np.array([1, 2, 3, 253, 254, 255, 128], np.uint8), (B, N),
        p=[0.16] * 6 + [0.04]))
    words, total_bits, _adler, index = encode_ultrafast_batch(
        data, torch.full((B,), N, dtype=torch.int32), num_chunks=C)
    starts, bits_l, stops, srow, active = chunk_lanes(total_bits, index)
    t = trained_symbol_tables("cpu")
    return dict(
        words=words, bit_pos=starts, bit_end=bits_l,
        out_pos=torch.full_like(starts, 1 << 30), active=active,
        table_id=torch.zeros_like(starts), litlen=t[0], litlen_sec=t[1],
        dist=t[2], dist_sec=t[3], max_steps=1024, bit_stop=stops, chain=1,
        stream_row=srow, litlen_first=t[4])
