"""Block-parallel decode of foreign zlib streams (no chunk index).

JAX counterpart: ``fdeflate_tpu/parallel/discovery.py`` — the device path
of ``find_block_boundaries`` (``scan_stage1_device``,
``validate_stage2_device``), its scan and header parse, ``stage_words``,
``_pallas_lane_decode``, ``try_foreign`` with ``_jit_stitch``,
``try_foreign_batch`` with ``_jit_stitch_batch``, ``decompress_foreign``,
and the routing of ``ops/inflate.decompress_batch``, which sits here so
that ``ops/`` does not import ``parallel/``.  Where JAX writes the
discovery twice, for one stream and for a batch, the port runs one
pipeline (``_discover``): ``try_foreign`` is it on one stream.

Every bit offset of the stream is screened as a possible dynamic-block
header (stage 1, elementwise torch over all offsets); the survivors' code
length sections are decoded by K5 (stage 2, ``ops/validate_headers.py``;
one launch for all streams of a batch);
K12 (``ops/header_tables.py``, one launch for all streams) parses each
validated header and builds its tables on the device, where they stay for
K4, and the host reads back each header's status, BFINAL and symbol start;
a header whose trees cannot be built is no lane (a false header K5 let
through: only a chain that needs its offset breaks there); K4
(``ops/inflate_records.py``) decodes every
candidate block in its own lane, reading straight from the stream words;
the host walks the chain of blocks whose end-of-block exit is the next
confirmed header; one materialize and an Adler-32 on the device finish the
stream.  A stream the chain cannot cover (a stored or fixed block, a
false boundary, a block over the record budget) returns None, and
``decompress_foreign`` falls back to the sequential path.

Each stage runs inside its span (``utils/profiling.span``:
``discovery.stage1``, ``.validate``, ``.parse``, ``.tables`` (twice: the
lanes' rows taken, then their per-lane inputs uploaded), ``.records``,
``.chain``, ``.stitch``; ``inflate.batch`` around
``decompress_batch``), from its first operation until its results are on
the host, so a wait on the device falls in the stage that caused it; the
stage spans do not nest.  Counters: ``discovery.streams`` (streams
entering ``try_foreign`` / ``try_foreign_batch``), ``discovery.lanes``
(lanes handed to K4), ``discovery.lanes_chained`` (lanes a walked chain
used), ``discovery.headers`` (headers handed to K12: lanes, dropped and
skipped), ``discovery.lanes_dropped`` (headers dropped for their trees),
``inflate.calls`` (calls of ``decompress_batch``) and one
``discovery.fallback.<reason>`` per stream left to the sequential path:
``header`` (too short, or not a zlib deflate header), ``first_block`` (no
dynamic header at bit 16), ``tables`` (the chain stopped at a header
dropped for its trees, bit 16 included), ``budget`` (the chain stopped at
a lane that ran out of record slots before its EOB: a block longer than a
lane's budget, ``lane_budget``), ``chain`` (any other break),
``checksum`` (a distance before the stream's start, or an Adler-32
mismatch; with ``materialize="host"``, also records the native backend
cannot expand).

On CPU tensors stage 1 runs the same torch code and K4, K5 and K12 their
plain versions.  ``try_foreign(materialize="host")`` expands the chain's K4
records on the host with the native C++ backend (``models/native.py``)
instead of the device stitch.
"""

from __future__ import annotations

import os
import zlib

import numpy as np
import torch

from .. import errors as E
from ..models import native
from ..ops import inflate_host as host
from ..ops.adler32 import adler32_batch
from ..ops.header_tables import DROPPED, LANE, header_tables, parse_header
from ..ops.inflate import (
    WINDOW,
    decompress_sequential,
    flat_records,
    materialize_flat,
    pad_words,
)
from ..ops.inflate_records import (
    DONE_EOB,
    DONE_SLOTS,
    NO_LIMIT,
    inflate_records,
    recs_to_records,
)
from ..ops.ultrafast import device_of
from ..ops.validate_headers import validate_headers
from ..utils.profiling import count, span

_MAXCL = 7
_PARALLEL_MIN = 49152   # decompress_batch's threshold for block discovery


def _zlib_header_ok(data: bytes) -> bool:
    """CMF/FLG of a deflate zlib stream with no preset dictionary."""
    cmf, flg = data[0], data[1]
    return cmf & 0x0F == 0x08 and ((cmf << 8) | flg) % 31 == 0 and not flg & 0x20


def stage_words(data: bytes, *, device) -> torch.Tensor:
    """The stream's little-endian words, padded to a word and by 8 zero
    bytes, as int32 on ``device`` (upload once for repeated
    ``try_foreign(..., words_dev=...)``)."""
    words, _base = pad_words([data])
    return torch.from_numpy(words).to(device_of(device))


def scan_stage1_device(payload: bytes, min_tail_bits: int = 400, *,
                       device, words=None) -> np.ndarray:
    """Stage 1 over every bit offset below ``len * 8 - min_tail_bits``
    (JAX ``_jit_stage1``): BTYPE dynamic, HLIT/HDIST bounds, and an exact
    Kraft-complete code-length code with at least two codes.

    Shifted-slice elementwise math over an int8 bit array (int8/int16
    temporaries), then cumsum compaction (an int32 cumsum, searched for
    each survivor's rank).  JAX compacts into a fixed number of slots and
    redoes the scan exactly on the host when more survive; here every
    survivor is kept, which is that result.  Returns the sorted offsets,
    int64.
    """
    n_bits = len(payload) * 8 - min_tail_bits
    if n_bits <= 0:
        return np.zeros(0, np.int64)
    with span("discovery.stage1"):
        dev = device_of(device)
        if words is None:
            words = stage_words(payload, device=dev)
        data = words.reshape(-1).view(torch.uint8)[: len(payload)]
        shifts = torch.arange(8, dtype=torch.uint8, device=dev)
        bits = ((data[:, None] >> shifts) & 1).reshape(-1).to(torch.int8)
        i8, i16 = torch.int8, torch.int16

        def sl(k):
            return bits[k: k + n_bits]

        def field(k, w, dtype=i8):
            v = sl(k).to(dtype)
            for j in range(1, w):
                v = v | (sl(k + j).to(dtype) << j)
            return v

        ok = (sl(1) == 0) & (sl(2) == 1)
        ok &= (field(3, 5) <= 29) & (field(8, 5) <= 29)
        ncl = field(13, 4) + 4
        kraft = torch.zeros(n_bits, dtype=i16, device=dev)
        nz = torch.zeros(n_bits, dtype=i8, device=dev)
        for j in range(19):
            cl = field(17 + 3 * j, 3, i16)
            use = (ncl > j) & (cl > 0)
            kraft += torch.where(use, (1 << _MAXCL) >> cl, 0).to(i16)
            nz += use.to(i8)
        ok &= (kraft == 1 << _MAXCL) & (nz >= 2)

        csum = ok.to(torch.int32).cumsum(0, dtype=torch.int32)
        want = torch.arange(1, int(csum[-1]) + 1, dtype=torch.int32,
                            device=dev)
        offs = torch.searchsorted(csum, want)
        return offs.cpu().numpy().astype(np.int64)


def validate_stage2_device(payload: bytes, cands: np.ndarray,
                           words_dev=None, *, device):
    """Stage 2: K5 over the stage-1 survivors (``validate_stage2_batch`` on
    one stream).  Returns (offsets, header_end_bits) of the valid headers,
    int64, sorted (JAX ``validate_stage2_device``, equal to the numpy
    ``validate_stage2``)."""
    if len(cands) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    if words_dev is None:
        words_dev = stage_words(payload, device=device)
    return validate_stage2_batch([payload], {0: cands}, words_dev,
                                 [0, words_dev.numel()])[0]


def stage2_batch_inputs(streams: list[bytes], cands: dict, word_base):
    """K5's inputs for the stage-1 survivors of several streams over their
    concatenated words (``pad_words``' ``word_base``): ``cands`` maps a
    stream's index to its survivors (stream-local bits).  Returns int64[3,
    L] rows (absolute candidate bits, each candidate's stream word end and
    payload end bit), in ``cands``' order."""
    keys = list(cands)
    counts = [len(cands[si]) for si in keys]
    base = np.asarray(word_base, np.int64) * 32
    if sum(counts) == 0:
        return np.zeros((3, 0), np.int64)
    return np.stack([
        np.concatenate([np.asarray(cands[si], np.int64) + base[si]
                        for si in keys]),
        np.repeat([int(word_base[si + 1]) for si in keys], counts),
        np.repeat([int(base[si]) + len(streams[si]) * 8 for si in keys], counts),
    ])


def validate_stage2_batch(streams: list[bytes], cands: dict, words,
                          word_base) -> dict:
    """Stage 2 of several streams in one K5 launch over their concatenated
    words (``pad_words``: ``words`` on the device, ``word_base``).
    ``cands`` maps a stream's index to its stage-1 survivors (stream-local
    bits).  Each candidate carries its own stream's bounds (its word end
    and payload end), so it reads nothing of the next stream.  Returns
    {index: (offsets, header_end_bits)}, stream-local, as
    ``validate_stage2_device`` gives them for each stream alone."""
    good = np.zeros(0, bool)
    end = np.zeros(0, np.int64)
    with span("discovery.validate"):
        cols = stage2_batch_inputs(streams, cands, word_base)
        if cols.shape[1]:
            c, wend, n_bits = torch.from_numpy(cols).to(words.device)
            good, end = validate_headers(words, c, n_bits, wend=wend)
            good, end = good.cpu().numpy(), end.cpu().numpy()
    out, at = {}, 0
    for si, cs in cands.items():
        cs = np.asarray(cs, np.int64)
        g = good[at:at + len(cs)]
        out[si] = (cs[g], end[at:at + len(cs)][g] - int(word_base[si]) * 32)
        at += len(cs)
    return out


def find_block_boundaries(payload: bytes, words_dev=None, *, device):
    """(offsets, header_end_bits) of the validated dynamic headers: stage 1
    and K5 on ``device``."""
    c1 = scan_stage1_device(payload, device=device, words=words_dev)
    return validate_stage2_device(payload, c1, words_dev=words_dev,
                                  device=device)


def _stream_lanes(offsets, status):
    """Block discovery's rules for one stream's parsed headers (``offsets``
    sorted, ``status`` each header's ``header_tables`` status): (the
    indices of its lanes, the offsets dropped for their trees, None), or
    (None, dropped, reason) when the stream is left: ``tables`` when its
    header at bit 16 is dropped, ``first_block`` when its first lane is not
    at bit 16."""
    dropped = {int(o) for o, st in zip(offsets, status) if st == DROPPED}
    if 16 in dropped:
        return None, dropped, "tables"
    kept = [i for i, st in enumerate(status) if st == LANE]
    if not kept or offsets[kept[0]] != 16:
        return None, dropped, "first_block"
    return kept, dropped, None


def _parse_lanes(data: bytes, offsets: np.ndarray):
    """The plain parse of one stream's validated headers (``offsets``):
    each header through ``parse_header`` on the host, under
    ``lane_layout``'s rules (``_stream_lanes``; nothing is parsed unless bit
    16 is among the offsets).  Returns (lanes (off, bfinal, symbol start
    bit, lengths, hlit), their tables (meta, tab), dropped offsets), or None
    where discovery leaves the stream.  For callers that read the parsed
    lengths; it counts nothing."""
    offsets = np.asarray(offsets, np.int64)
    if not (offsets == 16).any():
        return None
    parsed = []
    for off in offsets.tolist():
        r = host._HostBitReader(data, off)
        status, bfinal, lengths, hlit, tables = parse_header(r)
        parsed.append((status, (off, bool(bfinal), r.pos, lengths, hlit),
                       tables))
    kept, dropped, reason = _stream_lanes(offsets, [p[0] for p in parsed])
    if reason is not None:
        return None
    return ([parsed[i][1] for i in kept], [parsed[i][2] for i in kept],
            dropped)


def lane_layout(streams: list[bytes], words, word_base):
    """Every stream's lanes over their concatenated words (``pad_words``:
    ``words`` on the device, ``word_base``): stage 1 per stream, one K5
    (``validate_stage2_batch``), then one K12 (``header_tables``) over the
    validated headers of every stream whose headers include bit 16, and
    each stream's rules (``_stream_lanes``).  Returns (lanes, tables, wend,
    bit_end, lane_range, dropped): each lane (off, bfinal, absolute symbol
    start bit); their tables (meta int32[L, 64], tab int32[L, 160]) on
    ``words``' device, the rows K12 built, never on the host; each lane's
    stream word end and payload end bit (int64[L]); and for each stream
    that kept its first block its lanes ``lane_range[s] = (lo, hi)`` and
    the offsets dropped for their trees."""
    dev = words.device
    survivors = {
        si: scan_stage1_device(
            s, device=dev, words=words[word_base[si]:word_base[si + 1]])
        for si, s in enumerate(streams)
        if len(s) >= 7 and _zlib_header_ok(s)}
    count("discovery.fallback.header", len(streams) - len(survivors))
    valid = validate_stage2_batch(streams, survivors, words, word_base)
    heads = {si: offs for si, (offs, _ends) in valid.items()
             if (offs == 16).any()}
    count("discovery.fallback.first_block", len(valid) - len(heads))
    cols = stage2_batch_inputs(streams, heads, word_base)
    count("discovery.headers", cols.shape[1])
    with span("discovery.parse"):
        info, meta, tab = header_tables(words, *torch.from_numpy(cols).to(dev))
        status, bfinal, start = info[:3].cpu().numpy()

    lanes, rows, wend, bit_end = [], [], [], []
    lane_range, dropped = {}, {}
    at = 0
    for si, offs in heads.items():
        lo_w, hi_w = int(word_base[si]), int(word_base[si + 1])
        kept, gone, reason = _stream_lanes(offs, status[at:at + len(offs)])
        count("discovery.lanes_dropped", len(gone))
        if reason is None:
            dropped[si] = gone
            lo = len(lanes)
            for k in kept:
                lanes.append((int(offs[k]), bool(bfinal[at + k]),
                              int(start[at + k])))
                rows.append(at + k)
            wend += [hi_w] * len(kept)
            bit_end += [lo_w * 32 + len(streams[si]) * 8] * len(kept)
            lane_range[si] = (lo, len(lanes))
        else:
            count(f"discovery.fallback.{reason}")
        at += len(offs)
    with span("discovery.tables"):
        idx = torch.tensor(rows, dtype=torch.int64, device=dev)
        tables = meta.index_select(0, idx), tab.index_select(0, idx)
    return (lanes, tables, np.array(wend, np.int64),
            np.array(bit_end, np.int64), lane_range, dropped)


def _discover(streams: list[bytes], max_steps: int, words, word_base):
    """Block discovery of ``streams`` up to their chains, the one pipeline
    of ``try_foreign`` and ``try_foreign_batch``: ``lane_layout``, one K4
    over every lane (``_lane_decode``) and each stream's chain walk.
    Returns (recs int32[K, L], nout, mask, found): ``mask`` bool[L] marks
    the lanes of every whole chain; ``found`` maps each stream whose chain
    reached its BFINAL block to ((lo, hi) its lanes, its lane indices in
    chain order, its final exit bit, stream-local); recs, nout and mask are
    None when no stream has a lane."""
    count("discovery.streams", len(streams))
    lanes, tables, wend, bit_end, lane_range, dropped = lane_layout(
        streams, words, word_base)
    if not lanes:
        return None, None, None, {}
    recs, bpos, done, nout = _lane_decode(lanes, max_steps, words, wend,
                                          bit_end, tables)
    mask = np.zeros(len(lanes), bool)
    found, broken = {}, {"tables": 0, "budget": 0, "chain": 0}
    with span("discovery.chain"):
        for si, (lo, hi) in lane_range.items():
            chain, cur, whole = _walk(lanes, lo, hi, bpos, done,
                                      int(word_base[si]) * 32)
            if whole:
                mask[chain] = True
                found[si] = (lo, hi), chain, cur
            else:
                broken[_broken_reason(lanes, lo, hi, done, cur,
                                      dropped[si])] += 1
    for reason, n in broken.items():
        count(f"discovery.fallback.{reason}", n)
    count("discovery.lanes_chained", int(mask.sum()))
    return recs, nout, mask, found


def _broken_reason(lanes, lo: int, hi: int, done, cur: int,
                   dropped) -> str:
    """Why a stream's chain walk stopped at stream bit ``cur``: ``tables``
    when the header there was dropped for its trees, ``budget`` when the
    lane there ran out of record slots before its EOB (``DONE_SLOTS``: a
    block longer than a lane's budget), else ``chain``."""
    if cur in dropped:
        return "tables"
    at = next((i for i in range(lo, hi) if lanes[i][0] == cur), None)
    return "budget" if at is not None and done[at] == DONE_SLOTS else "chain"


def lane_budget(max_steps: int) -> int:
    """Record slots per lane of the block-parallel decode: JAX's K =
    4 * max_steps (16..65536, a multiple of 16) in launches of
    min(2^ceil(log2 K), 8192) slots, so a lane gets whole launches."""
    K = min(65536, max(16, 4 * max_steps))
    K += (-K) % 16
    k_launch = min(1 << (K - 1).bit_length(), 8192)
    return -(-K // k_launch) * k_launch


def lane_inputs(lanes, words, wend, bit_end, tables):
    """K4's inputs for candidate lanes (absolute symbol start bits into
    ``words`` at ``lane[2]``; ``wend`` / ``bit_end`` int64[L] bound each
    lane's stream): (words, start, wend, bit_end, out0, meta, tab).
    ``tables``: the lanes' (meta int32[L, 64], tab int32[L, 160]), as
    ``lane_layout`` gives them (``pack_tables`` stacks per-lane ones)."""
    with span("discovery.tables"):
        dev = words.device
        meta, tab = (t.to(dev) for t in tables)
        start = np.array([lane[2] for lane in lanes], np.int64)
        per_lane = [torch.from_numpy(np.asarray(a, np.int64)).to(dev)
                    for a in (start, wend, bit_end,
                              np.full(len(lanes), NO_LIMIT))]
        return (words, *per_lane, meta, tab)


def _lane_decode(lanes, max_steps: int, words, wend, bit_end, tables):
    """K4 over every candidate lane (JAX ``_pallas_lane_decode``).  Returns
    (recs int32[K, L], bpos, done, nout), the last three on the host:
    ``done`` each lane's K4 exit code (``DONE_EOB``, ``DONE_SLOTS``, ...)."""
    args = lane_inputs(lanes, words, wend, bit_end, tables)
    count("discovery.lanes", len(lanes))
    with span("discovery.records"):
        recs, bpos, nout, done = inflate_records(*args, lane_budget(max_steps))
        return (recs, bpos.cpu().numpy(), done.cpu().numpy(),
                nout.cpu().numpy())


def _walk(lanes, lo: int, hi: int, bpos, done, gbase: int = 0):
    """Walk stream lanes[lo:hi] from bit 16: block i is confirmed when its
    EOB exit is the next confirmed header.  ``done``: each lane's K4 exit
    code, or a bool per lane, True where it met its EOB.  Returns (lane
    indices, bit, whole), stream-local: whole when a BFINAL block ends the
    chain, ``bit`` its exit; else ``bit`` is the offset the walk found no
    lane for, or the lane there that met no EOB."""
    by_off = {lanes[i][0]: i for i in range(lo, hi)}
    chain = []
    cur = 16
    while True:
        i = by_off.get(cur)
        if i is None or done[i] != DONE_EOB:
            return chain, cur, False
        chain.append(i)
        cur = int(bpos[i]) - gbase
        if lanes[i][1]:  # BFINAL
            return chain, cur, True


def _stored_adler(data: bytes, final_exit: int) -> int:
    tb = (final_exit + 7) & ~7   # trailer: byte-aligned, big-endian
    return int.from_bytes(data[tb // 8: tb // 8 + 4], "big")


def _stitch(recs, mask, ranges, produced):
    """The chain lanes' records -> one output row per stream, on the device
    (JAX ``_jit_stitch`` / ``_jit_stitch_batch``).

    ``recs`` int32[K, L]; ``mask`` bool[L] marks chain lanes (the others
    turn inert); stream s owns lanes ``ranges[s] = (lo, hi)``, i.e. the
    lane-major records [lo*K, hi*K), and makes ``produced[s]`` bytes.
    Returns (out u8[S, cap], Adler-32 int64[S] of each row's first
    ``produced`` bytes, bad bool[S]: a distance reaching before the
    stream's start, which empties that row).

    The records are gathered stream-major, a row per stream; one flat scan
    (``flat_records``) gives each record's start in its stream, which both
    the distance check and the placement read.
    """
    K, L = recs.shape
    dev = recs.device
    lo = torch.tensor([r[0] for r in ranges], dtype=torch.int64, device=dev)
    width = torch.tensor([(r[1] - r[0]) * K for r in ranges],
                         dtype=torch.int64, device=dev)
    m = torch.from_numpy(np.asarray(mask)).to(dev)
    flat = torch.cat([torch.where(m[None, :], recs, 0).T.reshape(-1),
                      torch.zeros(1, dtype=recs.dtype, device=dev)])
    ks = torch.arange(max(r[1] - r[0] for r in ranges) * K, device=dev)
    idx = torch.where(ks < width[:, None], lo[:, None] * K + ks, L * K)
    records = recs_to_records(flat[idx])                 # each [S, widest]
    pos, placed = flat_records(records)
    bad = ((records[3] > 0) & (records[3] > pos)).any(dim=1)
    prod = torch.where(bad, 0, torch.as_tensor(produced, device=dev))
    window = torch.zeros(len(ranges), WINDOW, dtype=torch.uint8, device=dev)
    out, _ = materialize_flat(*placed, window, prod,
                              _cap_bucket(int(max(produced))),
                              want_window=False)
    return out, adler32_batch(out, prod), bad


def _materialize_host(data: bytes, recs, chain, final_exit: int):
    """JAX's ``materialize="host"`` (discovery.py:510-527): the chain lanes'
    K4 records (int32[K, L]) in chain order, flattened, expanded by the
    native ``fdn_materialize`` into the sum of their advances; the bytes
    when their Adler-32 is the stored one, else None (malformed records or
    no native backend)."""
    cols = torch.tensor(chain, dtype=torch.int64, device=recs.device)
    flat = recs[:, cols].T.reshape(-1).cpu().numpy()
    kind = (flat >> 28) & 0xF
    pay = flat & 0x0FFFFFFF
    adv = np.where(kind == 1, (pay >> 16) & 3,
                   np.where(kind == 2, ((pay >> 15) & 0xFF) + 3, 0))
    result = native.materialize_records(flat, int(adv.sum()))
    if result is not None and _stored_adler(data, final_exit) == zlib.adler32(result):
        return result
    return None


def try_foreign(data: bytes, max_steps: int = 6144, engine: str = "auto",
                words_dev=None, return_device: bool = False,
                materialize: str | None = None, *, device="cuda"):
    """``decompress_foreign`` without the fallback: the bytes of a confirmed,
    checksum-verified chain decode, or None when the stream needs the
    sequential path.

    ``words_dev``: the stream's words already on the device
    (``stage_words``).  ``return_device=True`` keeps the output on the
    device and returns (out u8[1, cap], produced) with the Adler-32
    verified there (one scalar read back).  ``engine`` picks the JAX
    package's symbol phase (its record kernel or its XLA loop); the port
    has one, K4, and ignores it.  ``materialize`` (None: the environment's
    ``FDN_FOREIGN_MATERIALIZE``, default "device") is where the records
    become bytes: "host" expands them with the native backend
    (``_materialize_host``; None without it) unless ``return_device``.
    """
    del engine
    if materialize is None:
        materialize = os.environ.get("FDN_FOREIGN_MATERIALIZE", "device")
    dev = device_of(device)
    if words_dev is None:
        words_dev = stage_words(data, device=dev)
    recs, nout, mask, found = _discover([data], max_steps, words_dev,
                                        [0, words_dev.numel()])
    if not found:
        return None
    (lo, hi), chain, final_exit = found[0]
    with span("discovery.stitch"):
        if materialize == "host" and not return_device:
            result = _materialize_host(data, recs, chain, final_exit)
        else:
            produced = int(nout[chain].sum())
            out, ck, bad = _stitch(recs, mask, [(lo, hi)], [produced])
            if bool(bad[0]) or _stored_adler(data, final_exit) != int(ck[0]):
                result = None  # the chain was plausible but wrong
            elif return_device:
                result = out, produced
            else:
                result = out[0, :produced].cpu().numpy().tobytes()
    if result is None:
        count("discovery.fallback.checksum")
    return result


def _cap_bucket(produced: int) -> int:
    """Materialize capacity: the smallest of {1, 1.5} * 2^k covering
    ``produced`` (JAX ``_cap_bucket``)."""
    produced = max(produced, 256)
    p2 = 1 << int(np.ceil(np.log2(produced)))
    return 3 * p2 // 4 if 3 * p2 // 4 >= produced else p2


def try_foreign_batch(streams: list[bytes], max_steps: int = 6144,
                      engine: str = "auto", *, device="cuda"):
    """Block-parallel decode of many foreign streams in one K5 and one K4
    launch (``engine``, as in ``try_foreign``, is ignored): ``_discover``
    over the concatenated stream words, then one stitch of every confirmed
    stream.  Returns, per stream, the bytes or None (the caller falls back
    for that stream: a dropped header costs only the stream whose chain
    needs it).  A batch of one is ``try_foreign``.
    """
    S = len(streams)
    if S <= 1:
        return [try_foreign(s, max_steps=max_steps, device=device)
                for s in streams]
    words_np, word_base = pad_words(streams)
    words = torch.from_numpy(words_np).to(device_of(device))
    recs, nout, mask, found = _discover(streams, max_steps, words, word_base)
    results: list[bytes | None] = [None] * S
    if not found:
        return results

    confirmed = sorted(found)
    with span("discovery.stitch"):
        ranges = [found[si][0] for si in confirmed]
        produced = [int(nout[lo:hi][mask[lo:hi]].sum()) for lo, hi in ranges]
        out, ck, bad = _stitch(recs, mask, ranges, produced)
        out_np, ck = out.cpu().numpy(), ck.cpu().numpy()
        bad = bad.cpu().numpy()
        for ci, si in enumerate(confirmed):
            if not bad[ci] and _stored_adler(streams[si], found[si][2]) == ck[ci]:
                results[si] = out_np[ci, : produced[ci]].tobytes()
    count("discovery.fallback.checksum",
          sum(results[si] is None for si in confirmed))
    return results


def decompress_foreign(data: bytes, max_steps: int = 6144, *,
                       device="cuda") -> bytes:
    """Block-parallel decode of a foreign zlib stream, falling back to the
    sequential path for the whole stream when the chain cannot cover it;
    raises the stream's decode error."""
    if len(data) >= 7 and not _zlib_header_ok(data):
        raise E.BadZlibHeader()
    r = try_foreign(data, max_steps=max_steps, device=device)
    if r is not None:
        return r
    r = decompress_sequential([data], max_steps=max_steps, device=device)[0]
    if isinstance(r, E.DecompressionError):
        raise r
    return r


def decompress_batch(streams: list[bytes], max_steps: int = 8192,
                     out_capacity: int | None = None,
                     try_parallel: bool = True, engine: str = "auto", *,
                     device="cuda"):
    """Decode many zlib streams; per stream the bytes or the error.

    Routing of JAX ``ops/inflate.decompress_batch``: with ``try_parallel``
    (the default), streams of 49152 bytes or more go to block discovery
    first (``try_foreign_batch`` when there are several, ``try_foreign``
    for one); those it leaves, and all others, take the sequential path
    (``ops/inflate.decompress_sequential``).  ``device`` names where the
    kernels run.  ``out_capacity`` sizes the JAX sequential path's output
    per launch, which the port sizes from each launch's output itself, and
    ``engine`` picks the JAX package's symbol phase; both are ignored.
    """
    del out_capacity, engine
    count("inflate.calls")
    with span("inflate.batch"):
        big = [i for i, s in enumerate(streams)
               if try_parallel and len(s) >= _PARALLEL_MIN]
        if len(big) > 1:
            res = try_foreign_batch([streams[i] for i in big],
                                    max_steps=max_steps, device=device)
        else:
            res = [try_foreign(streams[i], max_steps=max_steps, device=device)
                   for i in big]
        results_par = {i: r for i, r in zip(big, res) if r is not None}
        rest = [s for i, s in enumerate(streams) if i not in results_par]
        seq = iter(decompress_sequential(rest, max_steps=max_steps,
                                         device=device))
        return [results_par[i] if i in results_par else next(seq)
                for i in range(len(streams))]
