"""Port foreign decode (K4 plain version, materialize, decompress_batch)
against the JAX package.

K4's plain version is held record for record against the numpy oracle
``pallas_inflate.decode_records_np``; ``materialize`` against the JAX one on
the CPU; ``decompress_batch`` against the JAX function of that name, which
runs its XLA engine (``decode_symbols``) on the CPU, bytes or error class
per stream.  The Pallas kernels never run here (interpret mode is far too
slow, tests/test_pallas_inflate.py is marked slow for that reason); the
JAX calls sit in module fixtures so each compiles once.  Every output is an
integer or a byte: all comparisons are exact.
"""

from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fdeflate_tpu as F
from fdeflate_tpu.ops import inflate as I
from fdeflate_tpu.ops import pallas_inflate as PI
from fdeflate_tpu.ops.bitio import BitWriter
from fdeflate_tpu.tables import FIXED_CODE_LENGTHS
from fdeflate_tpu_torch import decompress_batch
from fdeflate_tpu_torch.ops.inflate import fixed_meta_tab, materialize
from fdeflate_tpu_torch.ops.inflate_records import (
    DONE_TOO_FAR,
    DONE_TRUNCATED,
    NO_LIMIT,
    inflate_records,
    lanes_from_blocked,
    recs_to_records,
)
from test_crafted_streams import emit_dynamic_block, lopsided_lengths


def _words(z: bytes) -> np.ndarray:
    padded = z + bytes((-len(z)) % 4) + bytes(8)
    return np.frombuffer(padded, "<u4")


def _first_block(z: bytes, fixed: bool = False):
    """(words, symbol start bit, meta, tab) of a stream's first block."""
    r = I._HostBitReader(z, 16)
    r.take(1)
    btype = r.take(2)
    if fixed:
        assert btype == 1
        meta, tab = I._fixed_foreign_meta()
    else:
        assert btype == 2
        lengths, hlit = I._parse_dynamic_lengths(r)
        meta, tab = PI.foreign_meta(lengths[:hlit], lengths[288:320])
    return _words(z), r.pos, meta, tab


def _mixed(seed: int, n: int) -> bytes:
    rng = np.random.default_rng(seed)
    wp = [rng.bytes(int(rng.integers(3, 12))) for _ in range(64)]
    return b"".join(wp[int(rng.integers(64))] for _ in range(n))


def _fixed_stream(codes) -> bytes:
    """One fixed block of raw (code, nbits) pairs, MSB-first codes."""
    w = BitWriter(bytearray(b"\x78\x01"))
    w.write_bits(0b011, 3)
    for code, nbits in codes:
        rev = int(format(code, f"0{nbits}b")[::-1], 2)
        w.write_bits(rev, nbits)
    return bytes(w.flush()) + bytes(4)


def _no_dist_tree_stream() -> bytes:
    """A length symbol in a block with no distance codes
    (tests/test_crafted_streams.py, InvalidDistanceCode)."""
    from fdeflate_tpu.models.bitstream import build_huffman_tree
    from fdeflate_tpu.tables import CLCL_ORDER, canonical_codes

    lengths = np.zeros(286, np.int64)
    lengths[ord("q")], lengths[256], lengths[257] = 2, 2, 1
    codes = canonical_codes(lengths)
    all_lens = np.concatenate([lengths, np.zeros(30, np.int64)])
    cl_lengths, cl_codes, _ = build_huffman_tree(
        np.bincount(all_lens, minlength=19)[:19], 7)
    w = BitWriter(bytearray(b"\x78\x01"))
    w.write_bits(0b101, 3)
    w.write_bits(286 - 257, 5)
    w.write_bits(30 - 1, 5)
    w.write_bits(15, 4)
    for j in range(19):
        w.write_bits(int(cl_lengths[CLCL_ORDER[j]]), 3)
    for ln in all_lens:
        w.write_bits(int(cl_codes[int(ln)]), int(cl_lengths[int(ln)]))
    w.write_bits(int(codes[257]), 1)
    w.write_bits(0, 16)
    return bytes(w.flush()) + bytes(4)

def _lane_cases():
    """(name, (words, pos, meta, tab), K) lanes for K4 against the oracle."""
    co_fixed = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FIXED)
    co_huff = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_HUFFMAN_ONLY)
    rng = np.random.default_rng(3)
    huff = (rng.integers(0, 16, 3000).astype(np.uint8) * 5).tobytes()
    rle = F.compress_to_vec_rle(bytes(500) + b"\x07" * 900 + bytes(300))
    text = zlib.compress(b"the quick brown fox jumps over the lazy dog " * 80, 9)
    dyn = zlib.compress(_mixed(11, 600), 6)
    corrupt = bytearray(dyn)
    corrupt[len(corrupt) // 2] ^= 0x5A
    # 286 in a fixed block: a valid code with no meaning (invalid litlen)
    bad_fixed = _fixed_stream([(0x30 + ord("a"), 8), (0b11000110, 8)])
    return [
        ("dynamic", _first_block(dyn), 4096),
        ("text", _first_block(text), 4096),
        ("fixed", _first_block(co_fixed.compress(b"fdeflate! " * 40)
                               + co_fixed.flush(), fixed=True), 4096),
        ("one_dist_code", _first_block(rle), 4096),
        ("no_dist_code", _first_block(co_huff.compress(huff)
                                      + co_huff.flush()), 4096),
        ("invalid_dist", _first_block(_no_dist_tree_stream()), 64),
        ("invalid_litlen", _first_block(bad_fixed, fixed=True), 64),
        ("corrupted", _first_block(bytes(corrupt)), 4096),
        ("budget_exhausted", _first_block(dyn), 48),
    ]


LANE_CASES = _lane_cases()


def _run_plain(lanes, K, bit_end=None, out0=None):
    """Every lane in ONE K4 call over the concatenated words; each lane's
    reads stop at its own words (wend), as the oracle's do."""
    words, base = [], [0]
    for w, *_ in lanes:
        words.append(w.view(np.int32))
        base.append(base[-1] + len(w))
    L = len(lanes)
    start = np.array([base[i] * 32 + p for i, (_w, p, _m, _t) in
                      enumerate(lanes)], np.int64)
    # tables go through JAX's lane-blocked layout and back
    LB = 1
    metas = np.zeros((LB * 1024, 64), np.int32)
    tabs = np.zeros((LB * 1024, PI._TPAIRS), np.int32)
    for i, (_w, _p, m, t) in enumerate(lanes):
        metas[i], tabs[i] = m, t

    def blocked(a):   # _pallas_lane_decode's layout
        return a.reshape(LB, 8, 128, -1).transpose(0, 3, 1, 2)

    meta = lanes_from_blocked(blocked(metas))[:L]
    tab = lanes_from_blocked(blocked(tabs))[:L]
    full = lambda v: torch.full((L,), v, dtype=torch.int64)  # noqa: E731
    recs, bpos, nout, done = inflate_records(
        torch.from_numpy(np.concatenate(words)), torch.from_numpy(start),
        torch.tensor(base[1:], dtype=torch.int64),
        full(NO_LIMIT) if bit_end is None else torch.as_tensor(bit_end),
        full(NO_LIMIT) if out0 is None else torch.as_tensor(out0),
        torch.from_numpy(meta), torch.from_numpy(tab), K)
    return recs.numpy(), bpos.numpy() - np.array(base[:-1]) * 32, nout.numpy(), done.numpy()


@pytest.mark.parametrize("case", LANE_CASES, ids=[c[0] for c in LANE_CASES])
def test_k4_plain_matches_oracle(case):
    name, lane, K = case
    recs, bpos, nout, done = _run_plain([lane], K)
    w, p, m, t = lane
    o_recs, o_pos, o_done = PI.decode_records_np(w, p, m, t, K)
    assert (recs[:, 0] == o_recs).all()
    assert bpos[0] == o_pos
    assert min(int(done[0]), 2) == o_done
    expect = {"budget_exhausted": 0, "invalid_dist": 2, "invalid_litlen": 2}
    assert o_done == expect.get(name, o_done if name == "corrupted" else 1)
    kind = (o_recs >> 28) & 0xF
    pay = o_recs & 0x0FFFFFFF
    assert nout[0] == (np.where(kind == 1, (pay >> 16) & 3, 0).sum()
                       + np.where(kind == 2, ((pay >> 15) & 0xFF) + 3, 0).sum())


def test_k4_plain_all_lanes_in_one_call():
    lanes = [c[1] for c in LANE_CASES]
    K = 4096
    recs, bpos, _nout, done = _run_plain(lanes, K)
    for i, (w, p, m, t) in enumerate(lanes):
        o_recs, o_pos, o_done = PI.decode_records_np(w, p, m, t, K)
        assert (recs[:, i] == o_recs).all(), i
        assert bpos[i] == o_pos and min(int(done[i]), 2) == o_done, i


def test_k4_error_classes():
    """Done codes 3-5: an invalid distance code, a symbol past bit_end, a
    distance past out0 + the lane's own bytes."""
    lanes = {c[0]: c[1] for c in LANE_CASES}
    _r, _b, _n, done = _run_plain([lanes["invalid_dist"]], 64)
    assert done[0] == 3
    w, p, m, t = lanes["dynamic"]
    recs, bpos, nout, done = _run_plain([lanes["dynamic"]], 4096)
    end = int(bpos[0])
    _r, _b, _n, cut = _run_plain([lanes["dynamic"]], 4096,
                                 bit_end=[end - 1])
    assert cut[0] == DONE_TRUNCATED
    _r, _b, _n, ok = _run_plain([lanes["dynamic"]], 4096, bit_end=[end])
    assert ok[0] == 1
    _r, _b, _n, far = _run_plain([lanes["dynamic"]], 4096, out0=[0])
    has_match = ((recs[:, 0] >> 28) & 0xF == 2).any()
    assert has_match and far[0] == 1   # zlib never reaches before the start
    _r, _b, _n, far = _run_plain([lanes["one_dist_code"]], 4096, out0=[-1])
    assert far[0] == DONE_TOO_FAR


def test_recs_to_records_matches_jax():
    """The port's (lit, cnt, len, dist) are JAX's columns without lit_hi,
    which is zero for K4's records of at most two literals."""
    lane = LANE_CASES[0][1]
    recs, *_ = _run_plain([lane] * 3, 1024)
    rl, rlh, *want = PI.recs_to_records(jnp.asarray(recs))
    assert not np.asarray(rlh).any()
    got = recs_to_records(torch.from_numpy(recs))
    assert len(got) == 4
    for g, w in zip(got, [rl, *want]):
        assert np.array_equal(g.numpy().astype(np.int64),
                              np.asarray(w).astype(np.int64))


def test_fixed_table_ends_block_on_286_287():
    """The port's fixed-code table: foreign_meta's, with 286/287 as end of
    block, as the reference decode tables read them."""
    meta, tab = fixed_meta_tab()
    jmeta, jtab = I._fixed_foreign_meta()
    assert np.array_equal(meta, jmeta)
    order = PI._canonical_order(np.asarray(FIXED_CODE_LENGTHS, np.int64)[:288])
    for i in range(PI._ENTRIES):
        e, je = PI._tab_entry(tab, i), PI._tab_entry(jtab, i)
        sym = order[i - PI._LIT_BASE] if i >= PI._LIT_BASE and i - PI._LIT_BASE < len(order) else -1
        assert e == ((PI._CLS_EOB << 13) if sym in (286, 287) else je), i


# ---------------------------------------------------------------- materialize

def _records(seed: int, B: int, K: int, window_refs: bool):
    """Random well-formed records of at most two literals: literal runs,
    dist-1 runs, overlapping copies (dist < len), and, with window_refs,
    distances into the window.  JAX's five columns (lit_hi all zero)."""
    rng = np.random.default_rng(seed)
    rl = np.zeros((K, B), np.uint32)
    rlh = np.zeros((K, B), np.uint32)
    rc = np.zeros((K, B), np.int8)
    rn = np.zeros((K, B), np.int32)
    rd = np.zeros((K, B), np.int32)
    for b in range(B):
        made = 0
        for k in range(int(rng.integers(K // 2, K))):
            kind = rng.integers(0, 4)
            if kind == 0 or (made == 0 and not window_refs):
                n = int(rng.integers(1, 3))
                lits = rng.integers(0, 256, n).astype(np.uint64)
                rl[k, b] = sum(int(x) << (8 * j) for j, x in enumerate(lits))
                rc[k, b] = n
                made += n
                continue
            n = int(rng.integers(3, 259))
            limit = made + (I.WINDOW if window_refs else 0)
            d = 1 if kind == 1 else int(rng.integers(1, min(limit, 32768) + 1))
            if kind == 2:
                d = int(rng.integers(1, min(limit, n) + 1))   # overlapping
            rn[k, b], rd[k, b] = n, d
            made += n
    return rl, rlh, rc, rn, rd


@pytest.mark.parametrize("want_window", [True, False])
@pytest.mark.parametrize("window_refs", [False, True])
def test_materialize_matches_jax(want_window, window_refs):
    B, K = 3, 300
    recs = _records(7 + window_refs, B, K, window_refs)
    rng = np.random.default_rng(9)
    window = rng.integers(0, 256, (B, I.WINDOW), dtype=np.uint8)
    adv = recs[2].astype(np.int64) + recs[3]
    produced = adv.sum(axis=0).astype(np.int32)
    produced[1] = max(0, produced[1] - 77)   # masking of a short stream
    cap = 1 << int(np.ceil(np.log2(int(produced.max()))))
    want_out, want_win = I.materialize(
        tuple(jnp.asarray(a) for a in recs), jnp.asarray(window),
        jnp.asarray(produced), out_capacity=cap, want_window=want_window,
        max_lit_bytes=2)
    got_out, got_win = materialize(
        tuple(torch.from_numpy(a.astype(np.int64))
              for i, a in enumerate(recs) if i != 1),
        torch.from_numpy(window), torch.from_numpy(produced), cap,
        want_window=want_window)
    assert np.array_equal(got_out.numpy(), np.asarray(want_out))
    assert np.array_equal(got_win.numpy(), np.asarray(want_win))


# --------------------------------------------------------- decompress_batch

def _corpus(n: int, seed: int = 0) -> bytes:
    rng = np.random.default_rng(seed)
    return np.where(rng.integers(0, 4, n) > 0, rng.integers(-8, 8, n),
                    0).astype(np.uint8).tobytes()


def _batch_streams():
    """Multi-block zlib 1/6/9 (>= 49152 bytes: the block-parallel route),
    stored, Z_FIXED, tiny, empty, cross-block back-references, corrupted
    and truncated streams, and the crafted streams."""
    big = _corpus(110000)
    co = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FIXED)
    fixed = co.compress(b"fixed block data " * 300) + co.flush()
    rng = np.random.default_rng(3)
    pat = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
    backrefs = zlib.compress((pat + bytes(500)) * 40, 6)
    corrupt = bytearray(zlib.compress(big, 6))
    corrupt[len(corrupt) // 2] ^= 0xFF
    small = zlib.compress(_mixed(2, 800), 6)
    lens = np.zeros(286, np.int64)
    lens[ord("x")], lens[ord("y")], lens[256] = 2, 2, 2
    lens[257], lens[258] = 3, 3
    dist1 = np.zeros(30, np.int64)
    dist1[0] = 1
    w = BitWriter(bytearray(b"\x78\x01"))      # a match with no output yet
    w.write_bits(0b011, 3)
    w.write_bits(0b1000000, 7)
    w.write_bits(0, 5)
    w.write_bits(0, 7)
    too_far = bytes(w.flush()) + bytes(4)
    return {
        "zlib1": zlib.compress(big, 1),
        "zlib6": zlib.compress(big, 6),
        "zlib9": zlib.compress(big, 9),
        "stored": zlib.compress(big[:60000], 0),
        "fixed": fixed,
        "tiny": zlib.compress(b"hello world" * 3, 6),
        "empty": zlib.compress(b"", 6),
        "nothing": b"",
        "backrefs": backrefs,
        "corrupted": bytes(corrupt),
        "truncated": small[: len(small) // 2],
        "bad_checksum": small[:-1] + bytes([small[-1] ^ 1]),
        "lopsided_15bit": emit_dynamic_block(
            lopsided_lengths(), np.zeros(30, np.int64),
            [0, 1, 2, 13, 14, 14, 0, 5, 9, 14] * 5)[0],
        "single_dist": emit_dynamic_block(
            lens, dist1, [ord("x"), ord("y"), (4, 1), ord("x")])[0],
        "too_far": too_far,
        "fixed_286": _fixed_stream([(0x30 + ord("a"), 8), (0b11000110, 8)]),
        "no_dist_tree": _no_dist_tree_stream(),
    }



BATCH = _batch_streams()


@pytest.fixture(scope="module")
def jax_batch():
    return I.decompress_batch(list(BATCH.values()), max_steps=2048)


@pytest.fixture(scope="module")
def port_batch():
    return decompress_batch(list(BATCH.values()), max_steps=2048,
                            device="cpu")


@pytest.mark.parametrize("name", list(BATCH))
def test_decompress_batch_matches_jax(jax_batch, port_batch, name):
    i = list(BATCH).index(name)
    want, got = jax_batch[i], port_batch[i]
    if isinstance(want, bytes):
        assert got == want
        if name not in ("fixed_286",):
            assert want == zlib.decompress(BATCH[name])
    else:
        assert type(got).__name__ == type(want).__name__, (got, want)


def test_decompress_batch_error_classes(port_batch):
    """Each error stream gives the class the JAX path gives (checked in
    the parametrised test) and it is the expected one."""
    names = list(BATCH)
    got = {n: type(port_batch[names.index(n)]).__name__ for n in names}
    assert got["truncated"] == "InsufficientInput"
    assert got["bad_checksum"] == "WrongChecksum"
    assert got["too_far"] == "DistanceTooFarBack"
    assert got["no_dist_tree"] == "InvalidDistanceCode"
    assert got["nothing"] == "InsufficientInput"
    assert isinstance(port_batch[names.index("corrupted")], Exception)


def test_chip_smoke_small_batch_expectations():
    """chip_smoke.py's sequential-route batch: the classes and bytes it
    expects on the card are the JAX path's (and the port's) on the CPU."""
    from chip_smoke import small_mixed_batch

    small = small_mixed_batch()
    streams = [z for z, _ in small]
    for res in (I.decompress_batch(streams, max_steps=2048),
                decompress_batch(streams, max_steps=2048, device="cpu")):
        for (_z, want), got in zip(small, res):
            if isinstance(want, bytes):
                assert got == want
            else:
                assert type(got).__name__ == want
