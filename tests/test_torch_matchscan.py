"""The port's match-finder stages against the JAX package's, exactly.

Each stage of ``fdeflate_tpu_torch/ops/matchscan.py`` gets the inputs that
JAX's stage gets and must return every integer JAX returns (tolerance 0).
Two batches of B rows at N = 4096, made with numpy from a seed: the two
rows of the JAX package's serial-walk test (a periodic row with a 600-byte
zero run; a random row of length N - 7), and the five corpus shapes of its
``TestMatchscan._streams`` (IDAT-like, word salad, low entropy, a 100-byte
pattern, random bytes) cut to N.  JAX's stages run eagerly (no ``jit``);
each JAX intermediate is computed once per module and shared.
"""

from __future__ import annotations

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fdeflate_tpu.models.bitstream import build_huffman_tree
from fdeflate_tpu.ops import matchscan as J
from fdeflate_tpu_torch.ops import matchscan as P

N = 4096


def _walk_batch():
    rng = np.random.default_rng(1)
    data = np.zeros((2, N), np.uint8)
    data[0] = np.tile(rng.integers(1, 256, 100, dtype=np.uint8), 41)[:N]
    data[0, 1000:1600] = 0
    data[1] = rng.integers(0, 256, N)
    return data, np.array([N, N - 7], np.int32)


def _corpus_batch():
    rng = np.random.default_rng(0)
    idat = np.where(rng.integers(0, 4, 8000) > 0, rng.integers(-8, 8, 8000),
                    0).astype(np.uint8)
    words = [b"the", b"quick", b"brown", b"fox"]
    text = np.frombuffer(b" ".join(words[i] for i in rng.integers(0, 4, 2000)),
                         np.uint8)
    low = ((rng.integers(0, 16, 8000, dtype=np.uint8) * 2) - 16).astype(np.uint8)
    pat = np.tile(rng.integers(1, 256, 100, dtype=np.uint8), 50)
    rand = rng.integers(0, 256, 5000, dtype=np.uint8)
    data = np.stack([r[:N] for r in (idat, text, low, pat, rand)])
    return data, np.full(5, N, np.int32)


BATCHES = {"walk": _walk_batch(), "corpus": _corpus_batch()}


def _eq(got, want, what=""):
    """Every integer equal: the port's torch tensor against JAX's array."""
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == bool:
        assert got.dtype == bool, what
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64)), (
        what, int((got.astype(np.int64) != want.astype(np.int64)).sum()))


def _tt(x):
    return torch.from_numpy(np.array(x))


@functools.cache
def jax_stage(name: str, stage: str):
    """JAX's intermediates for one batch, computed once each (eagerly)."""
    data, lengths = BATCHES[name]
    d, ln = jnp.asarray(data), jnp.asarray(lengths)
    if stage == "lit8":
        return J.stream_lit_bits8(d, ln)
    if stage == "matches":                      # _segments' 4-byte pass
        return J.find_matches(d, ln, depth=4, lit_bits8=jax_stage(name, "lit8"))
    if stage == "extended":
        return J.extend_winners(d, *jax_stage(name, "matches"), ln)
    if stage == "tiled":
        return J.greedy_tile(*jax_stage(name, "extended"), ln)
    if stage == "chains":
        return J.merge_chains(*jax_stage(name, "tiled"),
                              jax_stage(name, "extended")[1], ln)
    if stage == "stage1":
        return J._stage1(d, ln, 4, 4)
    if stage == "host1":                        # the host's first-pass trees
        _seg, _roles, (fl, fd), hist = jax_stage(name, "stage1")
        fl, fd, hist = np.asarray(fl), np.asarray(fd), np.asarray(hist)
        shadow = np.zeros((len(data), 256), np.int32)
        fp_lit = np.zeros((len(data), 286), np.int32)
        fp_dist = np.zeros((len(data), 30), np.int32)
        for b in range(len(data)):
            sl = build_huffman_tree(hist[b].astype(np.int64), 15)[0]
            shadow[b] = np.where(sl > 0, sl, 15)
            fp_lit[b] = build_huffman_tree(fl[b].astype(np.int64), 15)[0]
            fp_dist[b] = build_huffman_tree(fd[b].astype(np.int64), 15)[0]
        return shadow, fp_lit, fp_dist
    if stage == "demoted":
        return J._demote_segments(d, ln, jax_stage(name, "stage1")[0],
                                  *(jnp.asarray(a) for a in jax_stage(name, "host1")),
                                  min_match=4)
    if stage == "headers":
        _seg, _roles, (fl, fd) = jax_stage(name, "demoted")
        return [J._host_header(np.asarray(fl)[b], np.asarray(fd)[b])
                for b in range(len(data))]
    raise KeyError(stage)


def _port_inputs(name):
    data, lengths = BATCHES[name]
    return torch.from_numpy(data), torch.from_numpy(lengths)


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_stream_lit_bits8_equals_jax(name):
    _eq(P.stream_lit_bits8(*_port_inputs(name)), jax_stage(name, "lit8"))


# (depth, hash_bytes, cost_filter, backext, lit_bits8 given)
FIND_CASES = [
    (2, 4, True, True, False), (2, 4, True, True, True),
    (4, 4, True, True, True), (8, 4, True, True, True),
    (16, 4, True, True, True),
    (2, 8, False, True, True), (4, 8, False, True, True),
    (8, 8, False, True, True), (16, 8, False, True, True),
    (4, 4, False, True, True), (4, 4, True, False, True),
    (4, 4, False, False, True), (8, 8, True, False, True),
]


@pytest.mark.parametrize("name", sorted(BATCHES))
@pytest.mark.parametrize("case", FIND_CASES, ids=lambda c:
                         "d{}-h{}-cf{:d}-be{:d}-lit{:d}".format(*c))
def test_find_matches_equals_jax(name, case):
    depth, hb, cf, be, lit = case
    data, lengths = BATCHES[name]
    min_match = 8 if hb == 8 else 4
    kw = dict(depth=depth, min_match=min_match, hash_bytes=hb,
              cost_filter=cf, backext=be)
    want = J.find_matches(jnp.asarray(data), jnp.asarray(lengths), **kw,
                          lit_bits8=jax_stage(name, "lit8") if lit else None)
    got = P.find_matches(*_port_inputs(name), **kw,
                         lit_bits8=_tt(jax_stage(name, "lit8")) if lit else None)
    _eq(got[0], want[0], "mlen")
    _eq(got[1], want[1], "mdist")
    assert int((got[0] > 0).sum()) > 0


@pytest.mark.parametrize("name", sorted(BATCHES))
@pytest.mark.parametrize("limit", [260, 40])
def test_extend_winners_equals_jax(name, limit):
    data, lengths = BATCHES[name]
    mlen, mdist = jax_stage(name, "matches")
    want = J.extend_winners(jnp.asarray(data), mlen, mdist,
                            jnp.asarray(lengths), limit=limit)
    got = P.extend_winners(*_port_inputs(name)[:1], _tt(mlen), _tt(mdist),
                           _tt(lengths), limit=limit)
    _eq(got[0], want[0], "mlen")
    _eq(got[1], want[1], "mdist")
    if limit == 260:
        _eq(got[0], jax_stage(name, "extended")[0])


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_greedy_tile_equals_jax_and_the_serial_walk(name):
    """JAX's tiling exactly, and the set a serial greedy walk from position
    0 accepts (the JAX package's own check, on the port)."""
    _data, lengths = BATCHES[name]
    mlen, mdist = jax_stage(name, "extended")
    want = jax_stage(name, "tiled")
    ss, im = P.greedy_tile(_tt(mlen), _tt(mdist), _tt(lengths))
    _eq(ss, want[0], "sym_start")
    _eq(im, want[1], "is_match")
    ml = np.asarray(mlen)
    for b in range(len(lengths)):
        ref = np.zeros(N, bool)
        refm = np.zeros(N, bool)
        i = 0
        while i < lengths[b]:
            ref[i] = True
            if ml[b, i] >= 4:
                refm[i] = True
                i += ml[b, i]
            else:
                i += 1
        assert (ref == ss[b].numpy()).all() and (refm == im[b].numpy()).all(), b


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_merge_chains_equals_jax(name):
    _data, lengths = BATCHES[name]
    ss, im = jax_stage(name, "tiled")
    got = P.merge_chains(_tt(ss), _tt(im), _tt(jax_stage(name, "extended")[1]),
                         _tt(lengths))
    for g, w, what in zip(got, jax_stage(name, "chains"),
                          ("seg_start", "seg_len", "seg_dist")):
        _eq(g, w, what)


@pytest.mark.parametrize("name", sorted(BATCHES))
@pytest.mark.parametrize("backext", [True, False])
def test_segments_equal_jax(name, backext):
    data, lengths = BATCHES[name]
    want = J._segments(jnp.asarray(data), jnp.asarray(lengths), 8, 4,
                       backext=backext)
    got = P._segments(*_port_inputs(name), 8, 4, backext=backext)
    for g, w, what in zip(got, want, ("seg_start", "seg_len", "seg_dist")):
        _eq(g, w, what)


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_roles_and_freqs_equal_jax(name):
    data, lengths = BATCHES[name]
    segs = jax_stage(name, "chains")
    want_roles, want_freqs = J._roles_and_freqs(
        jnp.asarray(data), jnp.asarray(lengths), segs, 4)
    roles, freqs = P._roles_and_freqs(*_port_inputs(name),
                                      tuple(_tt(s) for s in segs), 4)
    for g, w, what in zip(roles + freqs, want_roles + want_freqs,
                          ("lit_mask", "sub_start", "sub_len", "sub_dist",
                           "freq_l", "freq_d")):
        _eq(g, w, what)


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_stage1_equals_jax(name):
    segs, roles, freqs, hist = P._stage1(*_port_inputs(name), 4, 4)
    w_segs, w_roles, w_freqs, w_hist = jax_stage(name, "stage1")
    for g, w in zip(segs + roles + freqs + (hist,),
                    tuple(w_segs) + tuple(w_roles) + tuple(w_freqs) + (w_hist,)):
        _eq(g, w)


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_demote_segments_equals_jax(name):
    w_segs = jax_stage(name, "stage1")[0]
    segs, roles, freqs = P._demote_segments(
        *_port_inputs(name), tuple(_tt(s) for s in w_segs),
        *(_tt(a) for a in jax_stage(name, "host1")), min_match=4)
    want = jax_stage(name, "demoted")
    for g, w in zip(segs + roles + freqs,
                    tuple(want[0]) + tuple(want[1]) + tuple(want[2])):
        _eq(g, w)
    if name == "corpus":        # demotion dropped segments there
        assert int(segs[0].sum()) < int(_tt(w_segs[0]).sum())


def _header_tables(headers):
    B = len(headers)
    hw = np.zeros((B, 48), np.uint32)
    hb = np.zeros(B, np.int32)
    tabs = [np.zeros((B, n), np.int32) for n in (286, 286, 30, 30)]
    for b, (bits, words, ll, lc, dl, dc) in enumerate(headers):
        hb[b] = bits
        hw[b, : len(words)] = words
        for t, a in zip(tabs, (lc, ll, dc, dl)):
            t[b] = a
    return (*tabs, hb, hw.view(np.int32))


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_pack_symbols_equals_jax(name):
    data, lengths = BATCHES[name]
    roles = jax_stage(name, "demoted")[1]
    tabs = _header_tables(jax_stage(name, "headers"))
    want = J._pack_symbols(jnp.asarray(data), jnp.asarray(lengths), roles,
                           *(jnp.asarray(t) for t in tabs))
    got = P._pack_symbols(*_port_inputs(name), tuple(_tt(r) for r in roles),
                          *(_tt(t) for t in tabs))
    # the port's int32 words hold JAX's u32 bit patterns
    _eq(got[0].to(torch.int64) & 0xFFFFFFFF,
        np.asarray(want[0]).astype(np.int64), "words")
    _eq(got[1], want[1], "total_bits")


def _fuzzed_freqs(seed):
    """Symbol counts of several shapes: dense, sparse, one symbol, none."""
    rng = np.random.default_rng(seed)
    kind = seed % 4
    fl = np.zeros(286, np.int64)
    fd = np.zeros(30, np.int64)
    if kind == 0:
        fl[:] = rng.integers(0, 5000, 286)
        fd[:] = rng.integers(0, 500, 30)
    elif kind == 1:
        used = rng.choice(286, rng.integers(2, 40), replace=False)
        fl[used] = rng.geometric(0.01, len(used))
        fd[rng.choice(30, 3, replace=False)] = rng.integers(1, 9, 3)
    elif kind == 2:
        fl[rng.integers(0, 256)] = 1000
    fl[256] += 1
    return fl.astype(np.int32), fd.astype(np.int32)


@pytest.mark.parametrize("seed", range(12))
def test_host_header_equals_jax(seed):
    fl, fd = _fuzzed_freqs(seed)
    got, want = P._host_header(fl, fd), J._host_header(fl, fd)
    assert got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_host_header_on_the_stage_frequencies(name):
    fl, fd = (np.asarray(f) for f in jax_stage(name, "demoted")[2])
    for b, want in enumerate(jax_stage(name, "headers")):
        got = P._host_header(fl[b], fd[b])
        assert got[0] == want[0]
        for g, w in zip(got[1:], want[1:]):
            assert np.array_equal(g, w)


def test_device_levels_equal_jax():
    assert P.DEVICE_LEVELS == J.DEVICE_LEVELS
