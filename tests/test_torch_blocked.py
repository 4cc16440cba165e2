"""The blocked-layout slice against the JAX package, on the CPU.

``encode_ultrafast_blocked``, ``pack_tokens`` with K9's plain version
(``pack_blocked_plain``), K8's plain version (``decode_blocked(
light=False)``), ``combine(..., group=K)`` and ``fused_ultrafast_roundtrip_v2``
are held to the JAX functions they port, over the corpora of
tests/test_pallas_decode2.py (mixed, zeros, random, idat) and a ragged
batch.  JAX's windows ``[LB, wpad, 8, 128]`` are relaid to the port's
``[L, wpad]``.  The JAX oracles are its XLA paths (``_pack_blocked`` with
``kernel_pack=False``, ``linear_from_rows(interpret=True)``) and
``decode_chunk_np``; the one interpret-mode Pallas run is the JAX v2
roundtrip in a module fixture (~17 s, at U = 4) and one
``pack_blocked_pallas`` call at S = 64 (~1 s).  All outputs are integers:
comparisons are exact.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from fdeflate_tpu.ops import pallas_pack as JP
from fdeflate_tpu.ops import ultrafast_kernel as UK
from fdeflate_tpu.ops.pallas_decode2 import decode_chunk_np
from fdeflate_tpu.ops.repack import linear_from_rows
from fdeflate_tpu.parallel import device_pipeline as JDP
from fdeflate_tpu_torch import fused_ultrafast_roundtrip_v2
from fdeflate_tpu_torch.ops.assign_pack import assign_tokens, wwin
from fdeflate_tpu_torch.ops.decode2 import (
    canon_tables,
    decode2_canon_plain,
    decode_blocked,
)
from fdeflate_tpu_torch.ops.inflate_records import lanes_from_blocked
from fdeflate_tpu_torch.ops.pack import (
    encode_blocked_v1,
    pack_blocked_plain,
    pack_tokens,
    token_offsets,
)
from fdeflate_tpu_torch.ops.repack import combine, combine_plain
from fdeflate_tpu_torch.ops.ultrafast import encode_ultrafast_blocked, lane_starts
from fdeflate_tpu_torch.trees import trained_tables
from test_pallas_decode2 import corpora

B, N, C = 2, 2048, 8
S = N // C


def _cases():
    """name -> (u8[B, N], lengths i32[B]): the four corpora at full length
    and a ragged batch (a short stream, a stream of 9 bytes)."""
    rng = np.random.default_rng(3)
    out = {k: (v, np.full(B, N, np.int32)) for k, v in corpora(rng, B, N).items()}
    rag = corpora(rng, 3, N)["idat"]
    lengths = np.array([N - 333, 9, N], np.int32)
    for b, n in enumerate(lengths):
        rag[b, n:] = 0
    out["ragged"] = (rag, lengths)
    return out


CASES = _cases()


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_windows(win) -> np.ndarray:
    """JAX ``[LB, wpad, 8, 128]`` windows as the port's ``[L, wpad]``."""
    return lanes_from_blocked(np.asarray(win).astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("name", sorted(CASES))
def test_encode_ultrafast_blocked_matches_jax(name):
    data, lengths = CASES[name]
    Bc = data.shape[0]
    win, cb, adler = encode_ultrafast_blocked(_t(data), _t(lengths), C)
    jwin, jcb, jadler = UK.encode_ultrafast_blocked(
        jnp.asarray(data), jnp.asarray(lengths), C, lut_matmul=False)
    want = _jax_windows(jwin)[: Bc * C]
    ww = wwin(S)
    assert win.shape == (Bc * C, ww) and want.shape[1] >= ww
    np.testing.assert_array_equal(win.numpy(), want[:, :ww])
    assert not want[:, ww:].any()          # JAX's wider window: zeros
    np.testing.assert_array_equal(cb.numpy(), np.asarray(jcb))
    np.testing.assert_array_equal(adler.numpy(), np.asarray(jadler).astype(np.int64))


def _jax_tokens(data, lengths, Sx: int):
    """JAX's per-byte (v, nb, at_extra) and lane-relative offsets."""
    v, nb, at_extra, _al = UK._assign_tokens(
        jnp.asarray(data), jnp.asarray(lengths), False, Sx)
    v, nb = np.asarray(v), np.asarray(nb)
    Bc, Nc = nb.shape
    lanes = nb.reshape(-1, Sx).astype(np.int64)
    rel = (np.cumsum(lanes, axis=1) - lanes).reshape(Bc, Nc)
    return v, nb, at_extra, rel


@pytest.mark.parametrize("name", sorted(CASES))
def test_pack_v1_plain_matches_jax(name):
    """pack_tokens against JAX's; K9's plain version on them against JAX's
    XLA pack (``_pack_blocked``, the TPU kernel's stated oracle); the port's
    own tokens and windows equal K1's."""
    data, lengths = CASES[name]
    Bc = data.shape[0]
    v, nb, at_extra, rel = _jax_tokens(data, lengths, S)
    tok = pack_tokens(_t(v), _t(nb), _t(rel), C)
    jtok = JP.pack_tokens(jnp.asarray(v), jnp.asarray(nb), jnp.asarray(rel), C)
    np.testing.assert_array_equal(tok.numpy(), _jax_windows(jtok)[: Bc * C])
    jwin, _jcb = UK._pack_blocked(jnp.asarray(v), jnp.asarray(nb), at_extra, C,
                                  kernel_pack=False)
    want = _jax_windows(jwin)[: Bc * C]
    got = pack_blocked_plain(tok, want.shape[1])
    np.testing.assert_array_equal(got.numpy(), want)

    t = trained_tables()
    pv, pnb, _ = assign_tokens(_t(data), _t(lengths), S, t)
    assert torch.equal(pv, _t(v).to(torch.int64))
    assert torch.equal(token_offsets(pnb, C), _t(rel).to(torch.int64))
    win1, bits1 = encode_blocked_v1(_t(data), _t(lengths), C, t)
    k1 = encode_ultrafast_blocked(_t(data), _t(lengths), C)
    assert torch.equal(win1, k1[0]) and torch.equal(bits1, k1[1].reshape(-1))


def test_pack_v1_plain_matches_the_interpreted_tpu_kernel():
    """One interpret-mode ``pack_blocked_pallas`` run at S = 64."""
    data, lengths = CASES["ragged"]
    Sx = 64
    Cx = N // Sx
    v, nb, _ax, rel = _jax_tokens(data, lengths, Sx)
    jtok = JP.pack_tokens(jnp.asarray(v), jnp.asarray(nb), jnp.asarray(rel), Cx)
    want = _jax_windows(JP.pack_blocked_pallas(jtok, 32, interpret=True))
    tok = pack_tokens(_t(v), _t(nb), _t(rel), Cx)
    got = pack_blocked_plain(tok, 32)
    np.testing.assert_array_equal(got.numpy(), want[: data.shape[0] * Cx])


def test_pack_tokens_rejects_long_lanes():
    z = torch.zeros(1, 632 * 2, dtype=torch.int64)
    with pytest.raises(ValueError, match="630"):
        pack_tokens(z, z, z, 2)
    pack_tokens(z[:, :1260], z[:, :1260], z[:, :1260], 2)   # S = 630 fits


def _corrupt(win: torch.Tensor, seed: int) -> torch.Tensor:
    win = win.clone()
    rng = np.random.default_rng(seed)
    for _ in range(6):
        win[int(rng.integers(0, win.shape[0])),
            int(rng.integers(0, win.shape[1]))] ^= int(rng.integers(1, 2**31))
    return win


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_canon_plain_matches_decode_chunk_np(name):
    """K8's plain version on every lane against the JAX numpy oracle, and
    against K3's plain version on the same windows, clean and corrupted."""
    data, lengths = CASES[name]
    win, cb, _ad = encode_ultrafast_blocked(_t(data), _t(lengths), C)
    out, bpos = decode_blocked(win, S // 4, light=False)
    for lane in range(win.shape[0]):
        want, pos = decode_chunk_np(win[lane].numpy(), S)
        np.testing.assert_array_equal(out[lane].numpy(), want)
        assert int(bpos[lane]) == pos, lane
    np.testing.assert_array_equal(out.numpy().reshape(data.shape), data)
    for w in (win, _corrupt(win, len(name))):
        got = decode_blocked(w, S // 4, light=False)
        want = decode_blocked(w, S // 4)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_decode_canon_plain_stalls_and_cuts_as_k3():
    """Windows that are mostly noise: EOB stalls, runs cut at the lane end
    and reads past the window, on lanes of several widths."""
    rng = np.random.default_rng(11)
    meta, packed = canon_tables()
    for T, ww in ((1, 1), (8, 3), (64, 13), (64, 104)):
        win = _t(rng.integers(-2**31, 2**31, (64, ww), dtype=np.int64).astype(
            np.int32))
        win[::3] &= 0x0F0F0F0F
        got = decode2_canon_plain(win, T, meta, packed)
        want = decode_blocked(win, T)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_decode_blocked_rejects_tables_without_light():
    win = torch.zeros(4, 26, dtype=torch.int32)
    with pytest.raises(ValueError, match="light"):
        decode_blocked(win, 16, light=False, tables=trained_tables())
    out, bpos = decode_blocked(win, 16, tables=trained_tables(), fast=False)
    assert not out.any() and bpos.tolist() == [2 * 64] * 4


def _jax_linear(win, cb, pos0, Bc: int, W: int):
    """The JAX XLA oracle of ``linear_from_rows``: each lane's bits shifted
    to its word offset within 8 words, placed at slab0 * 1024 + w8."""
    L, ww = win.shape
    Cc = L // Bc
    nslabs = -(-W // 1024)
    p = pos0.astype(np.int64)
    wd = p >> 5
    w8 = (wd & 1023) & ~7
    rem, sh = wd & 7, p & 31
    H = -(-(ww + 9) // 1024) + 1
    rows = np.zeros((L, H * 1024), np.uint64)
    x = win.astype(np.uint32).astype(np.uint64)
    for lane in range(L):
        nw = (int(cb[lane]) + 31) >> 5
        lo = (x[lane, :nw] << np.uint64(sh[lane])) & np.uint64(0xFFFFFFFF)
        hi = x[lane, :nw] >> np.uint64(32 - sh[lane]) if sh[lane] else 0 * lo
        rows[lane, rem[lane]: rem[lane] + nw] |= lo
        rows[lane, rem[lane] + 1: rem[lane] + nw + 1] |= hi
    slab0 = np.arange(L) // Cc * nslabs + (wd >> 10)
    out = linear_from_rows(
        jnp.asarray(rows.astype(np.uint32).view(np.int32)),
        jnp.asarray(slab0.astype(np.int32)), Bc * nslabs, H,
        w8=jnp.asarray(w8.astype(np.int32)), interpret=True)
    return np.asarray(out).reshape(Bc, nslabs * 1024)[:, :W]


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("group", [2, 8])
def test_combine_grouped_plain_matches_jax(name, group):
    """K10's plain version (``combine_plain``, the same function as K2's)
    against JAX's ``linear_from_rows`` oracle, with lanes crossing slab
    boundaries (a header offset of 1000 words and 37 bits)."""
    data, lengths = CASES[name]
    Bc = data.shape[0]
    win, cb, _ad = encode_ultrafast_blocked(_t(data), _t(lengths), C)
    pos0 = lane_starts(cb, Bc, C, 32037)[0].reshape(-1).to(torch.int32)
    W = 1024 + (13 * N + 31) // 32 + 2
    got = combine(win, cb.reshape(-1), pos0, Bc, W, group=group)
    want = _jax_linear(win.numpy(), cb.reshape(-1).numpy(), pos0.numpy(), Bc, W)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, combine_plain(win, cb.reshape(-1), pos0, Bc, W))


def test_combine_rejects_bad_groups():
    """group outside 1..32, or K10's two buffers of ``group`` lanes over a
    block's 227 KiB of shared memory."""
    bits = torch.zeros(4, dtype=torch.int32)
    for group, ww in ((0, 832), (33, 832), (32, 2000)):
        with pytest.raises(ValueError, match="group"):
            combine(torch.zeros(4, ww, dtype=torch.int32), bits, bits, 2, 100,
                    group=group)
    for group, ww in ((32, 832), (27, 2000)):
        combine(torch.zeros(4, ww, dtype=torch.int32), bits, bits, 2, 100,
                group=group)


@pytest.fixture(scope="module")
def jax_v2():
    """The JAX v2 roundtrip (interpret-mode ``_kernel_light``) on the ragged
    batch: (bytes u8[B, N], bpos_ok, ck_ok)."""
    data, lengths = CASES["ragged"]
    out_sm, bpos_ok, ck_ok = JDP.fused_ultrafast_roundtrip_v2(C, N, U=4)(
        jnp.asarray(data), jnp.asarray(lengths))
    Bc = data.shape[0]
    words = lanes_from_blocked(np.asarray(out_sm))[: Bc * C]
    return (words.view(np.uint8).reshape(Bc, N), np.asarray(bpos_ok),
            np.asarray(ck_ok))


def test_fused_ultrafast_roundtrip_v2_matches_jax(jax_v2):
    data, lengths = CASES["ragged"]
    out, bpos_ok, ck_ok = fused_ultrafast_roundtrip_v2(C, N, device="cpu")(
        data, lengths)
    np.testing.assert_array_equal(out.numpy(), jax_v2[0])
    np.testing.assert_array_equal(out.numpy(), data)
    np.testing.assert_array_equal(bpos_ok.numpy(), jax_v2[1])
    np.testing.assert_array_equal(ck_ok.numpy(), jax_v2[2])


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_ultrafast_roundtrip_v2_on_the_cpu(name):
    data, lengths = CASES[name]
    out, bpos_ok, ck_ok = fused_ultrafast_roundtrip_v2(C, N, device="cpu")(
        data, lengths)
    np.testing.assert_array_equal(out.numpy(), data)
    assert bool(bpos_ok.all()) and bool(ck_ok.all())
