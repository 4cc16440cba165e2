"""Port tree tables (fdeflate_tpu_torch.trees) against the JAX package's.

Integer tables, so every comparison is exact.
"""

from __future__ import annotations

import numpy as np
import pytest

from fdeflate_tpu.models.ultrafast import STREAM_HEADER, STREAM_HEADER_BITS
from fdeflate_tpu.ops import pallas_assign as PA
from fdeflate_tpu.ops import pallas_decode2 as PD
from fdeflate_tpu.ops.septree import kernel_tree
from fdeflate_tpu.ops.ultrafast_kernel import _header_words
from fdeflate_tpu.tables import HUFFMAN_CODES, HUFFMAN_LENGTHS
from fdeflate_tpu_torch import trees


def _zigzag(b: int) -> int:
    return 2 * b if b < 128 else 2 * (256 - b) - 1


def _unpack16(rows: np.ndarray, i: int) -> int:
    return (int(rows[i >> 1]) >> (16 * (i & 1))) & 0xFFFF


def _tok12(entry: int) -> int:
    """JAX kernel table entry (code | len << 12) -> port token format."""
    return (entry & 0xFFF) | ((entry >> 12) << trees.NB_SHIFT)


def test_encode_tokens_match_assign_kernel_tables():
    t = trees.trained_tables()
    ztab, lentab = PA._const_tables()
    lit = t.lit_tok.numpy()
    for b in range(256):
        assert lit[b] == _tok12(_unpack16(ztab, _zigzag(b))), b
    ln = t.len_tok.numpy()
    for s in range(29):
        assert ln[s] == _tok12(_unpack16(lentab, s)), s
    # The kernels' zero-literal and 285-run tokens, taken from the tables.
    assert int(t.lit_tok[0]) == PA._C0 | (PA._L0 << 13)
    assert int(t.len_tok[28]) + (1 << 13) == PA._C285 | ((PA._L285 + 1) << 13)
    assert (t.eof_code, t.eof_bits) == (int(HUFFMAN_CODES[256]),
                                        int(HUFFMAN_LENGTHS[256]))


def test_runtime_tree_tokens_match_runtime_tables():
    import jax.numpy as jnp

    lens, codes = kernel_tree()
    t = trees.tree_tables(codes, lens)
    ztab, ltab, zlit, t285 = (np.asarray(x) for x in PA.runtime_tables(
        jnp.asarray(codes.astype(np.int32)), jnp.asarray(lens.astype(np.int32))))
    for b in range(256):
        assert t.lit_tok[b] == _tok12(_unpack16(ztab, _zigzag(b))), b
    for s in range(29):
        assert t.len_tok[s] == _tok12(_unpack16(ltab, s)), s
    assert (int(t.lit_tok[0]), int(t.len_tok[28]) + (1 << 13)) == (
        int(zlit), int(t285))


def test_header_words_match_jax():
    got = trees.header_words(STREAM_HEADER, STREAM_HEADER_BITS, 16)
    np.testing.assert_array_equal(got.view(np.uint32), _header_words(16))
    t = trees.trained_tables()
    nh = t.header.shape[0]
    np.testing.assert_array_equal(t.header.numpy(), got[:nh])
    assert not got[nh:].any()


def _incomplete_lengths() -> np.ndarray:
    lens = np.asarray(HUFFMAN_LENGTHS, np.int64).copy()
    lens[np.nonzero(lens == 12)[0][-3:]] = 0   # free part of the code space
    return lens


LENGTH_SETS = {
    "trained": lambda: np.asarray(HUFFMAN_LENGTHS, np.int64),
    "septree": lambda: kernel_tree()[0],
    "incomplete": _incomplete_lengths,
}


@pytest.mark.parametrize("which", sorted(LENGTH_SETS))
def test_canonical_meta_matches_jax(which):
    lens = LENGTH_SETS[which]()
    key = None if which == "trained" else tuple(int(x) for x in lens)
    jb, jk, jp = PD.canonical_meta(key)
    pb, pk, pp = trees.canonical_meta(lens)
    assert tuple(pb.tolist()) == tuple(jb) and tuple(pk.tolist()) == tuple(jk)
    np.testing.assert_array_equal(pp.numpy(), jp)


@pytest.mark.parametrize("which", sorted(LENGTH_SETS))
def test_decode_table_is_the_canonical_rule_on_every_peek(which):
    """Every 12-bit peek, valid or not, gets the entry the TPU kernel's
    canonical rule (pallas_decode2.decode_chunk_np) gives it."""
    lens = LENGTH_SETS[which]()
    key = None if which == "trained" else tuple(int(x) for x in lens)
    bounds, kvals, packed = PD.canonical_meta(key)
    dtab = trees.decode_table(lens).numpy()
    for peek in range(4096):
        r12 = PD._bitrev12_np(peek)
        L = 1 + sum(r12 >= bounds[l] for l in range(1, 12))
        idx = kvals[L] + (r12 >> (12 - L))
        want = int(packed[idx]) if idx < len(packed) else 0
        assert int(dtab[peek]) == want | (L << 16), peek


def test_decode_table_literals_agree_with_numpy_oracle():
    """Literal peeks decode to the oracle's byte and bit count."""
    dtab = trees.trained_tables().dtab.numpy()
    for peek in range(0, 4096, 7):
        e = int(dtab[peek])
        if (e >> 13) & 3 != trees.CLS_LIT:
            continue
        out, bits = PD.decode_chunk_np(np.array([peek], np.uint32), 1)
        assert (int(out[0]), bits) == (e & 0x1FF, (e >> 16) & 0x1F), peek
