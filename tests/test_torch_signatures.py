"""The port's entry points take the JAX package's call forms.

Each function below has the JAX function's positional order and keyword
names (the port adds only its keyword-only ``device=``), and a call written
for JAX runs in the port on the CPU: knobs that pick a TPU strategy are
accepted and ignored, ``try_parallel`` and the modes of
``encode_ultrafast_batch`` select what they select in JAX.
The decode shims ``decompress_speculative`` and
``decompress_batch_speculative`` are held to JAX's bytes and error classes.
``encode_ultrafast_batch``'s returns are held to JAX's XLA path on the CPU
in its three modes: one lane per stream (``num_chunks=0``), one lane with a
symbol-boundary index (``num_chunks=C``) and fixed geometry
(``fixed_geometry=True``), with and without ``return_eof``.
"""

from __future__ import annotations

import inspect
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as JG
from fdeflate_tpu.ops import adaptive as JA
from fdeflate_tpu.ops import adler32 as JAd
from fdeflate_tpu.ops import adler32_pallas as JP
from fdeflate_tpu.ops import inflate as JI
from fdeflate_tpu.ops import matchscan as JM
from fdeflate_tpu.ops import ultrafast_kernel as UK
from fdeflate_tpu.parallel import batch_speculative as JBS
from fdeflate_tpu.parallel import discovery as JDisc
from fdeflate_tpu.parallel import multihost as JMH
from fdeflate_tpu.parallel import shard as JSh
from fdeflate_tpu.parallel import speculative as JS
from fdeflate_tpu_torch import entry_points as PG
from fdeflate_tpu_torch import errors as PErr
from fdeflate_tpu_torch.ops import adaptive as PA
from fdeflate_tpu_torch.ops import adler32 as PAd
from fdeflate_tpu_torch.ops import adler32_pallas as PP
from fdeflate_tpu_torch.ops import matchscan as PM
from fdeflate_tpu_torch.ops import ultrafast as PU
from fdeflate_tpu_torch.parallel import batch_speculative as PBS
from fdeflate_tpu_torch.parallel import discovery as PDisc
from fdeflate_tpu_torch.parallel import multihost as PMH
from fdeflate_tpu_torch.parallel import shard as PSh
from fdeflate_tpu_torch.parallel import speculative as PS
from fdeflate_tpu_torch.tools.corpus import make_idat_corpus


PAIRS = {
    "encode_ultrafast_batch": (UK.encode_ultrafast_batch,
                               PU.encode_ultrafast_batch),
    "decompress_batch": (JI.decompress_batch, PDisc.decompress_batch),
    "try_foreign": (JDisc.try_foreign, PDisc.try_foreign),
    "try_foreign_batch": (JDisc.try_foreign_batch, PDisc.try_foreign_batch),
    "adler32_pallas": (JP.adler32_pallas, PP.adler32_pallas),
    "symbol_freqs": (JA.symbol_freqs, PA.symbol_freqs),
    "encode_adaptive_blocked": (JA.encode_adaptive_blocked,
                                PA.encode_adaptive_blocked),
    "compress_batch_matched": (JM.compress_batch_matched,
                               PM.compress_batch_matched),
    "compress_batch_device": (JM.compress_batch_device,
                              PM.compress_batch_device),
    "decompress_speculative": (JS.decompress_speculative,
                               PS.decompress_speculative),
    "decompress_batch_speculative": (JBS.decompress_batch_speculative,
                                     PBS.decompress_batch_speculative),
    # scale-out: the mesh, its steps, multi-host glue, the partial fold
    **{name: (getattr(JSh, name), getattr(PSh, name)) for name in (
        "make_mesh", "sharded_encode_ultrafast", "sharded_decode_symbols",
        "checksum_tree_reduce", "roundtrip_step", "roundtrip_step_v2",
        "roundtrip_step_zlib", "roundtrip_step_adaptive",
        "foreign_records_step")},
    **{name: (getattr(JMH, name), getattr(PMH, name)) for name in (
        "initialize_if_needed", "local_batch_slice", "global_mesh")},
    "combine": (JAd.combine, PAd.combine),
    "combine_jax": (JAd.combine_jax, PAd.combine_tensor),
    "adler32_partial_jax": (JAd.adler32_partial_jax, PAd.adler32_partial),
    "combine_partials_jax": (JAd.combine_partials_jax, PAd.combine_partials),
    # the entry points of __graft_entry__.py
    **{name: (getattr(JG, name), getattr(PG, name)) for name in (
        "entry", "entry_v1", "dryrun_multichip")},
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_signature_is_jax(name):
    """Same parameters in the same order; a JAX default is the port's; the
    port's only other parameter is its keyword-only ``device``."""
    jax_fn, port_fn = PAIRS[name]
    want = inspect.signature(jax_fn).parameters
    got = inspect.signature(port_fn).parameters
    positional = [p for p in got.values() if p.kind != p.KEYWORD_ONLY]
    assert [p.name for p in positional] == list(want), name
    for p in positional:
        assert p.kind == want[p.name].kind, (name, p.name)
        if want[p.name].default is not inspect.Parameter.empty:
            assert p.default == want[p.name].default, (name, p.name)
    extra = [p.name for p in got.values() if p.kind == p.KEYWORD_ONLY]
    assert extra in ([], ["device"]), (name, extra)


B, N, C = 3, 4096, 8


@pytest.fixture(scope="module")
def batch():
    data = make_idat_corpus(B, N, seed=11)
    data[1, 1000:] = 0                        # a long zero run
    lengths = np.array([N, N - 1000, 777], np.int32)
    data[2, 777:] = 0
    return data, lengths


def _u32(x) -> np.ndarray:
    """Words, bit counts and checksums of either package as u32 values."""
    return np.asarray(x).astype(np.int64) & 0xFFFFFFFF


# (num_chunks, fixed_geometry, return_eof) -> arity of JAX's tuple
MODES = {(0, False, False): 3, (0, True, True): 3, (C, False, False): 4,
         (C, False, True): 5, (C, True, False): 4, (C, True, True): 5}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_encode_ultrafast_batch_modes_equal_jax(batch, mode):
    """JAX's positional call form, (data, lengths, lut_matmul, num_chunks,
    fixed_geometry, return_eof), in both packages: the same tuple."""
    data, lengths = batch
    num_chunks, fixed, eof = mode
    want = UK.encode_ultrafast_batch(jnp.asarray(data), jnp.asarray(lengths),
                                     None, num_chunks, fixed, eof)
    got = PU.encode_ultrafast_batch(torch.from_numpy(data),
                                    torch.from_numpy(lengths), None,
                                    num_chunks, fixed, eof)
    assert len(got) == len(want) == MODES[mode]
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _u32(g), _u32(w)
        assert g.shape == w.shape, (mode, i, g.shape, w.shape)
        assert np.array_equal(g, w), (mode, i)
    kw = PU.encode_ultrafast_batch(
        torch.from_numpy(data), torch.from_numpy(lengths), lut_matmul=True,
        num_chunks=num_chunks, fixed_geometry=fixed, return_eof=eof,
        kernel_pack=True, kernel_assign=True, tree=None)
    assert all(torch.equal(a, b) for a, b in zip(kw, got))
    streams = PU.finalize_streams(*got[:3])
    for s, row, n in zip(streams, data, lengths):
        assert zlib.decompress(s) == row[:n].tobytes()


@pytest.fixture(scope="module")
def small_streams():
    raw = [bytes(range(256)) * 24, b"signature" * 50]
    return raw, [zlib.compress(r, 6) for r in raw]


def test_decompress_batch_jax_call_forms(small_streams, monkeypatch):
    raw, streams = small_streams
    assert PDisc.decompress_batch(streams, 8192, None, True, "auto",
                                  device="cpu") == raw
    assert PDisc.decompress_batch(streams, max_steps=8192, out_capacity=4096,
                                  try_parallel=True, engine="pallas",
                                  device="cpu") == raw
    # try_parallel=False keeps a stream past the discovery threshold on
    # the sequential path, as in JAX
    big_raw = np.random.default_rng(3).integers(0, 256, 50_000,
                                                dtype=np.uint8).tobytes()
    big = zlib.compress(big_raw, 0)
    assert len(big) >= PDisc._PARALLEL_MIN

    def no_discovery(*a, **k):
        raise AssertionError("block discovery ran with try_parallel=False")

    monkeypatch.setattr(PDisc, "try_foreign", no_discovery)
    monkeypatch.setattr(PDisc, "try_foreign_batch", no_discovery)
    assert PDisc.decompress_batch([big, streams[0]], 8192, None, False,
                                  device="cpu") == [big_raw, raw[0]]


def test_try_foreign_jax_call_forms(small_streams):
    raw, streams = small_streams
    default = PDisc.try_foreign(streams[0], device="cpu")
    assert default in (None, raw[0])
    assert PDisc.try_foreign(streams[0], 6144, "pallas", None, False, None,
                             device="cpu") == default
    assert PDisc.try_foreign(streams[0], max_steps=6144, engine="xla",
                             device="cpu") == default
    batch_default = PDisc.try_foreign_batch(streams, device="cpu")
    assert PDisc.try_foreign_batch(streams, 6144, "pallas",
                                   device="cpu") == batch_default
    assert PDisc.try_foreign_batch(streams, max_steps=6144, engine="auto",
                                   device="cpu") == batch_default


def test_adler32_pallas_interpret():
    data = np.random.default_rng(4).integers(0, 256, 5000, dtype=np.uint8)
    want = zlib.adler32(data[:4321].tobytes())
    t = torch.from_numpy(data)
    assert int(PP.adler32_pallas(t, 4321, True)) == want
    assert int(PP.adler32_pallas(t, length=4321, interpret=None)) == want


def test_adaptive_jax_call_forms(batch):
    data, lengths = batch
    d, ln = torch.from_numpy(data), torch.from_numpy(lengths)
    want = np.asarray(JA.symbol_freqs(jnp.asarray(data), jnp.asarray(lengths),
                                      N // C, False))
    assert np.array_equal(PA.symbol_freqs(d, ln, N // C, False).numpy(), want)
    assert np.array_equal(
        PA.symbol_freqs(d, ln, S=N // C, lut_matmul=True).numpy(), want)
    default = PA.encode_adaptive_blocked(d, ln, C)
    for got in (PA.encode_adaptive_blocked(d, ln, C, False, False),
                PA.encode_adaptive_blocked(d, ln, num_chunks=C,
                                           lut_matmul=True,
                                           kernel_assign=True)):
        for a, b in zip(got[:4], default[:4]):
            assert torch.equal(a, b)


def _shim_streams():
    small = zlib.compress(b"hello world " * 40, 6)
    return [small, zlib.compress(b"", 6), small[: len(small) // 2],
            small[:-1] + bytes([small[-1] ^ 1]),
            zlib.compress(bytes(range(256)) * 8, 9)]


@pytest.fixture(scope="module")
def shim_results():
    streams = _shim_streams()
    return streams, JBS.decompress_batch_speculative(streams, 8, 2048)


def _same(got, want):
    if isinstance(want, bytes):
        return got == want
    return type(got).__name__ == type(want).__name__


def test_decompress_batch_speculative_equals_jax(shim_results):
    """Bytes or error class per stream, in JAX's positional form (a third
    argument binds ``max_steps``) and by keyword."""
    streams, want = shim_results
    assert [type(w).__name__ for w in want] == [
        "bytes", "bytes", "InsufficientInput", "WrongChecksum", "bytes"]
    for got in (PBS.decompress_batch_speculative(streams, 8, 2048,
                                                 device="cpu"),
                PBS.decompress_batch_speculative(
                    streams, chunks_per_stream=3, max_steps=2048,
                    device="cpu")):
        assert all(_same(g, w) for g, w in zip(got, want, strict=True))


def test_decompress_speculative_equals_jax(shim_results):
    """The bytes, or JAX's error raised."""
    streams, want = shim_results
    for s, w in zip(streams, want):
        if isinstance(w, bytes):
            assert PS.decompress_speculative(s, 4, 2.0, device="cpu") == w
        else:
            with pytest.raises(PErr.DecompressionError) as err:
                PS.decompress_speculative(s, device="cpu")
            assert type(err.value).__name__ == type(w).__name__
