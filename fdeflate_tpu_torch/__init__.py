"""fdeflate_tpu_torch — the PyTorch/CUDA port of fdeflate_tpu for Hopper GPUs.

The JAX package ``fdeflate_tpu`` is the reference; this package gives
bit-identical outputs.  Eight slices are ported:

* the standard-zlib, fixed-geometry roundtrip of PNG IDAT streams (the
  benchmark's headline path):

      encode  K1 assign_pack -> K2 combine -> framing -> K7 Adler-32
      decode  K3 decode2 -> exit-bit check -> decode-side Adler-32

* decoding foreign zlib streams (any encoder, no chunk index):

      discovery  stage 1 (torch, every bit offset) -> K5 validate_headers
      decode     K4 inflate_records (one block per lane) -> chain walk
                 -> materialize (torch) -> K7 Adler-32
      sequential K4 per block, host header parsing between launches

* runtime trees (slice 3): the class-separated "septree" profile
  (``tree=sep_profile()`` on the codec's steps: K1/K2 with the profile's
  codes and header, decode by K6 decode_sep), the per-batch adaptive tree
  (tree built on the device, K1 and K3 with its runtime tables), and the
  checksum entry point ``adler32_pallas`` (K7 adler32_tiles, which also
  computes every per-stream Adler-32 of the encodes and the stitch)

* the blocked layout (slice 4): ``fused_ultrafast_roundtrip_v2``
  (``encode_ultrafast_blocked``: K1 into lane windows; ``decode_blocked``:
  K3 on each window), and the A/B kernels of that layout: K8 decode2_canon
  (``decode_blocked(light=False)``), K9 pack_v1 (``ops/pack.py``) and K10
  combine_grouped (``combine(..., group>1)``)

* the indexed chunk-parallel decode (slice 5): streams encoded in one lane
  with an exact chunk index (``compress_batch_ultra_fast(with_index=C)``)
  decode in C lanes each from the index's bits:

      decode  K11 decode_symbols (a thread per lane, the table-gather
              symbol engine; each lane's records up to its step count)
              -> one flat list of the records, stream by stream
              -> materialize (torch) -> Adler-32 (host, or K7 in
              ``fused_ultrafast_roundtrip``)

* the device match finder (slice 6): the general levels 1-3, LZ77 matches
  found on the device and one dynamic block per stream:

      stage 1    hash sort -> k-predecessor probe -> greedy tiling ->
                 merged chains -> roles and frequencies (torch)
      host       first-pass trees; stage 1.5 segment demotion (torch);
                 code lengths, the dynamic headers
      stage 2    bit packing (torch) -> K7 Adler-32 -> used words read back

* scale-out (slice 7): the ("streams", "seq") mesh on ``torch.distributed``
  (NCCL on the card, gloo for CPU processes) in ``parallel/shard.py``
  (``make_mesh`` and JAX's eight sharded steps, each the port's
  single-device function on every rank's shard, with JAX's collectives:
  the streams' checksums folded from ``(A, B, len)`` partials over
  ``seq``, verified-byte totals summed over ``streams``),
  ``parallel/multihost.py`` (torchrun's environment, ``spawn_world``) and
  the entry points of ``entry_points.py`` (``__graft_entry__.py``'s)

* the host streaming codec (slice 8), the JAX package's top-level API in
  ``models/`` (numpy, with the native C++ backend of ``native/`` loaded
  by ``models/native.py``): ``Compressor`` (levels 0-9, ``new_rle``),
  ``UltraFastCompressor``, the resumable ``Decompressor`` and the
  ``*_to_vec`` functions.  Whole-buffer decodes go to the native backend;
  without it, inputs of 256 KiB or more go to ``decompress_batch`` on the
  card (K5, K4, K7), with no fallback around the call

K1-K11 are hand-written CUDA kernels (``csrc/``) launched for CUDA
tensors; CPU tensors take their plain PyTorch versions.  The package
imports ``torch`` and nothing of ``jax`` or of the JAX package: the host
modules it needs are its own copies (``errors``, ``tables``, ``huffman``,
``ops/septree``, ``ops/inflate_host``, ``ops/bitio``, ``models/``), held equal
to the originals by tests/test_torch_hostcopies.py and
tests/test_torch_hostcodec.py.

The host API, as in the JAX package (``device`` only where a decode may
take the card's route):

    compress_to_vec(data), compress_to_vec_with_level(data, level),
    compress_to_vec_rle(data), compress_to_vec_ultra_fast(data) -> zlib bytes
    Compressor(sink=None, level=1, zlib_mode=True), Compressor.new_rle(),
    UltraFastCompressor(sink=None): write_data, flush, finish
    Decompressor(): read(input, output, output_position)
        -> (consumed, produced); ignore_adler32(), is_done()
    decompress_to_vec(input, device=...)
    decompress_to_vec_bounded(input, maxlen, device=...)
        -> bytes; raises DecompressionError (its subclasses by name) or
           OutputTooLarge (with ``partial_output``)
    compute_code_lengths(freqs, min_limit, max_limit), Status

Public API (``device`` is "cuda" unless the caller asks for "cpu"; without
CUDA a call that leaves it raises RuntimeError).  Every function takes the
JAX package's call forms, its positional order and keyword names; knobs
that pick a TPU strategy (``lut_matmul``, ``kernel_pack``, ``engine``,
``interpret``, ...) are accepted and ignored:

    compress_batch_ultra_fast(streams, with_index=C, device=...)
    zlib_encode_step(C, tree=None)(data, lengths)
        -> words, ..., chunk_starts, eof_pos
    fused_zlib_roundtrip(C, N, tree=None, device=...)(data, lengths)
    fused_ultrafast_roundtrip_v2(C, N, device=...)(data, lengths)
        -> out, bpos_ok, ck_ok
    fused_adaptive_roundtrip(C, N, device=...)(data, lengths)
        -> out, bpos_ok, ck_ok, total_bits
    fused_ultrafast_roundtrip(C, max_steps, N, device=...)(data, lengths)
        -> out, produced, ok, checksum_ok
    decompress_batch_indexed(streams, index, device=...) -> bytes per stream
    adler32_pallas(data, length=None, interpret=None) -> int64 0-d tensor
    decompress_batch(streams, max_steps=8192, out_capacity=None,
                     try_parallel=True, engine="auto", device=...)
        -> bytes or error per stream
    decompress_foreign(data, device=...) -> bytes (raises the decode error)
    try_foreign(data, device=...) / try_foreign_batch(streams, device=...)
        -> bytes, or None where the block-parallel path cannot decode
    decompress_speculative(data, device=...) -> bytes (raises the error)
    decompress_batch_speculative(streams, chunks_per_stream=8,
                                 max_steps=8192, device=...)
        -> bytes or error per stream (shims over decompress_batch)
    compress_batch_matched(streams, depth=2, min_match=4, backext=True,
                           passes=2, device=...) -> zlib bytes per stream
    compress_batch_device(streams, level=2, device=...)
        -> zlib bytes per stream (levels 1-3: probe depth 4, 8, 16;
           level 0 encodes as 1 and levels above 3 as 3, as in JAX)
    entry(device=...) -> fwd, (data, lengths): the v2 roundtrip's sums
    entry_v1(device=...) -> step, (data, lengths): one-lane encode and
        decode_symbols -> (out_pos, status, adler)
    dryrun_multichip(n_devices, device=...): every sharded step on an
        n-rank mesh, asserted (gloo processes for "cpu")

The mesh and its steps are in ``fdeflate_tpu_torch.parallel.shard``, as in
the JAX package; the three entry points live in
``fdeflate_tpu_torch.entry_points``.
"""

from .entry_points import dryrun_multichip, entry, entry_v1
from .errors import (
    BadCodeLengthHuffmanTree,
    BadDistanceHuffmanTree,
    BadLiteralLengthHuffmanTree,
    BadZlibHeader,
    DecompressionError,
    DistanceTooFarBack,
    ExtraInput,
    InputStartsWithRun,
    InsufficientInput,
    InvalidBlockType,
    InvalidCodeLengthRepeat,
    InvalidDistanceCode,
    InvalidHdist,
    InvalidHlit,
    InvalidLiteralLengthCode,
    InvalidUncompressedBlockLength,
    OutputTooLarge,
    Status,
    WrongChecksum,
)
from .huffman import compute_code_lengths
from .models.compressor import (
    Compressor,
    compress_to_vec,
    compress_to_vec_rle,
    compress_to_vec_ultra_fast,
    compress_to_vec_with_level,
)
from .models.decompressor import (
    Decompressor,
    decompress_to_vec,
    decompress_to_vec_bounded,
)
from .models.ultrafast import UltraFastCompressor
from .ops.adler32_pallas import adler32_pallas
from .ops.matchscan import compress_batch_device, compress_batch_matched
from .ops.septree import sep_profile
from .ops.ultrafast import compress_batch_ultra_fast, finalize_streams
from .parallel.device_pipeline import (
    decompress_batch_indexed,
    fused_adaptive_roundtrip,
    fused_ultrafast_roundtrip,
    fused_ultrafast_roundtrip_v2,
    fused_zlib_roundtrip,
    zlib_decode_step,
    zlib_encode_step,
)
from .parallel.batch_speculative import decompress_batch_speculative
from .parallel.discovery import (
    decompress_batch,
    decompress_foreign,
    try_foreign,
    try_foreign_batch,
)
from .parallel.speculative import decompress_speculative

__all__ = [
    # the host API (the JAX package's __all__)
    "Compressor",
    "UltraFastCompressor",
    "Decompressor",
    "compress_to_vec",
    "compress_to_vec_with_level",
    "compress_to_vec_rle",
    "compress_to_vec_ultra_fast",
    "decompress_to_vec",
    "decompress_to_vec_bounded",
    "compute_code_lengths",
    "DecompressionError",
    "OutputTooLarge",
    "Status",
    # the device API
    "adler32_pallas",
    "compress_batch_device",
    "compress_batch_matched",
    "compress_batch_ultra_fast",
    "decompress_batch",
    "decompress_batch_indexed",
    "decompress_batch_speculative",
    "decompress_foreign",
    "decompress_speculative",
    "dryrun_multichip",
    "entry",
    "entry_v1",
    "finalize_streams",
    "fused_adaptive_roundtrip",
    "fused_ultrafast_roundtrip",
    "fused_ultrafast_roundtrip_v2",
    "fused_zlib_roundtrip",
    "sep_profile",
    "try_foreign",
    "try_foreign_batch",
    "zlib_decode_step",
    "zlib_encode_step",
]
