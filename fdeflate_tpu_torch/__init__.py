"""fdeflate_tpu_torch — the PyTorch/CUDA port of fdeflate_tpu for Hopper GPUs.

The JAX package ``fdeflate_tpu`` is the reference; this package gives
bit-identical outputs.  This slice ports the standard-zlib, fixed-geometry
roundtrip of PNG IDAT streams (the benchmark's headline path):

    encode  K1 assign_pack -> K2 combine -> framing -> Adler-32
    decode  K3 decode2 -> exit-bit check -> decode-side Adler-32

K1-K3 are hand-written CUDA kernels (``csrc/``) launched for CUDA tensors;
CPU tensors take their plain PyTorch versions.  The package imports
``torch`` and never ``jax``; it reuses the JAX package's jax-free host
modules (``fdeflate_tpu.tables``, ``fdeflate_tpu.models.ultrafast``).

Public batch API (the caller names the device):

    compress_batch_ultra_fast(streams, with_index=C, device=...)
    zlib_encode_step(C)(data, lengths) -> words, ..., chunk_starts, eof_pos
    fused_zlib_roundtrip(C, N, device=...)(data, lengths)
"""

from .ops.ultrafast import compress_batch_ultra_fast, finalize_streams
from .parallel.device_pipeline import (
    fused_zlib_roundtrip,
    zlib_decode_step,
    zlib_encode_step,
)

__all__ = [
    "compress_batch_ultra_fast",
    "finalize_streams",
    "fused_zlib_roundtrip",
    "zlib_decode_step",
    "zlib_encode_step",
]
