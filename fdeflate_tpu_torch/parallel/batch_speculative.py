"""``decompress_batch_speculative``: a batch through ``decompress_batch``.

JAX counterpart: ``fdeflate_tpu/parallel/batch_speculative.py:18``, a shim
over the JAX package's engine-selection batch decoder (see
``parallel/speculative.py``).  The signature is JAX's, so a third
positional argument binds ``max_steps``.
"""

from __future__ import annotations

from .. import errors as E
from .discovery import decompress_batch


def decompress_batch_speculative(
    streams: list[bytes],
    chunks_per_stream: int = 8,
    max_steps: int = 8192,
    *,
    device="cuda",
) -> list[bytes | E.DecompressionError]:
    """Decode many zlib streams on ``device``; the bytes or the error per
    stream.  ``chunks_per_stream`` is accepted and ignored, as in JAX."""
    del chunks_per_stream
    return decompress_batch(streams, max_steps=max_steps, device=device)
