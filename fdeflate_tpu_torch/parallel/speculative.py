"""``decompress_speculative``: one zlib stream through ``decompress_batch``.

JAX counterpart: ``fdeflate_tpu/parallel/speculative.py:43``, a shim over
the JAX package's engine-selection batch decoder since its speculative
chunked decode was retired (its module docstring gives the measurements).
The port's ``decompress_batch`` (``parallel/discovery.py``) routes each
stream as JAX's does: block discovery for large streams, the sequential
path for the rest.
"""

from __future__ import annotations

from .. import errors as E
from .discovery import decompress_batch


def decompress_speculative(data: bytes, num_chunks: int = 16,
                           chunk_symbol_slack: float = 1.25, *,
                           device="cuda") -> bytes:
    """Decode one zlib stream on ``device``; raises its decode error.

    ``num_chunks`` and ``chunk_symbol_slack`` are accepted for the JAX
    package's call form and ignored, as there.
    """
    del num_chunks, chunk_symbol_slack
    out = decompress_batch([data], device=device)[0]
    if isinstance(out, E.DecompressionError):
        raise out
    return out
