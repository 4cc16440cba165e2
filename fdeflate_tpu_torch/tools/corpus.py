"""The corpora of the port's checks and timings.

``make_idat_corpus`` is ``bench.py:38`` byte for byte (the JAX benchmark's
corpus); the four 1 MiB byte distributions ``gen_uniform``, ``gen_low``,
``gen_mixture`` and ``gen_distribution`` are ``bench/distributions.py:29-62``
and ``corpora`` is the five-corpus list of ``bench/sizes.py:32-43`` (the
size tables' corpora).  They are kept here so that neither the port nor
``chip_smoke.py`` imports ``bench`` (which imports jax when
``JAX_PLATFORMS`` is set).  tests/test_torch_hostcopies.py holds each equal
to its original.
"""

from __future__ import annotations

import numpy as np


def make_idat_corpus(batch: int, length: int, seed: int = 0) -> np.ndarray:
    """Filtered-PNG IDAT-like bytes.

    Synthesizes grayscale image rows (smooth gradients + texture noise +
    flat regions) and applies the PNG Sub filter per row — producing the
    real workload shape: long zero runs from flat areas and small signed
    residuals elsewhere.
    """
    rng = np.random.default_rng(seed)
    width = 1024
    rows = length // width + 1
    out = np.zeros((batch, rows * width), np.uint8)
    for b in range(batch):
        y = np.arange(rows)[:, None]
        x = np.arange(width)[None, :]
        base = (
            128
            + 60 * np.sin(x / (50 + 10 * (b % 7)) + b)
            + 40 * np.cos(y / 37.0)
        )
        noise = rng.normal(0, 2.0, (rows, width))
        flat = (x // 128 + y // 16) % 3 == 0  # flat patches -> zero runs
        img = np.where(flat, 200, base + noise).astype(np.uint8)
        # PNG Sub filter: residual against the left neighbor.
        sub = img - np.roll(img, 1, axis=1)
        sub[:, 0] = img[:, 0]
        out[b] = sub.reshape(-1)[: rows * width]
    return out[:, :length]


MB = 1024 * 1024


def gen_uniform(rng):
    return rng.integers(0, 256, MB, dtype=np.uint8)


def gen_low(rng):
    return ((rng.integers(0, 16, MB, dtype=np.uint8) * 2) - 16).astype(np.uint8)


def gen_mixture(rng):
    data = (rng.integers(0, 32, MB, dtype=np.int64) - 16).astype(np.uint8)
    mask = rng.integers(0, 200, MB) == 1
    data[mask] = rng.integers(0, 256, int(mask.sum()), dtype=np.uint8)
    return data


def gen_distribution(rng):
    sel = rng.integers(0, 100, MB)
    data = np.zeros(MB, np.uint8)
    for lo, hi, width, offset in [(1, 3, 32, 16), (11, 51, 16, 8), (51, 81, 8, 4)]:
        mask = (sel >= lo) & (sel < hi)
        data[mask] = (
            rng.integers(0, width, int(mask.sum()), dtype=np.int64) - offset
        ).astype(np.uint8)
    mask = sel == 0
    data[mask] = rng.integers(0, 256, int(mask.sum()), dtype=np.uint8)
    return data


def corpora() -> list[tuple[str, bytes]]:
    """The five 1 MiB corpora of the size tables, (name, bytes)."""
    rng = np.random.default_rng(0)
    out = [
        ("uniform_random", gen_uniform(rng).tobytes()),
        ("low", gen_low(rng).tobytes()),
        ("mixture", gen_mixture(rng).tobytes()),
        ("distribution", gen_distribution(rng).tobytes()),
    ]
    out.append(("png_idat", make_idat_corpus(1, 1 << 20)[0].tobytes()))
    return out
