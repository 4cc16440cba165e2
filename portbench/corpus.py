"""The benchmark's image generator, frozen here so that later changes to
the program's copy (``fdeflate_tpu_torch/tools/corpus.py``) or to
``bench.py`` cannot move the yardstick.

``make_idat_corpus`` is ``bench.py:38`` byte for byte: 8-bit grayscale
rows 1024 px wide (smooth gradients, Gaussian texture noise, flat
patches), PNG Sub-filtered.  The noise comes from ``seed``, so every seed
gives images of the same sizes and kind.
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
