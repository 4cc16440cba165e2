"""The benchmark's RGB thumbnail generator: real PNG IDAT rows, each row's
filter-type byte first, for 8-bit RGB images of a given width and height.

The content is synthetic, of the frozen corpus's kind (``corpus.py``):
per channel a smooth gradient field, Gaussian texture noise and flat
patches, each channel its own field.  Each row is filtered as Pillow
filters RGB (libpng's heuristic): of the five PNG filters, the one whose
residuals, read as signed bytes, have the least sum of absolute values,
the lowest filter type on a tie.  Every filter reads the unfiltered row
above, so the choice is made for all rows of all images at once.
"""

from __future__ import annotations

import numpy as np

BPP = 3                 # bytes per pixel: 8-bit RGB
PAETH = 4               # the last of the five filter types, None to Paeth
NOISE_STD = 3.0         # the frozen corpus's is 2.0 (see rgb_fields)
FILTER_BATCH = 64       # images filtered at a time, to bound the memory


def rgb_fields(n: int, width: int, height: int, seed: int = 0) -> np.ndarray:
    """u8[n, height, width * 3]: the unfiltered images, channels
    interleaved (R, G, B of a pixel in a row).  Channel c of image b is
    ``corpus.make_idat_corpus``' field for the index 3 b + c at this size,
    its row term phase-shifted by c, its flat patches 16 x 16, and its
    noise of sigma ``NOISE_STD``: with the frozen corpus's 2.0 a 128 x 128
    image compresses at level 6 into one block, with 3.0 into two, the
    second reaching back into the first."""
    rng = np.random.default_rng(seed)
    y = np.arange(height)[:, None]
    x = np.arange(width)[None, :]
    flat = (x // 16 + y // 16) % 3 == 0             # flat patches
    out = np.empty((n, height, width, BPP), np.uint8)
    for b in range(n):
        for c in range(BPP):
            k = BPP * b + c
            base = (128 + 60 * np.sin(x / (50 + 10 * (k % 7)) + k)
                    + 40 * np.cos(y / 37.0 + c))
            noise = rng.normal(0, NOISE_STD, (height, width))
            field = np.where(flat, 200, base + noise)
            out[b, :, :, c] = field.astype(np.uint8)
    return out.reshape(n, height, width * BPP)


def filter_residuals(img: np.ndarray) -> np.ndarray:
    """u8[..., 5, H, R]: every row of u8[..., H, R] images under each of the
    five PNG filters (PNG spec 9.2-9.4; the row above the first and the
    bytes left of a row's first pixel read 0)."""
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[..., BPP:] = x[..., :-BPP]                      # left
    b = np.zeros_like(x)
    b[..., 1:, :] = x[..., :-1, :]                    # above
    c = np.zeros_like(x)
    c[..., BPP:] = b[..., :-BPP]                      # above left
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    pred = np.stack([np.zeros_like(x), a, b, (a + b) // 2, paeth], axis=-3)
    return (x[..., None, :, :] - pred).astype(np.uint8)


def choose_filters(residuals: np.ndarray) -> np.ndarray:
    """int[..., H]: per row, the filter whose residuals, as signed bytes,
    have the least sum of absolute values (the first on a tie)."""
    signed = residuals.view(np.int8).astype(np.int16)
    cost = np.abs(signed).sum(axis=-1, dtype=np.int32)   # [..., 5, H]
    return cost.argmin(axis=-2)


def filtered_rows(img: np.ndarray) -> np.ndarray:
    """u8[n, H * (1 + R)]: the IDAT bytes of u8[n, H, R] images before
    deflate, each row its filter type and then its residuals."""
    res = filter_residuals(img)                       # [n, 5, H, R]
    kind = choose_filters(res)                        # [n, H]
    rows = np.take_along_axis(res, kind[:, None, :, None], axis=1)[:, 0]
    n, H, R = img.shape
    out = np.empty((n, H, 1 + R), np.uint8)
    out[..., 0] = kind
    out[..., 1:] = rows
    return out.reshape(n, H * (1 + R))


def make_rgb_thumbnails(n: int, width: int = 128, height: int = 128,
                        seed: int = 0) -> np.ndarray:
    """u8[n, height * (1 + 3 * width)]: the filtered IDAT bytes of ``n``
    8-bit RGB images."""
    img = rgb_fields(n, width, height, seed)
    return np.concatenate([filtered_rows(img[i: i + FILTER_BATCH])
                           for i in range(0, n, FILTER_BATCH)])
