"""Edge inputs of K1 (assign_pack) and K3 (decode2).

K1 and K3 put a warp on each lane: thread segments, staged tiles and
spans have edges the headline corpus may never hit.  These batches put
runs and stalls on them.  ``chip_smoke.py`` holds both kernels to their
plain versions on them; tests/test_torch_lanes_host.py holds the kernels'
per-thread code, run for m threads on the host, to the same.
"""

from __future__ import annotations

import numpy as np
import torch

from .corpus import make_idat_corpus


def _ragged(d: np.ndarray, lengths) -> np.ndarray:
    for b, n in enumerate(lengths):
        d[b, n:] = 0
    return d


def edge_runs(B: int, N: int, seed: int) -> np.ndarray:
    """Nonzero filler with zero runs of 258 n - 1, 258 n and 258 n + 1
    bytes (n = 1..3) starting and ending on 64-byte segment edges and on
    2048-byte tile edges, a run of one whole segment, one of a whole tile,
    and runs crossing a tile edge."""
    rng = np.random.default_rng(seed)
    d = rng.integers(1, 256, (B, N)).astype(np.uint8)
    for b in range(B):
        runs = [258 * n + e for n in (1, 2, 3) for e in (-1, 0, 1)]
        rng.shuffle(runs)
        edges = np.arange(64, N - 1024, 64 * int(rng.integers(5, 12)))
        for at, r in zip(edges, runs * 4):
            if rng.random() < 0.5:       # end on the edge
                d[b, max(at - r, 0):at] = 0
            else:                        # start on it
                d[b, at:at + r] = 0
        if N >= 8192:
            d[b, 4096:6144] = 0          # a whole tile
            d[b, 2048 - 300:2048 + 301] = 0
            d[b, 6144 - 64:6144 + 5] = 0
        d[b, 128:192] = 0                # a whole segment
    return d


def k1_edge_inputs():
    """[(label, u8[B, N], lengths, C)]: the batches K1 is held to its plain
    version on (S % 8 == 0)."""
    rng = np.random.default_rng(40)
    zeros = np.zeros((2, 8192), np.uint8)
    noruns = rng.integers(1, 256, (2, 8192)).astype(np.uint8)
    sparse = np.where(rng.random((2, 4096)) < 0.5, 0,
                      rng.integers(0, 256, (2, 4096))).astype(np.uint8)
    head = make_idat_corpus(3, 8192, seed=41)
    head[:, :40] = 0                     # a run opening lane 0 (k = 0)
    head[1, 2047] = 0                    # lane 1 entered after a zero byte
    head[1, 2048:2060] = 0
    return [
        ("all zeros, ragged", _ragged(zeros, [8192, 8179]), [8192, 8179], 4),
        ("random bytes, no runs", _ragged(noruns, [8192, 5003]), [8192, 5003], 4),
        ("runs of 258n-1..258n+1 on segment and tile edges, S = 4096",
         edge_runs(3, 16384, 42), [16384] * 3, 4),
        ("S = 8", _ragged(sparse, [4096, 4091]), [4096, 4091], 512),
        ("lanes past the stream's length, runs at lane 0",
         _ragged(head, [8192, 8192, 1000]), [8192, 8192, 1000], 8),
    ]


def k1_long_lane():
    """One 1 MiB lane (C = 1, as ``compress_batch_ultra_fast`` runs K1)."""
    return ("C = 1, one 1 MiB lane", make_idat_corpus(1, 1 << 20, seed=43),
            [1 << 20], 1)


def corrupt_words(words: torch.Tensor, total_bits: torch.Tensor, n: int,
                  seed: int) -> torch.Tensor:
    """A copy of the stream words with ``n`` random payload words per stream
    XORed with random nonzero values."""
    rng = np.random.default_rng(seed)
    w = words.clone()
    for b in range(w.shape[0]):
        hi = max(2, int(total_bits[b]) // 32)
        idx = torch.from_numpy(rng.integers(1, hi, n)).to(w.device)
        val = torch.from_numpy(rng.integers(1, 2**31, n).astype(np.int32))
        w[b, idx] ^= val.to(w.device)
    return w


def splice_eob(words: torch.Tensor, bit: int, row: int, code: int,
               nbits: int) -> torch.Tensor:
    """A copy of ``words`` with the ``nbits``-bit EOB code written at
    absolute bit ``bit`` of ``row`` (LSB first)."""
    w = words.clone()
    for i in range(nbits):
        p = bit + i
        cur = int(w[row, p >> 5]) & 0xFFFFFFFF
        if (code >> i) & 1:
            cur |= 1 << (p & 31)
        else:
            cur &= ~(1 << (p & 31))
        w[row, p >> 5] = cur - (1 << 32) if cur >= 1 << 31 else cur
    return w


def mid_lane_bit(data: torch.Tensor, lengths: torch.Tensor, C: int, t,
                 starts: torch.Tensor, lane: int) -> int:
    """Absolute bit of a symbol boundary in the middle of ``lane``: where
    the first byte at or past the lane's middle that emits a symbol puts
    it."""
    from ..ops.assign_pack import assign_tokens, token_symbols

    B, N = data.shape
    S = N // C
    _v, nb, _x = assign_tokens(data, lengths, S, t)
    b, k = divmod(lane, C)
    nb = nb[b, k * S:(k + 1) * S]
    sym = token_symbols(data, lengths, S)[b, k * S:(k + 1) * S]
    j = S // 2 + int(torch.nonzero(sym[S // 2:] >= 0)[0, 0])
    return int(starts.reshape(-1)[lane]) + int(nb[:j].sum())


def k3_edge_cases(data: torch.Tensor, lengths: torch.Tensor, C: int):
    """K3's inputs from one K1 edge batch on its device, with the trained
    tree: [(label, words, chunk_starts, dtab, N, C, clean bytes or None)]
    for the clean streams, 64 words corrupted per stream, an EOB spliced
    into the middle of lane 1, random unordered chunk starts (wrong span
    hints) and, for S = 8, lanes of 4 bytes (K1's windows read 4 bytes,
    and random ordered starts)."""
    from ..parallel.device_pipeline import zlib_encode_step
    from ..trees import trained_tables

    dev = data.device
    t = trained_tables(str(dev))
    B, N = data.shape
    S = N // C
    words, tb, _ad, starts, _eof = zlib_encode_step(C)(data, lengths)
    cases = [("clean", words, starts, N, C, data),
             ("64 words corrupted per stream", corrupt_words(words, tb, 64, 3),
              starts, N, C, None)]
    if int(lengths[0]) > S + S // 2 + 8:
        bit = mid_lane_bit(data.cpu(), lengths.cpu(), C, trained_tables(),
                           starts.cpu(), 1)
        cases.append(("EOB spliced into lane 1",
                      splice_eob(words, bit, 0, t.eof_code, t.eof_bits),
                      starts, N, C, None))
    rng = np.random.default_rng(4)
    rand = rng.integers(0, int(tb.max()) + 64, (B, C)).astype(np.int32)
    cases.append(("random unordered starts", words,
                  torch.from_numpy(rand).to(dev), N, C, None))
    if S == 8:
        from ..ops.assign_pack import assign_pack

        win, _b = assign_pack(data, lengths, C, t)
        cases.append(("S = 4: K1's windows", win,
                      torch.zeros(win.shape[0], 1, dtype=torch.int32,
                                  device=dev), 4, 1, None))
        st = np.sort(rng.integers(0, int(tb.min()), (B, N // 4)), axis=1)
        cases.append(("S = 4: random ordered starts", words,
                      torch.from_numpy(st.astype(np.int32)).to(dev), N,
                      N // 4, None))
    return [(lab, w, s, t.dtab, n, c, want) for lab, w, s, n, c, want in cases]
