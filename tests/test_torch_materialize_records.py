"""K13 ``materialize_records``' contract on the CPU: K4-format records built
by hand, expanded by the wrapper (its plain version here) and by a
byte-by-byte LZ77 expander written below, lane by lane: the bytes, the
zeros past ``produced`` and the new window.  The kernel itself runs on the
card (``tests/test_torch_cuda.py``)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from fdeflate_tpu_torch.ops.materialize_records import materialize_records

WINDOW = 32768


def lits(*values: int) -> int:
    """A record of one or two literals (K4's ``kRecLits``)."""
    assert len(values) in (1, 2)
    word = values[0] | ((values[1] << 8) if len(values) == 2 else 0)
    return (1 << 28) | (len(values) << 16) | word


def match(length: int, dist: int) -> int:
    """A match record (K4's ``kRecMatch``)."""
    assert 3 <= length <= 258 and 1 <= dist <= WINDOW
    return (2 << 28) | ((length - 3) << 15) | (dist - 1)


EOB = 3 << 28


def expand(window: np.ndarray, recs: list[int]) -> bytes:
    """The records' bytes, one at a time, each match byte read from the
    history `d` back."""
    hist = bytearray(window.tobytes())
    for r in recs:
        kind = r >> 28
        if kind == 1:
            hist += bytes([r & 0xFF, (r >> 8) & 0xFF][: (r >> 16) & 3])
        elif kind == 2:
            length, dist = ((r >> 15) & 0xFF) + 3, (r & 0x7FFF) + 1
            for _ in range(length):
                hist.append(hist[-dist])
    return bytes(hist[WINDOW:])


def made(recs: list[int]) -> int:
    return len(expand(np.zeros(WINDOW, np.uint8), recs))


def window_of(prior: bytes) -> np.ndarray:
    """A window holding ``prior`` right-aligned, zero-filled on the left."""
    w = np.zeros(WINDOW, np.uint8)
    tail = prior[-WINDOW:]
    if tail:
        w[WINDOW - len(tail):] = np.frombuffer(tail, np.uint8)
    return w


def _noise(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).bytes(n)


def _random_lane(seed: int, n: int):
    """Literals, short and long matches, overlaps and dist-1 runs at random,
    every distance inside the history."""
    rng = np.random.default_rng(seed)
    prior = _noise(WINDOW, seed)
    recs = []
    while len(recs) < n:
        k = rng.integers(0, 4)
        if k == 0:
            recs.append(lits(*map(int, rng.integers(0, 256,
                                                    rng.integers(1, 3)))))
            continue
        length = int(rng.integers(3, 259))
        dist = (1 if k == 1 else int(rng.integers(1, min(length, 40) + 1))
                if k == 2 else int(rng.integers(1, WINDOW + 1)))
        recs.append(match(length, dist))
    return prior, recs


def _cases():
    """{case: (cap, [(prior bytes, records, produced or None), ...])}."""
    text = b"the quick brown fox jumps over the lazy dog. " * 800
    runs = [lits(7), match(258, 1), match(100, 1), lits(1, 2), match(3, 1)]
    overlap = [lits(1, 2), lits(3), match(20, 3), lits(9, 8), match(200, 5),
               match(7, 2), match(258, 31), lits(0xFF, 0)]
    far = [match(258, WINDOW), match(3, WINDOW), lits(5), match(40, WINDOW)]
    long = [lits(4, 2), match(258, 258), match(258, 600), match(258, 1000)]
    fill = [lits(0xAB), match(258, 1), match(258, 259)]
    return {
        "a dist-1 run": (1024, [(text, runs, None), (b"", runs, None)]),
        "overlaps, d < len": (1024, [(text, overlap, None),
                                      (_noise(700, 1), overlap, None)]),
        "a match exactly 32768 back": (1024, [(_noise(WINDOW, 2), far, None),
                                              (text, far, None)]),
        "a 258-byte match": (1024, [(text, long, None)]),
        "a failed lane": (1024, [(text, overlap + [EOB], 0),
                                 (text, long, None)]),
        "an empty lane": (1024, [(text, [], None), (text, runs, None)]),
        "produced equal to cap": (256, [(text, fill[:1] + [match(255, 1)],
                                         None),
                                        (text, fill, 256)]),
        "a stream shorter than the window": (
            1024, [(b"short prior", [match(11, 11), lits(3), match(30, 5)],
                    None), (b"", [lits(0x41), match(100, 1)], None)]),
        "random records": (8192, [(*_random_lane(s, 48), None)
                                  for s in range(3)]),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_materialize_records_matches_a_byte_expander(case):
    cap, lanes = _cases()[case]
    lanes = [(p, r, made(r) if n is None else n) for p, r, n in lanes]
    if case == "random records":
        lanes = [(p, r, min(n, cap)) for p, r, n in lanes]
    K = max(len(r) for _p, r, _n in lanes) + 3     # zero slots past the end
    recs = np.zeros((K, len(lanes)), np.int64)
    for j, (_p, r, _n) in enumerate(lanes):
        recs[: len(r), j] = r
    recs = recs.astype(np.uint32).view(np.int32)
    windows = np.stack([window_of(p) for p, _r, _n in lanes])
    produced = np.array([n for _p, _r, n in lanes], np.int64)
    assert produced.max() <= cap
    out, new_window = materialize_records(
        torch.from_numpy(recs), torch.from_numpy(windows),
        torch.from_numpy(produced), cap)
    assert out.shape == (len(lanes), cap) and out.dtype == torch.uint8
    for j, (_p, r, n) in enumerate(lanes):
        want = expand(windows[j], r)[:n]
        assert out[j, :n].numpy().tobytes() == want, j
        assert not out[j, n:].any(), j
        tail = (windows[j].tobytes() + want)[-WINDOW:]
        assert new_window[j].numpy().tobytes() == tail, j
    if case == "produced equal to cap":
        assert produced.tolist() == [cap, cap]
    if case == "a failed lane":
        assert not out[0].any() and torch.equal(
            new_window[0], torch.from_numpy(windows[0]))


def test_materialize_records_refuses_what_the_kernel_does_not_take():
    recs = torch.zeros(4, 2, dtype=torch.int32)
    window = torch.zeros(2, WINDOW, dtype=torch.uint8)
    produced = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="cap"):
        materialize_records(recs, window, produced, 258)
    with pytest.raises(ValueError, match="window"):
        materialize_records(recs, window[:1], produced, 256)
    with pytest.raises(ValueError, match="produced"):
        materialize_records(recs, window, produced[:1], 256)
