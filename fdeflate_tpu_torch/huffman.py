"""Huffman code lengths for the port's septree profile.

Copies of two functions of the JAX package, kept in the port so that it
imports nothing of that package:

* ``compute_code_lengths`` <- ``fdeflate_tpu/huffman.py:53``, the
  length-limited DP (reference: src/lib.rs:42-101) that
  ``ops/septree.kernel_tree`` runs;
* ``build_huffman_tree`` <- ``fdeflate_tpu/models/bitstream.py:47``, the
  heap Huffman build with Kraft-sum length limiting (reference:
  src/compress/bitstream.rs:198-325) that ``ops/septree._build_header``
  runs for the code-length code.

tests/test_torch_hostcopies.py holds both equal to the originals.
"""

from __future__ import annotations

import heapq

import numpy as np


def compute_code_lengths(
    freqs: np.ndarray,
    min_limit: np.ndarray,
    max_limit: np.ndarray,
) -> np.ndarray:
    """Build a length-limited Huffman tree via dynamic programming.

    Returns the optimal code length per symbol, where every symbol gets a code
    and lengths are constrained to ``[min_limit[i], max_limit[i]]``.
    Semantics match the reference's fpnge-derived DP (src/lib.rs:42-101); the
    per-offset inner loop is vectorized.
    """
    freqs = np.asarray(freqs, dtype=np.uint64)
    min_limit = np.asarray(min_limit, dtype=np.int64)
    max_limit = np.asarray(max_limit, dtype=np.int64)
    n = len(freqs)
    assert len(min_limit) == n and len(max_limit) == n
    assert np.all(min_limit >= 1) and np.all(min_limit <= max_limit)

    precision = int(max_limit.max())
    num_patterns = 1 << precision
    infinity = np.iinfo(np.uint64).max

    # dynp[sym, off]: minimal weighted length using symbols < sym with
    # codespace usage exactly `off` (in units of 2^-precision).
    dynp = np.full((n + 1, num_patterns + 1), infinity, dtype=np.uint64)
    dynp[0, 0] = 0

    for sym in range(n):
        freq = int(freqs[sym])
        for bits in range(int(min_limit[sym]), int(max_limit[sym]) + 1):
            off_delta = 1 << (precision - bits)
            cost = np.uint64(min(freq * bits, int(infinity)))
            prev = dynp[sym, : num_patterns + 1 - off_delta]
            cand = np.where(prev >= infinity - cost, infinity, prev + cost)
            cur = dynp[sym + 1, off_delta:]
            dynp[sym + 1, off_delta:] = np.minimum(cur, cand)

    lengths = np.zeros(n, dtype=np.int64)
    off = num_patterns
    for sym in range(n - 1, -1, -1):
        assert off > 0
        freq = int(freqs[sym])
        for bits in range(int(min_limit[sym]), int(max_limit[sym]) + 1):
            off_delta = 1 << (precision - bits)
            cost = min(freq * bits, int(infinity))
            if off_delta <= off:
                prev = int(dynp[sym, off - off_delta])
                total = infinity if prev >= infinity - cost else prev + cost
                if int(dynp[sym + 1, off]) == int(total):
                    off -= off_delta
                    lengths[sym] = bits
                    break
    return lengths


def build_huffman_tree(
    frequencies: np.ndarray, length_limit: int
) -> tuple[np.ndarray, np.ndarray, bool]:
    """Optimal length-limited Huffman code for the given frequencies.

    Returns ``(lengths, codes, is_multi_symbol)``.  Alphabets with <= 1 used
    symbol get a single 1-bit code and ``is_multi_symbol == False``
    (reference: src/compress/bitstream.rs:198-325).
    """
    frequencies = np.asarray(frequencies, dtype=np.int64)
    n = len(frequencies)
    lengths = np.zeros(n, dtype=np.int64)
    codes = np.zeros(n, dtype=np.int64)

    used = np.nonzero(frequencies)[0]
    if len(used) <= 1:
        if len(used):
            lengths[used[0]] = 1
        return lengths, codes, False

    # Standard two-queue-equivalent heap construction.  Ties break on the
    # smallest node id for determinism.
    heap = [(int(frequencies[i]), int(i)) for i in used]
    heapq.heapify(heap)
    parents: dict[int, tuple[int, int]] = {}
    next_id = n
    while len(heap) > 1:
        f1, n1 = heapq.heappop(heap)
        f2, n2 = heapq.heappop(heap)
        parents[next_id] = (n1, n2)
        heapq.heappush(heap, (f1 + f2, next_id))
        next_id += 1

    # Walk the tree to assign depths.
    stack = [(heap[0][1], 0)]
    while stack:
        node, depth = stack.pop()
        if node < n:
            lengths[node] = depth
        else:
            left, right = parents[node]
            stack.append((left, depth + 1))
            stack.append((right, depth + 1))

    # Kraft-sum length limiting (reference: src/compress/bitstream.rs:264-308).
    max_length = int(lengths.max())
    if max_length > length_limit:
        counts = np.zeros(16, dtype=np.int64)
        for length in lengths:
            if length:
                counts[min(int(length), length_limit)] += 1
        total = int(
            sum(int(counts[i]) << (length_limit - i) for i in range(1, length_limit + 1))
        )
        while total > (1 << length_limit):
            i = length_limit - 1
            while counts[i] == 0:
                i -= 1
            counts[i] -= 1
            counts[length_limit] -= 1
            counts[i + 1] += 2
            total -= 1
        # Reassign: least frequent symbols get the longest codes.
        order = np.argsort(frequencies, kind="stable")
        length = length_limit
        for i in order:
            if frequencies[i] > 0:
                while counts[length] == 0:
                    length -= 1
                lengths[i] = length
                counts[length] -= 1

    # Canonical, bit-reversed code assignment.
    code = 0
    for length in range(1, length_limit + 1):
        for i in np.nonzero(lengths == length)[0]:
            codes[i] = int(
                format(code, f"0{length}b")[::-1], 2
            )
            code += 1
        code <<= 1
    assert code == 2 << length_limit, "length-limited tree must be complete"

    return lengths, codes, True
