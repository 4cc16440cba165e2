"""K5 validate_headers: discovery stage 2, one candidate header per thread.

JAX counterparts: the TPU kernel ``fdeflate_tpu/ops/pallas_inflate.py``
``_validate_kernel`` (via ``validate_headers_blocked``) and its numpy
oracle ``parallel/discovery.validate_stage2``.  The CUDA kernel is
``csrc/validate_headers.cu``; ``validate_headers_plain`` is its plain
version, one code-length section of every live candidate per iteration.

A candidate is the bit offset of a possible dynamic-block header in a
stream of ``n_bits`` payload bits, read from the stream's words (words at
or past the stream's end read as 0; each candidate may carry its own
stream's bounds, so the candidates of a batch of streams validate in one
call over their concatenated words).  Its header's 19 code-length code
lengths give a 7-bit canonical decode; at most ``VAL_STEPS`` sections (a length or a
16/17/18 repeat) are decoded while the literal/length and distance Kraft
sums, the end-of-block code's length and the structural errors are
tracked.  A header is good when the lengths end exactly at HLIT + HDIST
with no error, the literal/length code is complete with a nonzero
end-of-block length, and the distance code is complete or has at most one
code.  ``end`` is the bit after the last section decoded: the symbol start
of a good header.
"""

from __future__ import annotations

import functools

import torch

from .. import _build

VAL_STEPS = 320       # pallas_inflate._VAL_STEPS
_CLCL = (16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15)
_MASK32 = 0xFFFFFFFF


@functools.lru_cache(maxsize=4)
def _rev7(device: str) -> torch.Tensor:
    x = torch.arange(128, dtype=torch.int64)
    r = torch.zeros_like(x)
    for i in range(7):
        r |= ((x >> i) & 1) << (6 - i)
    return r.to(device)


def validate_headers_plain(words, cands, n_bits, wend=None):
    """Plain PyTorch K5.  Returns (good bool[L], end int64[L])."""
    dev = words.device
    W = words.numel()
    L = cands.numel()
    w = torch.cat([words.reshape(-1).to(torch.int64) & _MASK32,
                   torch.zeros(1, dtype=torch.int64, device=dev)])
    i64 = torch.int64
    n_bits = torch.as_tensor(n_bits, dtype=i64, device=dev).reshape(-1)
    we = W if wend is None else wend.reshape(-1).to(i64).clamp(max=W)

    def peek32(p):
        i = p >> 5
        lo = w[torch.where((i >= 0) & (i < we), i, W)]
        hi = w[torch.where((i + 1 >= 0) & (i + 1 < we), i + 1, W)]
        return ((lo | (hi << 32)) >> (p & 31)) & _MASK32

    c = cands.reshape(-1).to(i64)
    hlit = (peek32(c + 3) & 31) + 257
    hdist = (peek32(c + 8) & 31) + 1
    ncl = (peek32(c + 13) & 15) + 4
    cl = torch.zeros(L, 19, dtype=i64, device=dev)   # indexed by symbol
    for j, sym in enumerate(_CLCL):
        cl[:, sym] = torch.where(j < ncl, peek32(c + 17 + 3 * j) & 7, 0)
    cnt = torch.stack([(cl == n).sum(dim=1) for n in range(8)], dim=1)
    bound = torch.zeros(L, 8, dtype=i64, device=dev)
    kval = torch.zeros(L, 8, dtype=i64, device=dev)
    code = torch.zeros(L, dtype=i64, device=dev)
    acc = torch.zeros(L, dtype=i64, device=dev)
    for n in range(1, 8):
        bound[:, n] = (code + cnt[:, n]) << (7 - n)
        kval[:, n] = acc - code
        acc = acc + cnt[:, n]
        code = (code + cnt[:, n]) << 1
    sym_ids = torch.arange(19, device=dev)
    order = torch.argsort(torch.where(cl > 0, cl, 99) * 32 + sym_ids, dim=1)
    rev7 = _rev7(str(dev))

    pos = c + 17 + 3 * ncl
    total = hlit + hdist
    z = torch.zeros(L, dtype=i64, device=dev)
    written, prev, kraft_l, kraft_d, nz_d, len256 = (z.clone() for _ in range(6))
    bad = torch.zeros(L, dtype=torch.bool, device=dev)
    rows = torch.arange(L, device=dev)
    for _ in range(VAL_STEPS):
        live = ~bad & (written < total)
        if not bool(live.any()):
            break
        v = peek32(pos)
        r7 = rev7[v & 0x7F]
        Ln = 1 + ((r7[:, None] >= bound[:, 1:7]) & (bound[:, 1:7] < 128)).sum(dim=1)
        idx = kval[rows, Ln] + (r7 >> (7 - Ln))
        sym = order[rows, idx.clamp(0, 18)]
        valid = (idx >= 0) & (idx < 19) & (cl[rows, sym] == Ln)
        bad |= live & ~valid
        plain = sym <= 15
        ebits = torch.where(sym == 16, 2, torch.where(sym == 17, 3, 7))
        ebase = torch.where(sym == 18, 11, 3)
        rep = torch.where(plain, 1, ebase + ((v >> Ln) & ((1 << ebits) - 1)))
        value = torch.where(plain, sym, torch.where(sym == 16, prev, 0))
        bad |= live & (sym == 16) & (written == 0)
        bad |= live & (written + rep > total)
        act = live & ~bad
        rep_a = torch.where(act, rep, 0)
        l_cnt = (torch.minimum(written + rep_a, hlit) - written).clamp(min=0)
        d_cnt = rep_a - l_cnt
        k = torch.where(act & (value > 0), 1 << (15 - value.clamp(0, 15)), 0)
        kraft_l += k * l_cnt
        kraft_d += k * d_cnt
        nz_d += torch.where(k > 0, d_cnt, 0)
        hit = act & (written <= 256) & (256 < written + rep_a) & (hlit > 256)
        len256 = torch.where(hit, value, len256)
        prev = torch.where(act & plain, sym, prev)
        written = written + rep_a
        pos = torch.where(act, pos + Ln + torch.where(plain, 0, ebits), pos)
        bad |= live & (pos + 7 >= n_bits)
    good = (~bad & (written == total) & (kraft_l == 1 << 15) & (len256 > 0)
            & ((kraft_d == 1 << 15) | (nz_d <= 1)))
    return good, pos


def validate_headers(words, cands, n_bits, wend=None):
    """K5 on ``words``' device: (good bool[L], end int64[L]).

    ``words`` int32[W]: a stream's words (u32 bit patterns), or the
    concatenated words of several (``ops/inflate.pad_words``); ``cands``
    int64[L] absolute candidate bit offsets; ``n_bits`` the bit where the
    payload ends, an int for every candidate or int64[L] for each; ``wend``
    None (W for every candidate) or int64[L]: words at or past a
    candidate's ``wend`` read as 0, so a candidate never reads past its own
    stream.  CPU tensors take ``validate_headers_plain``; CUDA tensors
    launch ``csrc/validate_headers.cu``, one launch for all candidates.
    """
    if words.device.type == "cpu":
        return validate_headers_plain(words, cands, n_bits, wend)
    per = [x for x in (n_bits, wend) if isinstance(x, torch.Tensor)]
    _build.require_cuda(words, cands, *per)
    dev = words.device
    words = _build.i32(words.reshape(-1))
    cands = _build.i64(cands)
    L = cands.numel()
    good = torch.empty(L, dtype=torch.bool, device=dev)
    end = torch.empty(L, dtype=torch.int64, device=dev)
    if L == 0:
        return good, end
    nb = _build.i64(n_bits) if isinstance(n_bits, torch.Tensor) else None
    we = None if wend is None else _build.i64(wend)
    if any(x is not None and x.numel() != L for x in (nb, we)):
        raise ValueError("validate_headers: n_bits and wend need one entry "
                         "per candidate")
    _build.launch("validate_headers", dev, words.data_ptr(), cands.data_ptr(),
                  None if we is None else we.data_ptr(),
                  None if nb is None else nb.data_ptr(), words.numel(),
                  0 if nb is not None else int(n_bits), good.data_ptr(),
                  end.data_ptr(), L)
    return good, end
