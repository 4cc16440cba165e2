"""K8 decode2_canon and K9 pack_v1 timed on the A/B chain's shapes on one GPU.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 -m fdeflate_tpu_torch.tools.time_k8_k9 [--reps 10]

It uses only entry points that every slice of the port since the blocked
layout has had (``encode_blocked_v1``, ``pack_blocked``, ``decode2_canon``,
``decode2`` on windows), so the same file, copied into an older checkout,
times that checkout's kernels: to compare two trees, run it from each in
one machine session, in turns (parent, change, change, parent).  Printed,
one line each, as medians of ``--reps`` CUDA-event timings of single calls
(ms), on 16 x 1 MiB IDAT (``make_idat_corpus``) at C = 2048 (S = 512, the
A/B chain of ``chip_smoke.py`` phase 11):

* K9 on the chain's tokens, and the chain's encode (``encode_blocked_v1``:
  tokens, then K9) around it;
* K8 on the chain's windows, and K3 on the same windows (each a C = 1
  stream from bit 0, as ``decode_blocked`` runs it): the yardstick of a
  group decode;
* K9, K8 and K3 back to back: 10 x ``--reps`` calls queued between two
  CUDA events, per call (the card's time where it exceeds the host's);

then the card's name and power limit.  K9's windows are checked against
K1's and K8's bytes and exit bits against K3's before they are timed.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from fdeflate_tpu_torch.ops.assign_pack import assign_pack, assign_tokens, wwin
from fdeflate_tpu_torch.ops.decode2 import canon_tables, decode2, decode2_canon
from fdeflate_tpu_torch.ops.pack import (encode_blocked_v1, pack_blocked,
                                         pack_tokens, token_offsets)
from fdeflate_tpu_torch.tools.corpus import make_idat_corpus
from fdeflate_tpu_torch.tools.time_k2_k4 import cuda_ms
from fdeflate_tpu_torch.trees import trained_tables


def queued_ms(fn, reps: int) -> float:
    """Milliseconds per call of ``fn`` with ``reps`` calls queued back to
    back between two CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("time_k8_k9: CUDA is not available")
    dev = torch.device("cuda")
    B, N, C = 16, 1 << 20, 2048
    S, L = N // C, B * C
    t = trained_tables(str(dev))
    data = torch.from_numpy(make_idat_corpus(B, N)).to(dev)
    lengths = torch.full((B,), N, dtype=torch.int32, device=dev)
    v, nb, _ = assign_tokens(data, lengths, S, t)
    tok = pack_tokens(v, nb, token_offsets(nb, C), C)
    win = pack_blocked(tok, wwin(S))
    if not torch.equal(win, assign_pack(data, lengths, C, t)[0]):
        raise AssertionError("K9: windows differ from K1's")
    meta, packed = canon_tables(str(dev))
    starts = torch.zeros(L, 1, dtype=torch.int32, device=dev)
    got = decode2_canon(win, S // 4, meta, packed)
    k3 = decode2(win, starts, t.dtab, S, 1)
    if not (torch.equal(got[0], k3[0]) and torch.equal(got[1], k3[1].reshape(L))
            and torch.equal(got[0].reshape(B, N), data)):
        raise AssertionError("K8: bytes or exit bits differ from K3's")

    k9 = cuda_ms(lambda: pack_blocked(tok, wwin(S)), args.reps)
    enc = cuda_ms(lambda: encode_blocked_v1(data, lengths, C, t), args.reps)
    k8 = cuda_ms(lambda: decode2_canon(win, S // 4, meta, packed), args.reps)
    k3_ms = cuda_ms(lambda: decode2(win, starts, t.dtab, S, 1), args.reps)
    print(f"K9 16 x 1 MiB, C={C}: kernel {k9:.4f} ms, chain encode (tokens "
          f"+ K9) {enc:.4f} ms", flush=True)
    print(f"K8 16 x 1 MiB, C={C}: kernel {k8:.4f} ms; K3 on the same "
          f"windows {k3_ms:.4f} ms", flush=True)
    q9 = queued_ms(lambda: pack_blocked(tok, wwin(S)), 10 * args.reps)
    q8 = queued_ms(lambda: decode2_canon(win, S // 4, meta, packed),
                   10 * args.reps)
    q3 = queued_ms(lambda: decode2(win, starts, t.dtab, S, 1), 10 * args.reps)
    print(f"back to back: K9 {q9:.4f} ms, K8 {q8:.4f} ms, K3 on the same "
          f"windows {q3:.4f} ms", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
