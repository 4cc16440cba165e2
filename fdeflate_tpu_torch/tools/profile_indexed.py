"""Where the indexed decode spends its time on one GPU.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 -m fdeflate_tpu_torch.tools.profile_indexed

At the headline width (16 x 1 MiB IDAT, C = 512, as ``tools/time_k11``
stages it) it prints K11's two forms with their bounds (the live form,
``_decode_symbols_live``, and the full form, ``decode_symbols``), then
``indexed_decode_step``'s time and a ``torch.profiler`` table of its ops
by CUDA time (K11's live form and ``indexed_materialize`` on its live
records; the card is traced through CUPTI), then the CUDA-event times of
the PyTorch scans and scatters a materialize can be built from, on int64
[16, 2.1 M] (the positions of the 16 streams): a cummax and a cumsum along
the rows, one flat cumsum of all of them, an ``index_add_`` of 33.5 M
values of which all but 1.5 M go to one dump slot, and the same 1.5 M
alone; then the card's name and power limit.
"""

from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile

import fdeflate_tpu_torch as P
from fdeflate_tpu_torch.ops.decode_symbols import (_decode_symbols_live,
                                                   decode_symbols)
from fdeflate_tpu_torch.parallel import device_pipeline as DP
from fdeflate_tpu_torch.tools.corpus import make_idat_corpus
from fdeflate_tpu_torch.tools.time_k11 import (B, C, HBM_BYTES_PER_S, N,
                                               headline_lanes, k11_bytes, smi)
from fdeflate_tpu_torch.tools.time_k2_k4 import cuda_ms


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_indexed: CUDA is not available")
    dev = torch.device("cuda")
    streams, index = P.compress_batch_ultra_fast(
        [r.tobytes() for r in make_idat_corpus(B, N)], with_index=C)
    case, staged, cap = headline_lanes(streams, index, dev)
    steps = _decode_symbols_live(**case)[2]
    L, ran = steps.numel(), int(steps.sum())
    for name, fn, records in (
            ("live form", lambda: _decode_symbols_live(**case), ran),
            ("full form", lambda: decode_symbols(**case),
             case["max_steps"] * L)):
        bound = k11_bytes(case, staged[1], records) / HBM_BYTES_PER_S * 1e3
        print(f"K11 {name}: {cuda_ms(fn, 3):.4f} ms one call, bound "
              f"{bound:.6f} ms ({records} records)", flush=True)
    step = DP.indexed_decode_step(C, case["max_steps"], cap)
    print(f"indexed_decode_step: {cuda_ms(lambda: step(*staged), 3):.4f} ms "
          f"one call", flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(*staged)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=20, max_name_column_width=60),
          flush=True)

    ext = (1 << 15) + cap
    x = torch.randint(0, 1 << 30, (B, ext), device=dev, dtype=torch.int64)
    dump = B * ext
    live = 1_500_000
    idx = torch.full((B * ext,), dump, dtype=torch.int64, device=dev)
    idx[:live] = torch.randperm(dump, device=dev)[:live]
    vals = torch.ones(B * ext, dtype=torch.int64, device=dev)
    acc = torch.zeros(dump + 1, dtype=torch.int64, device=dev)
    fns = {
        f"cummax along rows [{B}, {ext}]": lambda: x.cummax(dim=1),
        f"cumsum along rows [{B}, {ext}]": lambda: x.cumsum(dim=1),
        f"flat cumsum [{B * ext}]": lambda: x.reshape(-1).cumsum(0),
        f"index_add_ of {B * ext}, all but {live} to one slot":
            lambda: acc.index_add_(0, idx, vals),
        f"index_add_ of the {live} alone":
            lambda: acc.index_add_(0, idx[:live], vals[:live]),
    }
    for name, fn in fns.items():
        print(f"{name}: {cuda_ms(fn, 3):.4f} ms", flush=True)
    print(smi("name,power.limit"))


if __name__ == "__main__":
    main()
