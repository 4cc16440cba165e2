"""Where the indexed decode's materialize spends its time on one GPU.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 -m fdeflate_tpu_torch.tools.profile_indexed

At the headline width (16 x 1 MiB IDAT, C = 512, as ``tools/time_k11``
stages it) it prints ``indexed_materialize``'s time, then a
``torch.profiler`` table of its ops by CUDA time (the card is traced
through CUPTI), then the CUDA-event times of the PyTorch scans and
scatters a materialize can be built from, on int64 [16, 2.1 M] (the
positions of the 16 streams): a cummax and a cumsum along the rows, one
flat cumsum of all of them, an ``index_add_`` of 33.5 M values of which
all but 1.5 M go to one dump slot, and the same 1.5 M alone; then the
card's name and power limit.
"""

from __future__ import annotations

import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

import fdeflate_tpu_torch as P
from fdeflate_tpu_torch.ops.decode_symbols import STOPPED, decode_symbols
from fdeflate_tpu_torch.parallel import device_pipeline as DP
from fdeflate_tpu_torch.tools.corpus import make_idat_corpus
from fdeflate_tpu_torch.tools.time_k11 import B, C, N, headline_lanes
from fdeflate_tpu_torch.tools.time_k2_k4 import cuda_ms


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_indexed: CUDA is not available")
    dev = torch.device("cuda")
    streams, index = P.compress_batch_ultra_fast(
        [r.tobytes() for r in make_idat_corpus(B, N)], with_index=C)
    case, _staged, cap = headline_lanes(streams, index, dev)
    records, state = decode_symbols(**case)
    status = torch.where(case["active"], state[2], STOPPED)

    def im():
        return DP.indexed_materialize(records, status, None, C, cap)

    print(f"indexed_materialize: {cuda_ms(im, 3):.4f} ms one call",
          flush=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        im()
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total",
                                    row_limit=15, max_name_column_width=60),
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
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
