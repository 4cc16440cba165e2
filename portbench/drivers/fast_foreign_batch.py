"""Fast-mode PNG streams read with no chunk index by the program's
whole-buffer batch entry, ``fdeflate_tpu_torch.decompress_batch``.  Each
stream is one dynamic block of ~0.4 MiB for a 1 MiB image: block
discovery (stage 1, K5, K12, a K4 lane at bit 16) starts it and gives it
up when that lane runs out of record slots before the block's EOB
(``discovery.fallback.budget``), and the sequential path decodes all of
it, one K4 launch a round with a lane per stream.  The streams are
encoded in set-up, untimed, on the device, by
``compress_batch_ultra_fast`` with no index, one call per fixed batch.
Each call hands ``decompress_batch`` the traffic's images per call and
nothing else, one caller waiting for each answer.

Answers are not all kept: every call's streams, errors and bytes are
counted, and a sample of calls drawn from the seed is kept by reference
and judged after the window, every stream against Python's zlib on the
same stream.  Also after the window: every pool stream must inflate with
Python's zlib to its image (``inputs_wrong``) and must be one dynamic
block, BFINAL set on its first header (``multi_block``,
``portbench/single_block.py``).

The control (``--control 1``) leaves out the decode past one discovery
lane's record budget: each stream answers only its first 65,536 bytes
(Python's zlib, stopped there), so the run is not correct.
"""

from __future__ import annotations

import zlib

import torch

import fdeflate_tpu_torch as P

from .. import reference as R
from .. import stats
from ..corpus import make_idat_corpus
from ..harness import Reservoir, call_images, distinct_calls, seeded_order
from ..single_block import is_single_dynamic_block

FAULTS = ("stale", "half", "token")
CONTROL_BYTES = 65536


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, *, trace: bool = False,
                 control: bool = False, fault: str | None = None):
        if fault not in (None, *FAULTS):
            raise ValueError(f"unknown fault {fault!r}")
        self.N = config["image_bytes"]
        self.B = traffic["images_per_call"]
        self.traffic = traffic
        self.device, self.control, self.fault = device, control, fault
        self.images = seeded_order(
            make_idat_corpus(traffic["distinct_images"], self.N,
                             config["corpus_seed"]), seed, group=self.B)
        self.streams: list[bytes] = [b""] * len(self.images)
        for s in range(distinct_calls(traffic)):
            ids = call_images(traffic, s)
            streams = P.compress_batch_ultra_fast(
                [self.images[k].tobytes() for k in ids], device=device)
            for j, k in enumerate(ids):
                self.streams[k] = streams[j]
        self.samples = Reservoir(traffic["judged_samples"], seed)
        self.prev = None   # the last answer, for the fault "stale"
        self._reset()

    def _reset(self) -> None:
        self.calls = self.answered = self.failed = 0
        self.in_bytes = self.out_bytes = 0
        self.samples.items, self.samples.seen = [], 0

    def warm(self) -> None:
        """One call of each distinct batch this traffic sends."""
        for i in range(distinct_calls(self.traffic)):
            self.step(i)
        self._reset()

    def step(self, i: int) -> None:
        ids = call_images(self.traffic, i)
        batch = [self.streams[k] for k in ids]
        with torch.profiler.record_function("decompress_batch"):
            if self.control:   # the reference, stopped at one lane's reach
                out = [zlib.decompressobj().decompress(s, CONTROL_BYTES)
                       for s in batch]
            elif self.fault == "half":
                h = self.B // 2
                out = (P.decompress_batch(batch[:h], device=self.device)
                       + [b""] * (self.B - h))
            else:
                out = P.decompress_batch(batch, device=self.device)
        if self.fault == "token" and isinstance(out[0], bytes) and out[0]:
            out[0] = bytes([out[0][0] ^ 1]) + out[0][1:]
        if self.fault == "stale":
            out, self.prev = (self.prev or out), out
        self.calls += 1
        self.answered += len(out)
        self.failed += sum(not isinstance(a, bytes) for a in out)
        self.in_bytes += sum(len(b) for b in batch)
        self.out_bytes += sum(len(a) for a in out if isinstance(a, bytes))
        self.samples.offer((ids, out))

    # -- numbers ---------------------------------------------------------
    def work(self) -> tuple[int, int]:
        """(streams attempted, streams answered with an error)."""
        return self.answered, self.failed

    def end_to_end(self, window_s: float) -> dict:
        return {"inflate_gbps": (stats.rate_gbps(self.out_bytes, window_s),
                                 "GB/s")}

    def layer_counts(self) -> dict:
        return {"calls": self.calls, "compressed_bytes": self.in_bytes,
                "decoded_bytes": self.out_bytes}

    # -- the check -------------------------------------------------------
    def release(self) -> None:
        """Answers are host bytes already; nothing on the device to keep."""
        self.prev = None

    def check(self) -> list[tuple[str, float, float]]:
        want: dict[int, bytes | None] = {}
        judged = wrong = 0
        for ids, out in self.samples.items:
            for k, a in zip(ids, out):
                if k not in want:
                    try:
                        want[k] = R.inflate(self.streams[k])
                    except zlib.error:   # no answer can be right
                        want[k] = None
                judged += 1
                wrong += a != want[k]
        inputs_wrong = 0
        for k, stream in enumerate(self.streams):
            try:
                inputs_wrong += zlib.decompress(stream) != self.images[k].tobytes()
            except zlib.error:
                inputs_wrong += 1
        multi_block = sum(not is_single_dynamic_block(s) for s in self.streams)
        return [("answers_missing", float(not judged), 0),
                ("answers_wrong", wrong, 0),
                ("inputs_wrong", inputs_wrong, 0),
                ("multi_block", multi_block, 0)]
