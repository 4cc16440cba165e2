"""Foreign zlib streams inflated by the program's whole-buffer batch
entry, ``fdeflate_tpu_torch.decompress_batch`` (block discovery: stage 1,
K5, the host's header parse, K4, the chain, the stitch with K7; the
sequential path for what discovery leaves).  Each call hands it the
traffic's images per call as streams, one caller waiting for each answer;
a request is timed from its call until its bytes are on the host.

Judged after the window: every answer of every call, against Python's
zlib on the same stream.
"""

from __future__ import annotations

import time
import zlib

import torch

import fdeflate_tpu_torch as P

from .. import reference as R
from .. import stats
from ..corpus import make_idat_corpus
from ..harness import call_images, distinct_calls, parallel_map, seeded_order

FAULTS = ("stale", "half", "token")


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
        images = seeded_order(
            make_idat_corpus(traffic["distinct_images"], self.N,
                             config["corpus_seed"]), seed, group=self.B)
        level = config["zlib_level"]
        self.streams = parallel_map(lambda im: zlib.compress(im.tobytes(), level),
                                    list(images))
        self.prev = None   # the last answer, for the fault "stale"
        self._reset()

    def _reset(self) -> None:
        self.answers: list[tuple[list[int], list]] = []
        self.latency_s: list[float] = []

    def warm(self) -> None:
        """One call of each distinct batch this traffic sends."""
        for i in range(distinct_calls(self.traffic)):
            self.step(i)
        self._reset()

    def step(self, i: int) -> None:
        ids = call_images(self.traffic, i)
        batch = [self.streams[k] for k in ids]
        t0 = time.perf_counter()
        with torch.profiler.record_function("decompress_batch"):
            if self.control:   # the reference with its stitch left out
                out = [R.inflate_blocks(s) for s in batch]
            elif self.fault == "half":
                h = self.B // 2
                out = (P.decompress_batch(batch[:h], device=self.device)
                       + [b""] * (self.B - h))
            else:
                out = P.decompress_batch(batch, device=self.device)
        self.latency_s.append(time.perf_counter() - t0)
        if self.fault == "token" and isinstance(out[0], bytes) and out[0]:
            out[0] = bytes([out[0][0] ^ 1]) + out[0][1:]
        if self.fault == "stale":
            out, self.prev = (self.prev or out), out
        self.answers.append((ids, out))

    # -- numbers ---------------------------------------------------------
    def _done(self):
        return [(k, a) for ids, out in self.answers for k, a in zip(ids, out)]

    def work(self) -> tuple[int, int]:
        """(streams attempted, streams answered with an error)."""
        done = self._done()
        return len(done), sum(not isinstance(a, bytes) for _k, a in done)

    def end_to_end(self, window_s: float) -> dict:
        out_bytes = sum(len(a) for _k, a in self._done() if isinstance(a, bytes))
        return {
            "inflate_gbps": (stats.rate_gbps(out_bytes, window_s), "GB/s"),
            "inflate_p95_ms": (1e3 * stats.percentile(self.latency_s, 95), "ms"),
        }

    def layer_counts(self) -> dict:
        done = self._done()
        return {"calls": len(self.answers),
                "compressed_bytes": sum(len(self.streams[k]) for k, _a in done),
                "decoded_bytes": sum(len(a) for _k, a in done
                                     if isinstance(a, bytes))}

    # -- the check -------------------------------------------------------
    def release(self) -> None:
        """Answers are host bytes already; nothing on the device to keep."""

    def check(self) -> list[tuple[str, float, float]]:
        want = {}
        wrong = 0
        done = self._done()
        for k, a in done:
            if k not in want:
                want[k] = R.inflate(self.streams[k])
            wrong += a != want[k]
        return [("answers_missing", float(not done), 0),
                ("answers_wrong", wrong, 0)]

