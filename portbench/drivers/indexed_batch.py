"""Indexed ultra-fast streams read back by the program's chunk-parallel
decode, ``fdeflate_tpu_torch.decompress_batch_indexed`` (the words and
index staged on the device, K11 over every chunk lane, the records
materialized, the host's Adler-32 check; ``decompress_batch`` for a
stream the decode rejects).  The streams and their chunk index are
encoded in set-up, untimed, on the device, by
``compress_batch_ultra_fast(with_index=C)``, one call per fixed batch.
Each call hands the decode the traffic's images per call with their index
rows, one caller waiting for each answer; a call is timed from its start
until its bytes are on the host.

Answers are not all kept (the window decodes tens of GB): every call's
streams, errors and bytes are counted, and a sample of calls drawn from
the seed is kept by reference and judged after the window, every stream
against Python's zlib on the same stream.  Also after the window: every
pool stream must inflate with Python's zlib to its image (the untimed
encode held to the reference), and the program's counter
``indexed.fallback`` must not have risen in the window (a stream that
left the index was not decoded on this deployment's path).

The control (``--control 1``) hands each call an index that has lost its
entries (each at its stream's end): the decode rejects every stream and
``decompress_batch`` decodes it, so the bytes are right and the run is not
correct through ``indexed_fallbacks`` alone.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

import fdeflate_tpu_torch as P
from fdeflate_tpu_torch.utils import profiling

from .. import reference as R
from .. import stats
from ..corpus import make_idat_corpus
from ..harness import Reservoir, call_images, distinct_calls, seeded_order

FAULTS = ("stale", "half", "token")


def _fallbacks() -> int:
    return profiling.counts().get("indexed.fallback", 0)


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, *, trace: bool = False,
                 control: bool = False, fault: str | None = None):
        if fault not in (None, *FAULTS):
            raise ValueError(f"unknown fault {fault!r}")
        self.N, self.C = config["image_bytes"], config["chunks"]
        self.B = traffic["images_per_call"]
        self.traffic = traffic
        self.device, self.control, self.fault = device, control, fault
        self.images = seeded_order(
            make_idat_corpus(traffic["distinct_images"], self.N,
                             config["corpus_seed"]), seed, group=self.B)
        self.streams: list[bytes] = [b""] * len(self.images)
        self.index = np.zeros((len(self.images), self.C), np.int32)
        for s in range(distinct_calls(traffic)):
            ids = call_images(traffic, s)
            streams, index = P.compress_batch_ultra_fast(
                [self.images[k].tobytes() for k in ids], with_index=self.C,
                device=device)
            for j, k in enumerate(ids):
                self.streams[k], self.index[k] = streams[j], index[j]
        # The control's index: every entry at its stream's end, so that no
        # chunk lane decodes and every stream leaves the index.
        ends = np.array([(len(x) - 4) * 8 for x in self.streams], np.int32)
        self.lost_index = np.repeat(ends[:, None], self.C, axis=1)
        self.samples = Reservoir(traffic["judged_samples"], seed)
        self.prev = None   # the last answer, for the fault "stale"
        self._reset()

    def _reset(self) -> None:
        self.calls = self.answered = self.failed = 0
        self.in_bytes = self.out_bytes = 0
        self.samples.items, self.samples.seen = [], 0
        self.fallbacks_at = _fallbacks()

    def warm(self) -> None:
        """One call of each distinct batch this traffic sends."""
        for i in range(distinct_calls(self.traffic)):
            self.step(i)
        self._reset()

    def step(self, i: int) -> None:
        ids = call_images(self.traffic, i)
        batch = [self.streams[k] for k in ids]
        index = self.lost_index[ids] if self.control else self.index[ids]
        with torch.profiler.record_function("decompress_batch_indexed"):
            try:
                if self.fault == "half":
                    h = self.B // 2
                    out = (P.decompress_batch_indexed(batch[:h], index[:h],
                                                      device=self.device)
                           + [b""] * (self.B - h))
                else:
                    out = P.decompress_batch_indexed(batch, index,
                                                     device=self.device)
            except P.DecompressionError as e:   # the call answers nothing
                out = [e] * self.B
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
        self.window_fallbacks = _fallbacks() - self.fallbacks_at
        self.prev = None

    def check(self) -> list[tuple[str, float, float]]:
        want: dict[int, bytes] = {}
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
        return [("answers_missing", float(not judged), 0),
                ("answers_wrong", wrong, 0),
                ("inputs_wrong", inputs_wrong, 0),
                ("indexed_fallbacks", self.window_fallbacks, 0)]
