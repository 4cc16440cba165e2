"""The device codec's roundtrip: each step encodes a batch of images to
standard zlib with a chunk index (``zlib_encode_step``: K1, K2, framing,
K7) and decodes that artifact back chunk-parallel with both checks
(``zlib_decode_step``: K3, exit bits, Adler-32), on device-resident
batches, one step at a time, each ending in a synchronize.

Judged after the window, on the last step of every distinct batch and a
sample of the others drawn from the seed (every row, or ``judged_rows``
of each drawn from the seed): each stream framed from the
encode leg's words, bit count and Adler-32 must inflate with Python's
zlib to its image; every chunk must decode on its own from its index
entry to exactly its bytes (``reference.check_index``); the decode leg's
bytes must be the image; its two flags must say what the reference finds.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from fdeflate_tpu_torch.parallel.device_pipeline import (
    zlib_decode_step,
    zlib_encode_step,
)

from .. import reference as R
from .. import stats
from ..corpus import make_idat_corpus
from ..harness import (
    Reservoir,
    call_images,
    distinct_calls,
    recorded_event,
    seeded_order,
    synchronize,
)

FAULTS = ("stale", "half", "token")


class Cell:
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, *, trace: bool = False,
                 control: bool = False, fault: str | None = None):
        if fault not in (None, *FAULTS):
            raise ValueError(f"unknown fault {fault!r}")
        self.N, self.C = config["image_bytes"], config["chunks"]
        self.B = traffic["images_per_call"]
        self.slots = distinct_calls(traffic)
        self.device, self.trace = device, trace
        self.control, self.fault = control, fault
        self.images = seeded_order(
            make_idat_corpus(traffic["distinct_images"], self.N,
                             config["corpus_seed"]), seed)
        self.rows = [call_images(traffic, s) for s in range(self.slots)]
        pool = torch.from_numpy(self.images).to(device)
        self.batches = [pool[torch.tensor(r, device=device)] for r in self.rows]
        del pool
        self.lengths = torch.full((self.B,), self.N, dtype=torch.int32,
                                  device=device)
        self.encode = zlib_encode_step(self.C)
        self.decode = zlib_decode_step(self.C, self.N)
        self.samples = Reservoir(traffic["judged_samples"], seed)
        self.judged_rows = min(traffic.get("judged_rows", self.B), self.B)
        self.seed = seed
        self.prev = None   # the last answer, for the fault "stale"
        self._reset()

    def _reset(self) -> None:
        self.steps = 0
        self.count = [0] * self.slots
        self.last: dict[int, tuple] = {}
        self.samples.items, self.samples.seen = [], 0
        self.marks: list[tuple] = []

    def warm(self) -> None:
        """Run every distinct batch, and as many steps as the window keeps
        alive at once, so that nothing is built or allocated in it."""
        for i in range(self.slots + self.samples.k + 2):
            self.step(i)
        self._reset()

    def step(self, i: int) -> None:
        s = i % self.slots
        data = self.batches[s]
        e0 = recorded_event(self.device, self.trace)
        with torch.profiler.record_function("encode_leg"):
            art = self._encode(data)
        e1 = recorded_event(self.device, self.trace)
        with torch.profiler.record_function("decode_leg"):
            words, _tb, adler, starts, eof = art
            out = self.decode(words, starts, eof, adler, self.lengths)
        e2 = recorded_event(self.device, self.trace)
        with torch.profiler.record_function("synchronize"):
            synchronize(self.device)
        if e0 is not None:
            self.marks.append((e0, e1, e2))
        if self.fault == "stale" and self.prev is not None:
            art, out, self.prev = self.prev[0], self.prev[1], (art, out)
        elif self.fault == "stale":
            self.prev = (art, out)
        kept = (i, s, art, out)
        self.steps += 1
        self.count[s] += 1
        self.last[s] = kept
        self.samples.offer(kept)

    def _encode(self, data):
        if self.fault == "half":
            h = self.B // 2
            art = self.encode(data[:h], self.lengths[:h])
            return tuple(torch.cat([x, torch.zeros((self.B - h, *x.shape[1:]),
                                                   dtype=x.dtype,
                                                   device=x.device)])
                         for x in art)
        art = self.encode(data, self.lengths)
        if self.control:   # the checksum left out of every stream
            art = (art[0], art[1], torch.zeros_like(art[2]), *art[3:])
        if self.fault == "token":
            art[0][0, 100] ^= 1 << 7
        return art

    # -- numbers ---------------------------------------------------------
    def work(self) -> tuple[int, int]:
        """(streams attempted, streams failed) in the window: a step that
        fails raises, and ends the run with no result."""
        return self.steps * self.B, 0

    def _comp_bytes(self) -> int:
        """Zlib bytes the window's steps produced: each distinct batch's
        stream bytes (framing and checksum included) times its steps."""
        total = 0
        for s, (_i, _s, art, _out) in self.last.items():
            tb = art[1].to(torch.int64).cpu()
            total += self.count[s] * int((tb // 8 + 4).sum())
        return total

    def end_to_end(self, window_s: float) -> dict:
        nbytes = self.steps * self.B * self.N
        return {
            "codec_gbps": (stats.rate_gbps(nbytes, window_s), "GB/s"),
            "compressed_ratio": (stats.ratio(self._comp_bytes(), nbytes), "B/B"),
        }

    def layer_counts(self) -> dict:
        spans = {"encode_leg": 0.0, "decode_leg": 0.0}
        for e0, e1, e2 in self.marks:
            spans["encode_leg"] += e0.elapsed_time(e1)
            spans["decode_leg"] += e1.elapsed_time(e2)
        nbytes = self.steps * self.B * self.N
        return {"steps": self.steps, "span_ms": spans if self.marks else {},
                "input_bytes": nbytes, "compressed_bytes": self._comp_bytes(),
                "decoded_bytes": nbytes}

    # -- the check -------------------------------------------------------
    def release(self) -> None:
        """Copy the judged rows of the judged steps to the host (every row,
        or ``judged_rows`` of them drawn from the seed) and free the rest."""
        kept = {k[0]: k for k in [*self.last.values(), *self.samples.items]}
        self.judged = []
        for i, s, art, out in kept.values():
            rng = np.random.default_rng([self.seed, i])
            rows = np.sort(rng.choice(self.B, self.judged_rows, replace=False))
            sel = torch.from_numpy(rows).to(art[0].device)
            self.judged.append((s, rows, [x[sel].cpu().numpy() for x in art],
                                [x[sel].cpu().numpy() for x in out]))
        self.last, self.samples.items, self.prev, self.marks = {}, [], None, []
        del self.batches, self.lengths

    def check(self) -> list[tuple[str, float, float]]:
        bad_zlib = bad_lanes = bad_decode = bad_flags = streams = 0
        for s, rows, (words, tb, adler, starts, eof), (out, bpos_ok, ck_ok) in self.judged:
            data = self.images[np.asarray(self.rows[s])[rows]]
            frames = [R.frame(words[b], tb[b], adler[b]) for b in range(len(rows))]
            lanes_ok = _index_ok(frames, starts, eof, data)
            for b, fr in enumerate(frames):
                streams += 1
                try:
                    good = zlib.decompress(fr) == data[b].tobytes()
                except zlib.error:
                    good = False
                bad_zlib += not good
                bad_decode += not np.array_equal(out[b], data[b])
                want_bpos = bool(lanes_ok[b].all())
                want_ck = int(adler[b]) == zlib.adler32(out[b].tobytes())
                bad_flags += (bool(bpos_ok[b]) != want_bpos) + (bool(ck_ok[b]) != want_ck)
            bad_lanes += int((~lanes_ok).sum())
        return [
            ("streams_judged_missing", float(streams == 0), 0),
            ("streams_not_inflating", bad_zlib, 0),
            ("chunks_off_index", bad_lanes, 0),
            ("streams_decoded_wrong", bad_decode, 0),
            ("flags_wrong", bad_flags, 0),
        ]


def _index_ok(frames, starts, eof, data) -> np.ndarray:
    """``reference.check_index`` over the streams whose header reads; every
    chunk of a stream whose header does not read is off."""
    ok = np.zeros(starts.shape, bool)
    good = []
    for b, fr in enumerate(frames):
        try:
            R.stream_tables(fr)
            good.append(b)
        except R.DeflateError:
            pass
    if good:
        ok[good] = R.check_index([frames[b] for b in good], starts[good],
                                 eof[good], data[good])
    return ok
