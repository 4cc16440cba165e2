"""8-bit RGB PNG thumbnails' IDAT zlib streams inflated by the program's
whole-buffer batch entry, ``fdeflate_tpu_torch.decompress_batch``.  Every
stream is shorter than block discovery's threshold (49,152 bytes), so the
sequential path (``decompress_sequential``: the host's framing and header
parse, one K4 launch per block round with a lane per stream, materialize,
the 32 KiB windows across launches) decodes them all.  The images are
``thumbnails.make_rgb_thumbnails``' (real filtered rows, each row's
filter type first), compressed in set-up by Python's zlib at the
configuration's level.

The step, the numbers and the check are ``inflate_batch.Cell``'s: each
call hands ``decompress_batch`` the traffic's images per call, one caller
waiting for each answer, timed from its call until its bytes are on the
host; after the window every answer of every call is judged against the
reference (Python's zlib on the same stream).  The control (``--control
1``) decodes each block from an empty window (``reference.inflate_blocks``):
the later blocks' back-references into the earlier ones read zeros, so the
run is not correct.
"""

from __future__ import annotations

import zlib

import torch

from ..harness import parallel_map, seeded_order
from ..thumbnails import BPP, make_rgb_thumbnails
from .inflate_batch import FAULTS
from .inflate_batch import Cell as BatchCell


class Cell(BatchCell):
    def __init__(self, config: dict, traffic: dict, seed: int,
                 device: torch.device, *, trace: bool = False,
                 control: bool = False, fault: str | None = None):
        if fault not in (None, *FAULTS):
            raise ValueError(f"unknown fault {fault!r}")
        if (config["channels"], config["bit_depth"]) != (BPP, 8):
            raise ValueError("the thumbnails are 8-bit RGB")
        if traffic["distinct_images"] > config["images"]:
            raise ValueError("the traffic draws more images than the "
                             "configuration holds")
        W, H = config["width_px"], config["height_px"]
        self.N = config["idat_bytes"]
        if self.N != H * (1 + BPP * W):
            raise ValueError(f"idat_bytes {self.N} is not {H} rows of "
                             f"1 + {BPP * W} bytes")
        self.B = traffic["images_per_call"]
        self.traffic = traffic
        self.device, self.control, self.fault = device, control, fault
        images = seeded_order(
            make_rgb_thumbnails(traffic["distinct_images"], W, H,
                                config["corpus_seed"]), seed, group=self.B)
        level = config["zlib_level"]
        self.streams = parallel_map(
            lambda im: zlib.compress(im.tobytes(), level), list(images))
        self.prev = None   # the last answer, for the fault "stale"
        self._reset()
