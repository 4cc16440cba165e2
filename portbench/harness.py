"""Pieces the drivers share: the device's synchronize, the sample of
timed steps kept for the check, and a thread pool for set-up."""

from __future__ import annotations

import math
import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

SETUP_THREADS = 4


def synchronize(device: torch.device) -> None:
    """Wait for the device (a no-op on the CPU, where calls return done)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def seeded_order(images: np.ndarray, seed: int, group: int = 1) -> np.ndarray:
    """The images in an order drawn from the seed: every seed sends the
    same work, in its own order.  The images fall into fixed groups of
    ``group`` in a row (a call's batch); the seed orders the groups and
    the images inside each, and never moves an image to another group, so
    that every seed sends the same batches."""
    n = len(images)
    if n % group:
        raise ValueError(f"{n} images do not fall into groups of {group}")
    rng = np.random.default_rng(seed)
    starts = rng.permutation(n // group) * group
    return images[np.concatenate([s + rng.permutation(group) for s in starts])]


def call_images(traffic: dict, i: int) -> list[int]:
    """The pool images call ``i`` takes: ``images_per_call`` of them from
    ``i * stride``, round the pool of ``distinct_images``."""
    P, B, stride = (traffic["distinct_images"], traffic["images_per_call"],
                    traffic["stride"])
    return [(i * stride + j) % P for j in range(B)]


def distinct_calls(traffic: dict) -> int:
    """How many different calls the traffic makes before it repeats."""
    P = traffic["distinct_images"]
    return P // math.gcd(P, traffic["stride"])


def parallel_map(fn, items):
    """``[fn(x) for x in items]`` on a few threads (for C code that
    releases the interpreter lock, such as zlib)."""
    with ThreadPoolExecutor(SETUP_THREADS) as ex:
        return list(ex.map(fn, items))


class Reservoir:
    """A uniform sample of k of the steps seen so far, drawn from the seed
    (Vitter's algorithm R): ``offer`` keeps a step's outputs by reference,
    so keeping one costs no copy."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.items, self.seen = k, random.Random(seed), [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.items[j] = item


def recorded_event(device: torch.device, on: bool):
    """A CUDA event recorded now on the current stream, or None (off, or
    not on a CUDA device)."""
    if not on or device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev
