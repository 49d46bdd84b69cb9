"""The general generator of work items, read from a traffic mix's file.

A traffic file (rtbench/traffic/<name>.json) gives the integrator, the
depth, the sampler, the lanes of one queue drain and how many row tiles
make one work item.  A work item is one queue drain of the program's
`render_tile_regen`: `tiles_per_item` row tiles of `rows_per_tile` rows
spread over the frame's height (tiles k, k + F, k + 2F, ... of the frame's
row tiles, F = items per frame), one sample each.  The cells' mixes take
tiles of one row: item k renders every F-th row from row k, so every item
holds the same share of every band of the image, costs what the others
cost and reads the same rays per sample, and a faster program that runs
more items in its window runs more of the same mix.  A frame's F items
run in bit-reversed order of k (F = 8: 0, 4, 2, 6, 1, 5, 3, 7), so that
with coarser tiles too every prefix of a frame spreads over its height.
Items k = 0 .. F-1 make one frame; the next frame takes the next sample
index.

The seed sets the sampler's stream seed and the first sample index; the
items, their order and their sizes are the same for every seed.
"""
from __future__ import annotations

import dataclasses
import time

import torch

SAMPLE_SPAN = 1 << 20       # first sample indices are drawn below this
WARM_SAMPLE = 1 << 21       # the warm-up item's sample index offset


@dataclasses.dataclass
class Item:
    index: int
    k: int
    sample_index: int
    pixel_idx: torch.Tensor
    samples: int


class Workload:
    def __init__(self, traffic: dict, resolution, seed: int, device):
        self.traffic = traffic
        self.w, self.h = resolution
        self.device = device
        self.rows = int(traffic["rows_per_tile"])
        self.n_tiles = -(-self.h // self.rows)
        self.per_item = int(traffic["tiles_per_item"])
        self.per_frame = max(1, self.n_tiles // self.per_item)
        self.seed = int(seed) & 0xFFFFFFFF
        gen = torch.Generator().manual_seed(int(seed))
        self.first_sample = int(torch.randint(0, SAMPLE_SPAN, (1,),
                                              generator=gen))
        self._gen = gen
        self.order = bit_reversed(self.per_frame)

    def tiles(self, k: int):
        return [k + j * self.per_frame for j in range(self.per_item)
                if k + j * self.per_frame < self.n_tiles]

    def pixels(self, k: int) -> torch.Tensor:
        parts = []
        for t in self.tiles(k):
            r0 = t * self.rows
            r1 = min(r0 + self.rows, self.h)
            parts.append(torch.arange(r0 * self.w, r1 * self.w,
                                      dtype=torch.int64))
        return torch.cat(parts).to(self.device)

    def item(self, i: int) -> Item:
        k = self.order[i % self.per_frame]
        px = self.pixels(k)
        return Item(i, k, self.first_sample + i // self.per_frame, px,
                    int(px.shape[0]) * int(self.traffic.get("waves", 1)))

    def warm_item(self) -> Item:
        px = self.pixels(0)
        return Item(-1, 0, self.first_sample + WARM_SAMPLE, px,
                    int(px.shape[0]))

    def check_lanes(self) -> torch.Tensor:
        """The lanes whose bounces the check follows, drawn from the seed."""
        n = int(self.traffic["lanes"])
        pick = torch.randperm(n, generator=self._gen)[
            :int(self.traffic["check_lanes"])]
        return torch.sort(pick).values.to(self.device)


def bit_reversed(n: int):
    """0 .. n-1 in the order of their bit-reversed values (van der Corput):
    each prefix spreads over the range as evenly as its length allows."""
    bits = max(1, (n - 1).bit_length())
    return sorted(range(n), key=lambda k: int(format(k, f"0{bits}b")[::-1],
                                              2))


def window(run_one, seconds: float, first: int = 0, sync=None,
           at_least: int = 1):
    """Run whole items from `first` while the next one, at the mean time
    of those before it, ends within `seconds` of the window's start (and
    at least `at_least` items); returns (items run, samples done, seconds
    from the start to the end of the last item, the items' end times)."""
    sync = sync or (lambda: None)
    sync()
    t0 = time.perf_counter()
    ends = []
    samples = 0
    i = first
    while True:
        now = time.perf_counter() - t0
        if len(ends) >= at_least and now + now / len(ends) > seconds:
            break
        samples += run_one(i)
        sync()
        ends.append(time.perf_counter() - t0)
        i += 1
    return i - first, samples, ends[-1], ends


def rate(samples: int, elapsed: float) -> float:
    """Samples of the completed items over the time from the window's
    start to the end of the last of them."""
    if elapsed <= 0:
        raise ValueError("no item completed in the window")
    return samples / elapsed
