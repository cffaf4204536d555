"""The one traffic generator: a closed loop of requests drawn from a pool of
seeded phantoms, read from a traffic mix's parameters
(``benchmark/traffic/<name>.json``):

* ``entry``: how a request enters the program (``harness/entries.py``):
  ``resident`` (images on the card), ``host`` (pageable host memory in,
  host arrays out) or ``mesh`` (batches over every card of the cell);
* ``pool``: where the pool lies, ``device`` (the first card) or ``host``
  (pageable host memory);
* ``pool_images``: distinct phantoms in the pool;
* ``cycle``: {images per request: requests a cycle}; every cycle sends
  this multiset of sizes in an order drawn from the seed, so every seed
  does the same work in another order;
* ``dose``: [lo, hi] photons a pixel (``full_well``) of the phantoms;
* ``sample_requests``: the requests whose outputs are compared with the
  reference after the window (a uniform sample drawn from the seed over
  every request the window completed, with the largest request in it);
* ``trace_requests``: the requests a ``--trace 1`` run records.

Each request takes a contiguous run of the pool (a view, nothing copied by
the harness) at an offset drawn from the seed.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Dict, Iterator, List, Tuple


@dataclass(frozen=True)
class Mix:
    entry: str
    pool: str
    pool_images: int
    cycle: Dict[int, int]
    dose: Tuple[float, float]
    sample_requests: int
    trace_requests: int

    @classmethod
    def from_json(cls, d: dict) -> "Mix":
        cycle = {int(k): int(v) for k, v in d["cycle"].items()}
        if max(cycle) > d["pool_images"]:
            raise ValueError(f"a request of {max(cycle)} images from a pool of "
                             f"{d['pool_images']}")
        if d["pool"] not in ("device", "host"):
            raise ValueError(f"pool {d['pool']!r}: 'device' or 'host'")
        return cls(d["entry"], d["pool"], int(d["pool_images"]), cycle, tuple(d["dose"]),
                   int(d["sample_requests"]), int(d["trace_requests"]))

    @property
    def sizes(self) -> List[int]:
        """The request sizes the mix sends, each once (the warm-up's)."""
        return sorted(self.cycle)


def requests(mix: Mix, seed: int) -> Iterator[Tuple[int, int]]:
    """Endless ``(start, count)`` pool runs: cycle after cycle, each the
    mix's multiset of sizes shuffled, each request at a seeded offset."""
    rng = random.Random(f"traffic:{seed}")
    one_cycle = [k for k, times in sorted(mix.cycle.items()) for _ in range(times)]
    while True:
        order = one_cycle[:]
        rng.shuffle(order)
        for k in order:
            yield rng.randrange(mix.pool_images - k + 1), k


class Sample:
    """A uniform sample of ``size`` of the requests offered to ``offer``
    (reservoir sampling from the seed), plus the first of the largest
    size: the outputs the comparison reads after the window."""

    def __init__(self, size: int, seed: int, largest: int):
        self.size, self.largest = size, largest
        self.rng = random.Random(f"sample:{seed}")
        self.seen = 0
        self.kept: List[tuple] = []
        self.big = None

    def offer(self, item: tuple, count: int) -> None:
        if self.big is None and count == self.largest:
            self.big = item
            return
        self.seen += 1
        if len(self.kept) < self.size:
            self.kept.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.kept[j] = item

    def items(self) -> List[tuple]:
        return ([self.big] if self.big is not None else []) + self.kept
