"""The one traffic generator: the calls of a mix, drawn from the seed.

A mix file (`traffic/<mix>.json`) lists call templates (a filter and a
level), the image sizes and the pool of images a size; each filter takes
the parameters its configuration states.  Calls come in balanced blocks:
each block holds every size with every template once, in a seeded order,
each call on an image drawn from its size's pool.  So every seed gives
the same mix of work in another order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class Call:
    filter: str
    level: int
    sigma: float
    radius: int
    size: tuple[int, int]
    image: int          # which image of the size's pool

    def key(self) -> tuple:
        return (self.filter, self.level, self.sigma, self.radius, self.size)


def _call(template: dict, size: tuple[int, int], config: dict,
          image: int) -> Call:
    params = config["filters"][template["filter"]]
    return Call(template["filter"], int(template.get("level", 0)),
                float(params.get("sigma", 0.0)), int(params.get("radius", 0)),
                size, image)


def block(mix: dict, config: dict, rng: np.random.Generator) -> list[Call]:
    """One balanced block of the mix's calls, in seeded order."""
    entries = [(t, tuple(s)) for s in mix["sizes"] for t in mix["calls"]]
    order = rng.permutation(len(entries))
    return [_call(*entries[i], config, int(rng.integers(mix.get("pool", 1))))
            for i in order]


def calls(mix: dict, config: dict, rng: np.random.Generator
          ) -> Iterator[Call]:
    """The mix's calls without end, block after block."""
    while True:
        yield from block(mix, config, rng)


def distinct_work(mix: dict, config: dict) -> list[Call]:
    """One call of each size and template, on image 0: what a warm-up has
    to have run."""
    return [_call(t, tuple(s), config, 0) for s in mix["sizes"]
            for t in mix["calls"]]
