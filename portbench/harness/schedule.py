"""The one traffic generator: the calls of a mix, drawn from the seed.

A mix file (`traffic/<mix>.json`) lists call templates (a filter and a
level), the image sizes and the pool of images a size.  A template may
carry its own `sigma` and `radius`, as a UI user's sliders send them
(`{"filter": "gaussian", "sigma": 8.0, "radius": 12}`); a value it does
not carry is the one its configuration states for the filter.  Calls come
in balanced blocks:
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
    template: int = 0   # which template of the mix's `calls`

    def key(self) -> tuple:
        return (self.filter, self.level, self.sigma, self.radius, self.size)


def params(template: dict, config: dict) -> dict:
    """A template's `sigma` and `radius`: its own where it carries them,
    else its filter's in the configuration, as the configuration gives
    them."""
    stated = config["filters"][template["filter"]]
    return {k: template.get(k, stated.get(k, default))
            for k, default in (("sigma", 0.0), ("radius", 0))}


def _call(mix: dict, t: int, size: tuple[int, int], config: dict,
          image: int) -> Call:
    template = mix["calls"][t]
    p = params(template, config)
    return Call(template["filter"], int(template.get("level", 0)),
                float(p["sigma"]), int(p["radius"]), size, image, t)


def block(mix: dict, config: dict, rng: np.random.Generator) -> list[Call]:
    """One balanced block of the mix's calls, in seeded order."""
    entries = [(t, tuple(s)) for s in mix["sizes"]
               for t in range(len(mix["calls"]))]
    order = rng.permutation(len(entries))
    return [_call(mix, *entries[i], config,
                  int(rng.integers(mix.get("pool", 1)))) for i in order]


def calls(mix: dict, config: dict, rng: np.random.Generator
          ) -> Iterator[Call]:
    """The mix's calls without end, block after block."""
    while True:
        yield from block(mix, config, rng)


def distinct_work(mix: dict, config: dict) -> list[Call]:
    """One call of each size and template, on image 0: what a warm-up has
    to have run."""
    return [_call(mix, t, tuple(s), config, 0) for s in mix["sizes"]
            for t in range(len(mix["calls"]))]
