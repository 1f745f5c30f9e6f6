"""Seeds derived from ``--seed``: every draw of the benchmark mixes the
run's seed with the name of what it draws, through sha256, so that one
seed gives the same inputs in every process and two draws never share a
stream."""

from __future__ import annotations

import hashlib

import numpy as np


def derive(seed: int, *words) -> int:
    """A 62-bit seed for the draw named by ``words`` in the run ``seed``
    (any whole number, negative or past 64 bits too)."""
    digest = hashlib.sha256(repr((int(seed),) + tuple(words)).encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 2


def rng(seed: int, *words) -> np.random.Generator:
    """A numpy generator for the draw named by ``words``."""
    return np.random.default_rng(derive(seed, *words))
