"""A cell on four cards, on the CPU: four processes joined by gloo, each a
rank of the data-parallel loop over the PPI configuration, rank 0's run
against the reference's super-steps; correct as it is, not correct with
the exchange between the ranks left out or half of each batch left out,
and no result at all where a rank other than the one that prints has
loaded JAX."""

from __future__ import annotations

import pytest

from bench_cases import tiny_rank_run
from h100_bench.ranks import run_ranks

SEED = 2 ** 31 + 2468
CELL = "ppi-gat-banked"
WORLD = 4


@pytest.mark.parametrize("mode", ("sound", "exchange", "half"))
def test_ranks(mode):
    res = run_ranks(WORLD, tiny_rank_run, (CELL, SEED, mode, WORLD),
                    cpu=True)
    assert res["correct"] == (mode == "sound"), res["checks"]
    assert res["device"]["count"] == WORLD


def test_a_rank_that_loaded_jax_fails_the_run():
    with pytest.raises(RuntimeError, match="a rank ended"):
        run_ranks(WORLD, tiny_rank_run, (CELL, SEED, "sound", WORLD, 1),
                  cpu=True)
