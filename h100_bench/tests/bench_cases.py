"""The cells the CPU tests run, at a size a test run holds, with their own
files otherwise (driver, reference, limits and traffic mix)."""

from __future__ import annotations

import copy
import sys
import types

from h100_bench import core
from h100_bench.core import Cell

# small cells: PPI's splits at a few hundred nodes a graph, 2, 2 and 3
# heads of 16, 16 and 121 unless a test keeps the published widths
TINY_PPI = {"train": [300, 250, 280, 310], "valid": [200, 220],
            "test": [150, 170]}


def tiny_cell(name: str, seed: int, man: dict | None = None,
              widths: bool = False, data_parallel: int = 1) -> Cell:
    """``name`` on small graphs; ``widths`` keeps PPI's published heads
    and widths; ``data_parallel`` > 1 makes it a cell of that many cards,
    the configuration trained data-parallel over them."""
    cell = Cell.load(name, seed, man or core.manifest())
    cell.config = copy.deepcopy(cell.config)
    graph, model = cell.config["graph"], cell.config["model"]
    graph["splits"] = TINY_PPI
    if not widths:
        model["heads"] = [2, 2, 3]
        model["widths"] = [model["widths"][0], 16, 16, model["widths"][-1]]
    if data_parallel > 1:
        cell.config["deployment"] = {"data_parallel": data_parallel}
        cell.entry = dict(cell.entry, chips=data_parallel)
    return cell


def tiny_rank_run(rank: int, name: str, seed: int, mode: str, world: int,
                  load_jax_on: int | None = None):
    """One rank's run of ``name`` at the small size on the CPU, trained
    data-parallel over ``world`` ranks, under the planted ``mode``
    (``ranks.run_ranks``' function). Rank ``load_jax_on`` puts a module
    named ``jax`` among its loaded modules during its run."""
    import torch

    from h100_bench.faults import planted
    from h100_bench.run import run_cell

    torch.set_num_threads(1)
    if rank == load_jax_on:
        sys.modules.setdefault("jax", types.ModuleType("jax"))
    man = core.manifest()
    with planted(mode):
        return run_cell(tiny_cell(name, seed, man, data_parallel=world),
                        "cpu", 0.2, False, man)
