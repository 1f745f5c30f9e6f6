"""The control on the card: the program with float32 products in TF32, the
next precision below the configurations' float32, has to come out as not
correct against the cell's limits, where the program as it is comes out
correct. At each cell's own size, on one seed; ``readings.py`` reads the
same on more.

    python -m pytest h100_bench/tests -m cuda
"""

from __future__ import annotations

import pytest

from h100_bench.core import Cell, manifest
from h100_bench.faults import planted
from h100_bench.run import run_cell

SEED = 2 ** 31 + 777
CELLS = [w["name"] for w in manifest()["workloads"] if w["chips"] == 1]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_tf32_is_not_correct(name, man, card):
    import torch

    sound = run_cell(Cell.load(name, SEED, man), "cuda", 0.2, False, man)
    assert sound["correct"], sound["checks"]
    with planted("tf32"):
        control = run_cell(Cell.load(name, SEED, man), "cuda", 0.2, False,
                           man)
    assert not control["correct"], control["checks"]
    assert not torch.backends.cuda.matmul.allow_tf32
