"""Whole runs of each cell of the manifest on the CPU at a small size: the
port against the plain reference within the cell's limits, and under each
planted fault ``correct`` false. Everything of a run but the look for a
card runs."""

from __future__ import annotations

import math

import pytest

from bench_cases import tiny_cell
from h100_bench.core import manifest
from h100_bench.faults import planted
from h100_bench.run import run_cell

SEED = 2 ** 31 + 12345  # past 32 signed bits, as a run's seed may be
CELLS = [w["name"] for w in manifest()["workloads"] if w["chips"] == 1]


def _run(name, man, mode="sound", seed=SEED):
    with planted(mode):
        return run_cell(tiny_cell(name, seed, man), "cpu", 0.2, False, man)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, man, cpu_threads):
    res = _run(name, man)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"epoch_ms", "peak_mem_gib", "setup_s"}
    for c in res["checks"].values():
        # the port and the reference agree far inside the limit at this size
        assert c["value"] <= c["limit"] / 10


@pytest.mark.parametrize("mode", ("frozen", "half", "altered"))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, mode, man, cpu_threads):
    res = _run(name, man, mode)
    assert not res["correct"]
    assert any(not isinstance(c["value"], float) or not math.isfinite(
        c["value"]) or c["value"] > c["limit"] for c in res["checks"].values())
