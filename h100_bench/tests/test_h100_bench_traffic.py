"""The generator: the same seed gives the same inputs, another seed other
inputs of the same sizes, simple undirected graphs with a self-loop a
node, and as many edges as the configuration's source counts."""

from __future__ import annotations

import numpy as np
import pytest

from h100_bench import core

PPI = {"features": 50, "labels": 121,
       "splits": {"train": [300, 250], "valid": [200], "test": [150]}}
BIG = 2 ** 31 + 99


def _ppi(seed):
    gen = core.load_module("traffic", "ppi_graphs")
    return gen.generate(core.read_json("traffic", "ppi-standin.json"), PPI,
                        seed)


def _same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", (3, BIG))
def test_deterministic_per_seed(seed):
    assert _same(_ppi(seed), _ppi(seed))
    assert not _same(_ppi(seed), _ppi(seed + 1))


def test_sizes_do_not_depend_on_the_seed():
    pa, pb = _ppi(3), _ppi(BIG)
    for split in PPI["splits"]:
        assert ([g["num_nodes"] for g in pa[split]]
                == [g["num_nodes"] for g in pb[split]] == PPI["splits"][split])
        for g in pa[split]:
            assert g["features"].shape == (g["num_nodes"], 50)
            assert g["labels"].shape == (g["num_nodes"], 121)


def test_ppi_graphs_are_simple_with_self_loops():
    for g in _ppi(BIG)["train"]:
        key = g["receivers"] * g["num_nodes"] + g["senders"]
        assert np.unique(key).size == key.size
        assert np.all(np.diff(key) > 0)
        loops = g["senders"] == g["receivers"]
        assert loops.sum() == g["num_nodes"]
        rev = np.sort(g["senders"] * g["num_nodes"] + g["receivers"])
        assert np.array_equal(rev, key)  # undirected


def test_ppi_edges_are_the_sources():
    """At the configuration's own sizes the graphs hold the undirected
    edges that the configuration's ``edges`` names (818,716 over PPI's
    56,944 nodes), to half a percent."""
    config = core.read_json("configs", "gat-ppi.json")
    graph = config["graph"]
    gen = core.load_module("traffic", "ppi_graphs")
    mix = core.read_json("traffic", "ppi-standin.json")
    out = gen.generate(mix, graph, BIG)
    nodes = sum(g["num_nodes"] for gs in out.values() for g in gs)
    edges = sum((len(g["senders"]) - g["num_nodes"]) // 2
                for gs in out.values() for g in gs)
    assert nodes == sum(map(sum, graph["splits"].values())) == 56944
    assert abs(edges / graph["edges"] - 1) < 0.005
