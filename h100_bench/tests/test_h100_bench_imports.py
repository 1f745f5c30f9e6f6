"""The import rule, by the syntax tree: no module of the benchmark imports
JAX or the JAX package (top-level names compared whole, so the port,
``pygat_tpu_torch``, passes), the reference imports nothing of the port,
and nothing reads the JAX package's benchmark (``bench.py``,
``benchmarks/``)."""

from __future__ import annotations

import ast
import os
import sys

import pytest

from h100_bench import core, run

JAX_NAMES = {"jax", "jaxlib", "flax", "pygat_tpu"}


def _sources():
    for root, _, files in os.walk(core.BENCH_DIR):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(root, fn)


def _imported(path: str) -> set[str]:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in _sources():
        assert not _imported(path) & JAX_NAMES, path


def test_the_reference_imports_nothing_of_the_port():
    ref = os.path.join(core.BENCH_DIR, "reference")
    for fn in os.listdir(ref):
        if fn.endswith(".py"):
            names = _imported(os.path.join(ref, fn))
            assert "pygat_tpu_torch" not in names and not names & JAX_NAMES
            assert names <= {"__future__", "contextlib", "math", "numpy", "torch",
                             "h100_bench"}, (fn, names)


def test_nothing_reads_the_jax_benchmark():
    for path in _sources():
        if os.path.basename(path) == os.path.basename(__file__):
            continue
        with open(path) as f:
            text = f.read()
        assert "bench.py" not in text and "benchmarks/" not in text, path
        assert not _imported(path) & {"bench", "benchmarks"}, path


def test_the_port_is_not_taken_for_the_jax_package():
    assert "pygat_tpu_torch".split(".")[0] not in JAX_NAMES


def test_a_run_refuses_a_loaded_jax(monkeypatch):
    assert run.forbidden_modules() == [] or "jax" not in sys.modules
    modules = dict(sys.modules)
    modules["pygat_tpu.ops"] = object()
    modules["pygat_tpu_torch.ops"] = object()
    monkeypatch.setattr(sys, "modules", modules)
    assert run.forbidden_modules() == ["pygat_tpu"]


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run, "set_caches", lambda: None)
    assert run.main(["--workload", "ppi-gat-banked", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""


def test_unknown_cell_fails():
    with pytest.raises(KeyError):
        core.Cell.load("no-such-cell", 1)
