"""The manifest against the benchmark's contract, and the files it names
found by name: a new cell is files and entries, never an edit."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from h100_bench import core

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|projection|_dim$"
                   r"|_rank$|head|expansion|widths?$|per_token)")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def test_keys_names_and_units(man):
    assert set(man) == TOP_KEYS
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    assert 1 <= len(man["paths"]) <= 16 and len(man["command"]) <= 32
    for p in man["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert ".." not in p and not p.startswith("/")
    for word in man["command"]:
        assert LINE.match(word) and not word.startswith("/") and ".." not in word
    assert 1 <= len(man["configs"]) <= 24 and 1 <= len(man["workloads"]) <= 24
    assert 1 <= len(man["end_to_end"]) <= 16 and 1 <= len(man["per_layer"]) <= 128
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["source"]) and LINE.match(c["why"])
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key)
        names.append(c["name"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and LINE.match(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
        names.append(w["name"])
    four = sum(w["chips"] == 4 for w in man["workloads"])
    assert four <= max(1, len(man["workloads"]) // 4)
    assert len({(w["config"], w["traffic"]) for w in man["workloads"]}) == len(
        man["workloads"])
    for m in man["end_to_end"] + man["per_layer"]:
        allowed = {"name", "unit", "better", "source", "workloads"}
        allowed |= ({"bound"} if m in man["end_to_end"]
                    else {"layer", "moves"})
        assert set(m) <= allowed
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for name in names:
        assert NAME.match(name), name
    assert len(names) == len(set(names))
    assert os.path.getsize(core.MANIFEST) <= 64 * 1024


def test_end_to_end_metrics(man):
    by = {m["name"]: m for m in man["end_to_end"]}
    assert {"epoch_ms", "peak_mem_gib", "setup_s"} <= set(by)
    assert by["setup_s"]["bound"] <= 0.25
    for w in man["workloads"]:
        names = [m["name"].split(".")[0]
                 for m in core.end_to_end(w["name"], man)]
        assert sorted(names) == ["epoch_ms", "peak_mem_gib", "setup_s"]
        assert core.per_layer(w["name"], man)
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_moves_what_their_cells_report(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    cells = [w["name"] for w in man["workloads"]]
    for m in man["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert LINE.match(m["layer"])
        moved = e2e[m["moves"]]
        reporting = moved.get("workloads", cells)
        for cell in m.get("workloads", reporting):
            assert cell in reporting and cell in cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_finds_its_files(man):
    for w in man["workloads"]:
        cell = core.Cell.load(w["name"], 1, man)
        assert cell.driver().setup and cell.reference().follow
        assert core.has_module("traffic", cell.mix["generator"])
        assert core.has_module("flops", cell.config["flops"])
        assert set(cell.settings["limits"]) == {
            "loss_gap", "val_loss_gap", "grad_gap", "update_gap"}
    for c in man["configs"]:
        assert c["file"].startswith(man["paths"][0] + "/")
        with open(os.path.join(core.ROOT, c["file"])) as f:
            body = json.load(f)
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
    for m in man["per_layer"]:
        assert callable(core.metric_reader(m["name"]))
        if m["name"].endswith("_roofline"):
            bound = core.load_module("bounds", m["name"][:-len("_roofline")])
            assert bound.TRACE and bound.COUNTER and callable(bound.calls)


def test_a_new_cell_is_files_and_entries(tmp_path, monkeypatch, man,
                                         cpu_threads):
    """A workload added as a traffic file, a cell file, a configuration
    file and manifest entries runs with no code edited."""
    from bench_cases import TINY_PPI
    from h100_bench.run import run_cell

    bench = tmp_path / "h100_bench"
    shutil.copytree(core.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(bench / "traffic" / "ppi-sparse.json", "w") as f:
        json.dump(dict(core.read_json("traffic", "ppi-standin.json"),
                       avg_degree=6.0), f)
    shutil.copy(bench / "workloads" / "ppi-gat-banked.json",
                bench / "workloads" / "small-ppi-sparse.json")
    config = core.read_json("configs", "gat-ppi.json")
    config["graph"]["splits"] = TINY_PPI
    config["model"].update(heads=[2, 2, 3], widths=[50, 16, 16, 121])
    with open(bench / "configs" / "gat-small.json", "w") as f:
        json.dump(dict(config, name="gat-small"), f)
    new = json.loads(json.dumps(man))
    new["configs"].append(dict(new["configs"][0], name="gat-small",
                               file="h100_bench/configs/gat-small.json"))
    new["workloads"].append(dict(new["workloads"][0], name="small-ppi-sparse",
                                 config="gat-small", traffic="ppi-sparse"))
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(new, f)
    monkeypatch.setattr(core, "BENCH_DIR", str(bench))
    monkeypatch.setattr(core, "ROOT", str(tmp_path))
    monkeypatch.setattr(core, "MANIFEST", str(tmp_path / "BENCHMARK.json"))
    cell = core.Cell.load("small-ppi-sparse", 7)
    assert cell.mix["avg_degree"] == 6.0
    res = run_cell(cell, "cpu", 0.1, False, core.manifest())
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("kind", ("configs", "workloads", "traffic"))
def test_data_files_are_json(kind):
    folder = os.path.join(core.BENCH_DIR, kind)
    for fn in os.listdir(folder):
        if fn.endswith(".json"):
            with open(os.path.join(folder, fn)) as f:
                assert isinstance(json.load(f), dict)
