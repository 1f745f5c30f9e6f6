"""What every run shares: the manifest (``BENCHMARK.json``) and the files
found by name beside it, the set-up spans, and the loading of a cell.

A cell is one entry of the manifest's ``workloads``. Its files:
``configs/<config>.json`` (the model and the graph's scale, named by the
manifest's ``configs`` entry), ``workloads/<cell>.json`` (the loop driver
and its settings, the reference's settings and the limits of ``correct``),
``traffic/<traffic>.json`` (the mix's parameters and the generator that
reads them, ``traffic/<generator>.py``) and ``drivers/<loop>.py``. A later
cell adds files and manifest entries; no file here names a cell.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import re
import time
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
MANIFEST = os.path.join(ROOT, "BENCHMARK.json")


def manifest() -> dict:
    with open(MANIFEST) as f:
        return json.load(f)


def read_json(*parts: str) -> dict:
    with open(os.path.join(BENCH_DIR, *parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``h100_bench/<kind>/<name>.py`` as a module (names may hold dots
    and dashes, so the file is loaded by its path)."""
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    mod_name = f"h100_bench.{kind}._" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def has_module(kind: str, name: str) -> bool:
    return os.path.isfile(os.path.join(BENCH_DIR, kind, f"{name}.py"))


def metric_reader(name: str):
    """The reader of a per-layer metric: ``metrics/<name>.py``, or for a
    metric split by the end-to-end metric it moves (``idle_share.<cells>``)
    the reader of the name without its last part."""
    while not has_module("metrics", name) and "." in name:
        name = name.rsplit(".", 1)[0]
    return load_module("metrics", name).read


def end_to_end(cell: str, man: dict) -> list[dict]:
    """The manifest's end-to-end metrics that ``cell`` reports."""
    return [m for m in man["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer(cell: str, man: dict) -> list[dict]:
    """The manifest's per-layer metrics that ``cell`` reports: those that
    list it, and those without a list that move an end-to-end metric it
    reports."""
    moved = {m["name"] for m in end_to_end(cell, man)}
    return [m for m in man["per_layer"]
            if cell in m.get("workloads", ()) or
            ("workloads" not in m and m["moves"] in moved)]


@dataclass
class Spans:
    """Host-clock set-up spans, by per-layer metric name."""

    seconds: dict = field(default_factory=dict)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)


@dataclass
class Cell:
    """A cell as its files give it, for one run's seed."""

    name: str
    entry: dict  # the manifest's workloads entry
    config: dict  # configs/<config>.json
    settings: dict  # workloads/<cell>.json
    mix: dict  # traffic/<traffic>.json
    seed: int
    spans: Spans = field(default_factory=Spans)

    @classmethod
    def load(cls, name: str, seed: int, man: dict | None = None) -> "Cell":
        man = manifest() if man is None else man
        entry = next((w for w in man["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in {MANIFEST}")
        cfg_entry = next(c for c in man["configs"]
                         if c["name"] == entry["config"])
        with open(os.path.join(ROOT, cfg_entry["file"])) as f:
            config = json.load(f)
        return cls(name=name, entry=entry, config=config,
                   settings=read_json("workloads", f"{name}.json"),
                   mix=read_json("traffic", f"{entry['traffic']}.json"),
                   seed=int(seed))

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])

    def generate(self) -> dict:
        """The cell's inputs from the seed (host arrays)."""
        gen = load_module("traffic", self.mix["generator"])
        return gen.generate(self.mix, self.config["graph"], self.seed)

    def driver(self):
        return load_module("drivers", self.settings["driver"])

    def reference(self):
        return load_module("reference", self.config["reference"])
