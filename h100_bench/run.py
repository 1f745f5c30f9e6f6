"""One run of one cell of ``BENCHMARK.json`` on the card(s) of this host.

    python -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up, timed from the start of the process: the cell's inputs from the
seed, the program's graph and plans, the model (weights made on the card
from the seed), its optimiser and loop, and the loop's first three calls
(one epoch each; the first captures the fast loop's CUDA graph), whose
readings are kept for the check. The window then calls the loop, a whole
chunk of epochs at a time, until ``--seconds`` have passed, and ends in a
synchronize: ``epoch_ms`` is all of its wall time over all of its epochs.
``peak_mem_gib`` is the allocator's peak from the start to the window's
end. With ``--trace 1`` the run then profiles a steady stretch of chunks
and reads the per-layer metrics (``metrics/<name>.py``) instead.

Last, with the program's state freed, the plain reference follows the
same first steps on the same inputs, and ``correct`` says whether each of
the numbers of ``check.py`` is within the cell's limit. The last line of
standard output is one JSON object; the last lines of standard error
print each number compared beside its limit. Without CUDA, or with fewer
cards than the cell asks for, or if JAX or the JAX package was loaded,
the run prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "pygat_tpu")
STEPS = 3  # first steps the reference follows
GIB = 2.0 ** 30


def set_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the port's own libraries build into ``pygat_tpu_torch/_build/``)."""
    cache = os.path.join(ROOT, ".bench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = os.path.join(cache, sub)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class LayerContext:
    """What a per-layer metric reader is given."""

    stretch: object  # trace.Stretch
    epoch_ms: float  # the same run's untraced epoch time
    spans: dict  # set-up spans, seconds
    shapes: dict  # the session's shapes()
    launches: dict  # the port's wrapper calls an epoch, by kernel name
    flops: float  # FLOPs an epoch needs
    chips: int = 1  # the cards the epoch runs on


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def _finite(v):
    return v if math.isfinite(v) else str(v)


def _group():
    """(rank, world size, whether a group of several ranks is up)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), True
    return 0, 1, False


def _reduce(value: float, op: str, device) -> float:
    """``value`` reduced over the group (``max``, ``sum``) or, from rank 0,
    broadcast (``first``)."""
    import torch
    import torch.distributed as dist

    t = torch.tensor([float(value)], dtype=torch.float64, device=device)
    if op == "first":
        dist.broadcast(t, src=0)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max"
                        else dist.ReduceOp.SUM)
    return float(t.item())


def run_cell(cell, device, seconds: float, trace: bool, man: dict,
             steps: int = STEPS) -> dict | None:
    """Everything of a run but the look for a card and the module check;
    returns the result object (``checks`` last). On several ranks every
    rank calls it: rank 0 decides when the window closes, the peak is the
    fullest card's, ``busy_s`` the ranks' mean, the per-layer metrics are
    rank 0's, and rank 0 alone runs the reference and returns the result
    (the others None)."""
    import torch

    from h100_bench import check
    from h100_bench.core import end_to_end, load_module, metric_reader, per_layer
    from h100_bench.trace import traced_stretch

    rank, world, multi = _group()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with cell.spans.span("setup.data_s"):
        data = cell.generate()
    session = cell.driver().setup(cell, device, data)
    with cell.spans.span("setup.warm_s"):
        first = session.first_steps(steps)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START

    t0 = time.perf_counter()
    epochs = failed = 0
    while True:
        done, bad = session.run_chunk()
        epochs, failed = epochs + done, failed + bad
        stop = time.perf_counter() - t0 >= seconds
        if multi:
            stop = _reduce(stop, "first", device) > 0
        if stop:
            break
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    epoch_ms = wall * 1e3 / epochs
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if multi:
        peak = _reduce(peak, "max", device)

    units = {m["name"]: m["unit"] for m in man["end_to_end"] + man["per_layer"]}
    metrics: dict = {}
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(peak)}
    breakdown = None
    if trace:
        stretch = traced_stretch(session.run_chunk,
                                 int(cell.settings["trace_chunks"]))
        shapes = session.shapes()
        flops = load_module("flops", cell.config["flops"]).epoch_flops(
            cell.config["model"], shapes)
        ctx = LayerContext(stretch, epoch_ms, dict(cell.spans.seconds),
                           shapes, session.launches_per_epoch(), flops,
                           cell.chips)
        for m in per_layer(cell.name, man):
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        busy = stretch.busy_s()
        if multi:
            busy = _reduce(busy, "sum", device) / world
        info.update(busy_s=busy, window_s=stretch.wall_s)
        breakdown = {"device_ops": stretch.top_ops(),
                     "idle_gaps": stretch.idle_gaps()}
        print_unbounded({name for name, _, _ in stretch.kernels
                         if stretch.kind(name) == "port"})
    else:
        # an end-to-end metric is named by its quantity, or by its quantity
        # and the cells it is bounded for (``epoch_ms.<cells>``)
        quantity = {"epoch_ms": epoch_ms, "peak_mem_gib": peak / GIB,
                    "setup_s": setup_s}
        for m in end_to_end(cell.name, man):
            metrics[m["name"]] = {"value": quantity[m["name"].split(".")[0]],
                                  "unit": m["unit"]}
    if cuda:
        limit = _power_limit()
        if limit:
            info["power_limit"] = limit

    session.close()
    del session
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if rank != 0:
        return None
    ref = cell.reference().follow(cell.config, cell.settings, data,
                                  cell.seed, device, steps)
    values = check.numbers(first, ref, bool(cell.config["model"].get("skip")))
    ok, table = check.judge(values, cell.settings["limits"])
    result = {"correct": bool(ok and failed == 0), "attempted": epochs,
              "failed": failed, "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": _finite(v["value"]), "limit": v["limit"]}
                        for k, v in table.items()}
    return result


def rank_run(rank: int, workload: str, seed: int, seconds: float,
             trace: bool, cpu: bool = False):
    """One rank's part of a run of a cell on several cards (the group is
    up: ``ranks.run_ranks``); rank 0's result."""
    import torch

    from h100_bench.core import Cell, manifest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    man = manifest()
    device = "cpu" if cpu else f"cuda:{rank}"
    return run_cell(Cell.load(workload, seed, man), device, seconds, trace,
                    man)


def print_unbounded(port_kernels: set) -> None:
    """Name, on standard error, each port kernel of the trace that no
    bound file claims (it is counted in no roofline)."""
    import re

    from h100_bench.core import BENCH_DIR, load_module

    bounds = [load_module("bounds", f[:-3]).TRACE
              for f in sorted(os.listdir(os.path.join(BENCH_DIR, "bounds")))
              if f.endswith(".py")]
    for name in sorted(port_kernels):
        if not any(re.search(rx, name) for rx in bounds):
            print(f"no bound file: {name[:200]}", file=sys.stderr)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    set_caches()
    import torch

    from h100_bench.core import Cell, manifest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    man = manifest()
    cell = Cell.load(args.workload, args.seed, man)
    if not torch.cuda.is_available():
        print("h100_bench: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"h100_bench: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    # the port builds its kernel libraries at its first kernel launch, with
    # a CUDA context open; a checkout's first run builds them here instead,
    # before any context exists (set-up all the same)
    from pygat_tpu_torch.ops.build import build_all

    build_all()
    if cell.chips > 1:
        from h100_bench.ranks import run_ranks

        result = run_ranks(cell.chips, rank_run, (cell.name, cell.seed,
                                                  args.seconds,
                                                  bool(args.trace)))
    else:
        result = run_cell(cell, "cuda", args.seconds, bool(args.trace), man)
    found = forbidden_modules()
    if found:
        print(f"h100_bench: loaded {found} (the run must not load JAX or "
              "the JAX package)", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
