"""The readings that a cell's limits are set from: the check's numbers for
sound runs of the program on many seeds, and for the control and the
planted faults (``faults.py``) on a few, all at the cell's own size, in one
process a card (no measured window: the numbers come from the first
steps).

    python -m h100_bench.readings --workload <cell> --seeds 1,2,3 \\
        [--modes sound,tf32,half,altered] [--fault-seeds 3] [--out FILE]

Every seed's inputs, program graph and plan (or banks) and reference are
made once; each mode then builds a fresh model, optimiser and loop on
them (``Session.reset``). One JSON line a (seed, mode) on standard output
and, with ``--out``, in FILE (rank 0's, on several cards).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time


def read(rank: int, workload: str, seeds: list, modes: list,
         fault_seeds: int, out_path: str | None, cpu: bool = False,
         make_cell=None) -> None:
    """The readings of ``workload`` on this rank (every rank of a cell on
    several cards calls it; rank 0 runs the reference and writes).
    ``make_cell(name, seed)`` stands in for ``Cell.load``."""
    import torch

    from h100_bench import check
    from h100_bench.core import Cell
    from h100_bench.faults import planted

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = "cpu" if cpu else f"cuda:{rank}"
    out = open(out_path, "a") if out_path and rank == 0 else None
    try:
        for i, seed in enumerate(seeds):
            cell = (make_cell or Cell.load)(workload, seed)
            t0 = time.perf_counter()
            data = cell.generate()
            ref = (cell.reference().follow(cell.config, cell.settings, data,
                                           seed, device, 3)
                   if rank == 0 else None)
            ref_s = time.perf_counter() - t0
            session = cell.driver().setup(cell, device, data)
            for mode in modes if i < fault_seeds else ["sound"]:
                with planted(mode):
                    session.reset()
                    first = session.first_steps(3)
                gc.collect()
                if not cpu:
                    torch.cuda.empty_cache()
                if rank != 0:
                    continue
                values = check.numbers(first, ref, bool(
                    cell.config["model"].get("skip")))
                line = json.dumps({"workload": cell.name, "seed": seed,
                                   "mode": mode, "reference_s": ref_s,
                                   "numbers": values,
                                   "program_loss": first["train_loss"],
                                   "reference_loss": ref["train_loss"]})
                print(line, flush=True)
                if out:
                    print(line, file=out, flush=True)
            session.close()
            del session
            gc.collect()
    finally:
        if out:
            out.close()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="sound,tf32,half,altered")
    p.add_argument("--fault-seeds", type=int, default=3,
                   help="seeds (the first ones) that also read the modes "
                        "other than sound")
    p.add_argument("--out")
    args = p.parse_args(argv)
    from h100_bench.run import set_caches

    set_caches()
    import torch

    from h100_bench.core import Cell

    if not torch.cuda.is_available():
        print("readings: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    job = (args.workload, seeds, args.modes.split(","), args.fault_seeds,
           args.out)
    chips = Cell.load(args.workload, seeds[0]).chips
    if chips > 1:
        from h100_bench.ranks import run_ranks

        run_ranks(chips, read, job)
    else:
        read(0, *job)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
