"""A cell on several cards of one host: one process a card, joined by a
``torch.distributed`` group (NCCL; gloo on the CPU), as ``torchrun`` would
start the port's trainers.

The calling process is rank 0 and stays the one that prints; the others
are started with the ``spawn`` method, given the group's address
(``localhost`` and a free port), their rank and the world size, and are
waited for before rank 0 returns (ended if one outlives it). Each rank
runs the same function; rank 0's result is returned. A rank that has
loaded JAX or the JAX package by the end of its work names it on standard
error and exits with 3, so that ``run_ranks`` raises and the run prints
no result (rank 0's own modules are ``run.main``'s to check). Every rank
keeps one CPU thread for PyTorch's own pools, as ``torchrun`` sets
``OMP_NUM_THREADS=1`` for each process it starts.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket
import sys
import traceback

JOIN_S = 120.0  # what rank 0 waits for the others after its own work


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _enter(rank: int, world: int, port: int, cpu: bool) -> None:
    """This process's place in the group, and the group brought up."""
    import torch

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    torch.set_num_threads(1)
    from pygat_tpu_torch.parallel.mesh import initialize_distributed

    initialize_distributed(cpu=cpu)


def _leave() -> None:
    import torch.distributed as dist

    if dist.is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def _worker(rank: int, world: int, port: int, cpu: bool, fn, args) -> None:
    from h100_bench.run import forbidden_modules

    try:
        _enter(rank, world, port, cpu)
        fn(rank, *args)
        _leave()
    except BaseException:
        traceback.print_exc(file=sys.stderr)
        raise
    found = forbidden_modules()
    if found:
        print(f"h100_bench: rank {rank} loaded {found} (the run must not "
              "load JAX or the JAX package)", file=sys.stderr)
        sys.exit(3)


def run_ranks(world: int, fn, args: tuple, *, cpu: bool = False):
    """``fn(rank, *args)`` on ``world`` ranks; rank 0's return value."""
    import torch

    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_worker, args=(r, world, port, cpu, fn, args),
                         daemon=True) for r in range(1, world)]
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"  # what the spawned ranks start with
    try:
        for p in procs:
            p.start()
    finally:
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    own = torch.get_num_threads()
    try:
        _enter(0, world, port, cpu)
        out = fn(0, *args)
        _leave()
    finally:
        torch.set_num_threads(own)
        for p in procs:
            p.join(JOIN_S)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    bad = [p.exitcode for p in procs if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"a rank ended with {bad}")
    return out
