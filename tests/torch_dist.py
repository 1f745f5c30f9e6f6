"""Process groups for the port's distributed tests, on the CPU (gloo).

:class:`GroupRun` spawns one process a rank, joins them into a gloo group
by a ``file://`` rendezvous in the test's own directory (never a fixed
port: six test workers run at once), runs ``fn(rank, world, *args)`` in
each and returns each rank's result. Every group waits for a peer at most
60 s; the parent gives the ranks ``timeout`` seconds in all, then kills
what is left and raises, so a test never waits on a dead rank. Groups
start at once and are waited for later, so two groups, and the parent's
own work, overlap. Each rank
runs one torch thread. The rank functions live here, with no JAX import:
a spawned rank imports this module, not the test's.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import time
import traceback

import numpy as np

GROUP_TIMEOUT = datetime.timedelta(seconds=60)


def _rank_main(fn, rank, world, init, out, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, rank=rank,
                                world_size=world, timeout=GROUP_TIMEOUT)
        try:
            out.put((rank, True, fn(rank, world, *args)))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which fails the test
        out.put((rank, False, traceback.format_exc()))
        raise


class GroupRun:
    """``fn(rank, world, *args)`` for every rank, each in its own process of
    one gloo group, started at once; :meth:`results` waits for them (the
    caller may work meanwhile, or start another group)."""

    def __init__(self, fn, world: int, tmp_dir, *args,
                 timeout: float = 120.0):
        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self._out = ctx.Queue()
        init = "file://" + os.path.join(str(tmp_dir), f"rendezvous-{world}")
        self._procs = [ctx.Process(target=_rank_main,
                                   args=(fn, r, world, init, self._out, args),
                                   daemon=True)
                       for r in range(world)]
        for p in self._procs:
            p.start()
        self._deadline = time.monotonic() + timeout
        self._results = None

    def results(self) -> list:
        """Each rank's result, in rank order; raises with the failing
        ranks' traces, or once the group's ``timeout`` has passed (then
        killing what is left)."""
        if self._results is not None:
            return self._results
        results, errors = {}, []
        try:
            # drain the queue before joining (a rank blocks on a full pipe)
            while len(results) + len(errors) < self.world:
                left = self._deadline - time.monotonic()
                if left <= 0:
                    errors.append(f"ranks timed out after {self.timeout:.0f} s")
                    break
                try:
                    rank, ok, payload = self._out.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [p.exitcode for p in self._procs
                            if p.exitcode not in (None, 0)]
                    if dead and self._out.empty():
                        errors.append(f"a rank died with exit code {dead[0]}")
                        break
                    continue
                if ok:
                    results[rank] = payload
                else:
                    errors.append(f"rank {rank}:\n{payload}")
        finally:
            for p in self._procs:
                p.join(timeout=max(self._deadline - time.monotonic(), 0) + 5)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        if errors:
            raise AssertionError("process group failed:\n" + "\n".join(errors))
        self._results = [results[r] for r in range(self.world)]
        return self._results


# ---------------------------------------------------------------------------
# Rank functions
# ---------------------------------------------------------------------------


def _dataset(spec):
    """The spec's small citation dataset on the CPU (port types)."""
    import torch

    from pygat_tpu_torch.data.citation import CitationDataset
    from pygat_tpu_torch.graph import build_graph

    g = build_graph(spec["send"], spec["recv"], None, spec["n"],
                    n_pad=spec["n_pad"], device="cpu")

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    return CitationDataset(g, t(spec["x"]), t(spec["labels"]),
                           t(spec["idx_train"]), t(spec["idx_val"]),
                           t(spec["idx_test"]), spec["n_classes"],
                           spec["x"].shape[1], ())


def _params(cfg, arrays):
    import torch

    from pygat_tpu_torch.models.layers import V1Params, V2Params

    cls = V2Params if cfg.is_v2 else V1Params
    return [cls(*(None if a is None else
                  torch.from_numpy(a.copy()).requires_grad_()
                  for a in layer)) for layer in arrays]


def ring_steps(rank, world, spec, cases, steps):
    """Per case (layer type, halo, fused): this rank's rows of the ring
    forward (no dropout), its loss, the all-reduced gradients and the
    parameters after one and after ``steps`` Adam steps, as numpy."""
    import torch

    from pygat_tpu_torch.models.gat import GATConfig, parameters
    from pygat_tpu_torch.ops.fused_stream import set_fused_attention
    from pygat_tpu_torch.parallel.distributed import all_reduce_grads
    from pygat_tpu_torch.parallel.mesh import make_mesh
    from pygat_tpu_torch.parallel.ring_model import RingLoss
    from pygat_tpu_torch.train.logging import TrainLogger
    from pygat_tpu_torch.train.loop import _ring_setup
    from pygat_tpu_torch.train.state import make_optimizer

    mesh = make_mesh(world, 1, device="cpu")
    ds = _dataset(spec)
    quiet = TrainLogger(stream=open(os.devnull, "w"))
    got = {}
    local, ring0 = _ring_setup(GATConfig(**spec["cfg"]), ds, mesh, quiet)
    for lt, halo, fused in cases:
        cfg = GATConfig(layer_type=lt, **spec["cfg"])
        ring = RingLoss(cfg, ring0.blocks, halo)
        params = _params(cfg, spec["params"][lt])
        opt = make_optimizer(params, spec["lr"], spec["wd"])
        set_fused_attention("on" if fused else "off")
        rec = {}
        # the bit-equality check needs several steps of one case only
        for step in range(steps if (halo, fused) == (True, True) else 1):
            opt.zero_grad(set_to_none=True)
            loss, _, out = ring(params, local.features, None, local.labels,
                                local.idx_train, None, True)
            loss.backward()
            all_reduce_grads(params)
            if step == 0:
                rec["out"] = out.detach().numpy()
                rec["loss"] = float(loss)
                rec["grads"] = [p.grad.numpy().copy()
                                for p in parameters(params)]
            opt.step()
            if step == 0:
                rec["params1"] = [p.detach().numpy().copy()
                                  for p in parameters(params)]
        rec["params_last"] = [p.detach().numpy().copy()
                              for p in parameters(params)]
        got[(lt, halo, fused)] = rec
    set_fused_attention("auto")
    quiet.stream.close()
    return got


def cli_runs(rank, world, runs, tmp_dir):
    """Each ``(argv, env)`` of ``runs`` through ``cli.train.main`` on this
    rank's gloo group; returns rank 0's epoch records of each run."""
    import json

    from pygat_tpu_torch.cli.train import main

    recs = []
    for i, (argv, env) in enumerate(runs):
        jsonl = os.path.join(str(tmp_dir), f"run{i}-{rank}.jsonl")
        old = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            with open(os.devnull, "w") as quiet:
                import contextlib

                with contextlib.redirect_stdout(quiet):
                    rc = main([*argv, "--no-cuda", "--no-checkpoint",
                               "--log-every", "1", "--jsonl", jsonl])
        finally:
            for k, v in old.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        assert rc == 0
        if rank == 0:
            with open(jsonl) as fh:
                recs.append([json.loads(line) for line in fh])
        else:
            assert not os.path.exists(jsonl)
    return recs


def group_work(rank, world, ring_spec, cases, steps, runs, ppi_spec,
               tmp_dir):
    """One group's whole share of a test module: :func:`ring_steps`,
    :func:`cli_runs`, with ``ppi_spec`` :func:`banked_dp` (and in a group
    of 2 :func:`fast_dp`), the error of a
    mesh one rank larger than the group, and the ranks' agreement on a
    capture that held everywhere and on one the last rank refused (one
    spawn a module and group size)."""
    from pygat_tpu_torch.parallel.mesh import make_mesh
    from pygat_tpu_torch.train.loop import _agree_on_capture

    try:  # a mesh the group's size does not fit
        make_mesh(world + 1, 1, device="cpu")
        wrong_size = None
    except RuntimeError as exc:
        wrong_size = str(exc)
    return dict(ring=ring_steps(rank, world, ring_spec, cases, steps),
                cli=cli_runs(rank, world, runs, tmp_dir),
                ppi=None if ppi_spec is None
                else banked_dp(rank, world, ppi_spec),
                ppi_fast=None if ppi_spec is None or world != 2
                else fast_dp(rank, world, ppi_spec),
                wrong_size=wrong_size,
                capture=[_agree_on_capture(None, "cpu"), _agree_on_capture(
                    "RuntimeError: refused" if rank == world - 1 else None,
                    "cpu")])


def banked_dp(rank, world, spec):
    """``fit_inductive_banked(mesh=)`` on the spec's tiny PPI data; returns
    the validation history, the best epoch and the final parameters."""
    import torch

    from pygat_tpu_torch.data import ppi as tppi
    from pygat_tpu_torch.models.gat import GATConfig, parameters
    from pygat_tpu_torch.parallel.mesh import make_mesh
    from pygat_tpu_torch.train.inductive import fit_inductive_banked
    from pygat_tpu_torch.train.logging import TrainLogger
    from tests.torch_ppi_data import synth_ppi

    mesh = make_mesh(world, 1, device="cpu")
    cfg = GATConfig(**spec["cfg"])
    with open(os.devnull, "w") as quiet:
        res = fit_inductive_banked(
            cfg, synth_ppi(tppi.PPIGraph, tppi.PPIData), mesh=mesh,
            init_params=_params(cfg, spec["params"]),
            logger=TrainLogger(stream=quiet), **spec["kw"])
    with torch.no_grad():
        final = [p.numpy().copy() for p in parameters(res.state.params)]
    return dict(history=res.history, best_epoch=res.best_epoch,
                params=final, test_loss=res.test_loss)


def fast_dp(rank, world, spec):
    """``fit_inductive_fast(mesh=)`` on the spec's tiny PPI data for the
    epochs of ``spec["fast_kw"]``; returns the validation history, the best
    epoch, the test loss and the final parameters."""
    import torch

    from pygat_tpu_torch.data import ppi as tppi
    from pygat_tpu_torch.models.gat import GATConfig, parameters
    from pygat_tpu_torch.parallel.mesh import make_mesh
    from pygat_tpu_torch.train.inductive import fit_inductive_fast
    from pygat_tpu_torch.train.logging import TrainLogger
    from tests.torch_ppi_data import synth_ppi

    mesh = make_mesh(world, 1, device="cpu")
    cfg = GATConfig(**spec["cfg"])
    with open(os.devnull, "w") as quiet:
        res = fit_inductive_fast(
            cfg, synth_ppi(tppi.PPIGraph, tppi.PPIData), mesh=mesh,
            init_params=_params(cfg, spec["params"]),
            logger=TrainLogger(stream=quiet), **spec["fast_kw"])
    with torch.no_grad():
        final = [p.numpy().copy() for p in parameters(res.state.params)]
    return dict(history=res.history, best_epoch=res.best_epoch,
                params=final, test_loss=res.test_loss,
                test_acc=res.test_acc)
