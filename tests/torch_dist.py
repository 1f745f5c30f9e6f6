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


def cli_runs(rank, world, runs, tmp_dir, tag="run"):
    """Each ``(argv, env)`` of ``runs`` through ``cli.train.main`` on this
    rank's gloo group; returns rank 0's epoch records of each run (logged
    to ``{tag}{i}-{rank}.jsonl`` in ``tmp_dir``)."""
    import json

    from pygat_tpu_torch.cli.train import main

    recs = []
    for i, (argv, env) in enumerate(runs):
        jsonl = os.path.join(str(tmp_dir), f"{tag}{i}-{rank}.jsonl")
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
               tmp_dir, model_cases=(), model_runs=()):
    """One group's whole share of a test module: :func:`ring_steps`,
    :func:`cli_runs`, with ``ppi_spec`` :func:`banked_dp` (and in a group
    of 2 :func:`fast_dp`), the error of a
    mesh one rank larger than the group, and the ranks' agreement on a
    capture that held everywhere and on one the last rank refused; then
    the same group as a mesh with a model axis (``(1, 2)`` on 2 ranks,
    ``(2, 2)`` on 4): :func:`model_axis_steps` of ``model_cases``, the CLI
    runs ``model_runs``, and with ``ppi_spec`` the banked loop (and in a
    group of 2 the stacked one) at that mesh (one spawn a module and group
    size)."""
    from pygat_tpu_torch.parallel.mesh import make_mesh
    from pygat_tpu_torch.train.loop import _agree_on_capture

    try:  # a mesh the group's size does not fit
        make_mesh(world + 1, 1, device="cpu")
        wrong_size = None
    except RuntimeError as exc:
        wrong_size = str(exc)
    out = dict(ring=ring_steps(rank, world, ring_spec, cases, steps),
               cli=cli_runs(rank, world, runs, tmp_dir),
               ppi=None if ppi_spec is None
               else banked_dp(rank, world, ppi_spec),
               ppi_fast=None if ppi_spec is None or world != 2
               else fast_dp(rank, world, ppi_spec),
               wrong_size=wrong_size,
               capture=[_agree_on_capture(None, "cpu"), _agree_on_capture(
                   "RuntimeError: refused" if rank == world - 1 else None,
                   "cpu")])
    mesh = (world // 2, 2)
    out["model"] = dict(
        steps=model_axis_steps(rank, world, ring_spec, model_cases, steps,
                               tmp_dir),
        cli=cli_runs(rank, world, model_runs, tmp_dir, "model-run"),
        ppi=None if ppi_spec is None
        else banked_dp(rank, world, ppi_spec, mesh),
        ppi_fast=None if ppi_spec is None or world != 2
        else fast_dp(rank, world, ppi_spec, mesh))
    return out


def _whole(mesh, tensors, flags):
    """The whole-model numpy arrays of this rank's ``tensors``: each split
    one gathered over the model group."""
    from pygat_tpu_torch.parallel import collectives as col

    return [(col.all_gather(t.detach(), mesh.model_group) if f
             else t.detach()).numpy().copy() for t, f in zip(tensors, flags)]


def model_axis_steps(rank, world, spec, cases, steps, tmp_dir):
    """Per case (layer type, halo) on the mesh ``(world // 2, 2)``: the
    sparse types over the ring, the dense ones by receiver rows, from the
    spec's ``mparams`` (``mcfg``, dropout off). Returns this rank's rows of
    the forward, its loss, the whole gradients and the whole parameters
    after one Adam step (split leaves gathered over the model group), its
    own leaves after ``steps`` steps and which are split; for the first
    case also a checkpoint written under the mesh (``save_state``) read
    back whole on one device and as this rank's share."""
    import torch
    import torch.distributed as dist

    from pygat_tpu_torch.models.gat import GATConfig, parameters
    from pygat_tpu_torch.parallel.distributed import (
        all_reduce_grads,
        restore_state,
        save_state,
        shard_train_state,
    )
    from pygat_tpu_torch.parallel.mesh import make_mesh
    from pygat_tpu_torch.parallel.ring_model import DenseRowsLoss, RingLoss
    from pygat_tpu_torch.train import checkpoint as ckpt
    from pygat_tpu_torch.train.logging import TrainLogger
    from pygat_tpu_torch.train.loop import _dense_setup, _ring_setup
    from pygat_tpu_torch.train.state import (
        init_state,
        leaf_split,
        make_optimizer,
        tensor_leaves,
    )

    mesh = make_mesh(world // 2, 2, device="cpu")
    ds = _dataset(spec)
    quiet = TrainLogger(stream=open(os.devnull, "w"))
    setups, got = {}, {}
    for i, (lt, halo) in enumerate(cases):
        cfg = GATConfig(layer_type=lt, **spec["mcfg"])
        if cfg.is_sparse not in setups:
            setup = _ring_setup if cfg.is_sparse else _dense_setup
            setups[cfg.is_sparse] = setup(cfg, ds, mesh, quiet)
        local, base = setups[cfg.is_sparse]
        loss_fn = (RingLoss(cfg, base.blocks, halo, mesh) if cfg.is_sparse
                   else DenseRowsLoss(cfg, base.neighborhood, mesh))
        whole = _params(cfg, spec["mparams"][lt])
        state = shard_train_state(init_state(
            whole, make_optimizer(whole, spec["lr"], spec["wd"]),
            torch.Generator()), mesh)
        flags = state.split
        rec = {"split": flags}
        for step in range(steps):
            state.optimizer.zero_grad(set_to_none=True)
            loss, _, out = loss_fn(state.params, local.features, None,
                                   local.labels, local.idx_train, None, True)
            loss.backward()
            all_reduce_grads(state.params, loss_fn.group)
            if step == 0:
                rec["out"] = out.detach().numpy()
                rec["loss"] = float(loss)
                rec["grads"] = _whole(mesh, [p.grad for p in
                                             parameters(state.params)], flags)
            state.optimizer.step()
            if step == 0:
                rec["params1"] = _whole(mesh, parameters(state.params), flags)
        rec["local_last"] = [p.detach().numpy().copy()
                             for p in parameters(state.params)]
        if i == 0:
            d = os.path.join(str(tmp_dir), f"model-ckpt-{world}")
            save_state(mesh, d, 0, "m", state)
            dist.barrier()
            path = ckpt.best_path(d, "m", 0)
            one = _params(cfg, spec["mparams"][lt])
            one_state = init_state(one, make_optimizer(one, 1.0, 0.0),
                                   torch.Generator())
            ckpt.restore(path, like=one_state)
            rec["ckpt_whole"] = [t.detach().numpy().copy()
                                 for t in tensor_leaves(one_state)]
            rec["ckpt_whole_want"] = _whole(
                mesh, tensor_leaves(state), leaf_split(state))
            fresh = _params(cfg, spec["mparams"][lt])
            mine = shard_train_state(init_state(
                fresh, make_optimizer(fresh, 1.0, 0.0), torch.Generator()),
                mesh)
            restore_state(path, mine)
            rec["ckpt_mine"] = all(
                torch.equal(a, b) for a, b in zip(tensor_leaves(mine),
                                                  tensor_leaves(state)))
        got[(lt, halo)] = rec
    quiet.stream.close()
    return got


def banked_dp(rank, world, spec, mesh_shape=None):
    """``fit_inductive_banked(mesh=)`` on the spec's tiny PPI data, over a
    mesh of ``mesh_shape`` (default ``(world, 1)``); returns the
    validation history, the best epoch and the final parameters (whole:
    split leaves gathered over the model group)."""
    from pygat_tpu_torch.data import ppi as tppi
    from pygat_tpu_torch.models.gat import GATConfig, parameters
    from pygat_tpu_torch.parallel.mesh import make_mesh
    from pygat_tpu_torch.train.inductive import fit_inductive_banked
    from pygat_tpu_torch.train.logging import TrainLogger
    from tests.torch_ppi_data import synth_ppi

    mesh = make_mesh(*(mesh_shape or (world, 1)), device="cpu")
    cfg = GATConfig(**spec["cfg"])
    with open(os.devnull, "w") as quiet:
        res = fit_inductive_banked(
            cfg, synth_ppi(tppi.PPIGraph, tppi.PPIData), mesh=mesh,
            init_params=_params(cfg, spec["params"]),
            logger=TrainLogger(stream=quiet), **spec["kw"])
    return dict(history=res.history, best_epoch=res.best_epoch,
                params=_final(mesh, res.state), test_loss=res.test_loss,
                local=[p.detach().numpy().copy()
                       for p in parameters(res.state.params)])


def _final(mesh, state):
    from pygat_tpu_torch.models.gat import parameters

    flags = state.split or [False] * len(parameters(state.params))
    return _whole(mesh, parameters(state.params), flags)


def fast_dp(rank, world, spec, mesh_shape=None):
    """``fit_inductive_fast(mesh=)`` on the spec's tiny PPI data for the
    epochs of ``spec["fast_kw"]``, over a mesh of ``mesh_shape`` (default
    ``(world, 1)``); returns the validation history, the best epoch, the
    test loss and the final parameters (whole)."""
    from pygat_tpu_torch.data import ppi as tppi
    from pygat_tpu_torch.models.gat import GATConfig, parameters
    from pygat_tpu_torch.parallel.mesh import make_mesh
    from pygat_tpu_torch.train.inductive import fit_inductive_fast
    from pygat_tpu_torch.train.logging import TrainLogger
    from tests.torch_ppi_data import synth_ppi

    mesh = make_mesh(*(mesh_shape or (world, 1)), device="cpu")
    cfg = GATConfig(**spec["cfg"])
    with open(os.devnull, "w") as quiet:
        res = fit_inductive_fast(
            cfg, synth_ppi(tppi.PPIGraph, tppi.PPIData), mesh=mesh,
            init_params=_params(cfg, spec["params"]),
            logger=TrainLogger(stream=quiet), **spec["fast_kw"])
    return dict(history=res.history, best_epoch=res.best_epoch,
                params=_final(mesh, res.state), test_loss=res.test_loss,
                test_acc=res.test_acc,
                local=[p.detach().numpy().copy()
                       for p in parameters(res.state.params)])
