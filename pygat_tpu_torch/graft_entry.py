"""The port's entry file (port of ``__graft_entry__.py``).

* :func:`entry` returns ``(fn, example_args)``: the flagship model's eval
  forward (the Cora-preset ``GAT_sparse``) on a 2,708-node, 1,536-feature
  synthetic citation graph, on CUDA unless the caller asks for the CPU.
* :func:`dryrun_multichip` runs, inside a process group of n ranks, the
  steps of its JAX counterpart (``__graft_entry__.py:80-279``) over a
  ``(data, model)`` mesh with a model axis of 2 at even n >= 4, at its
  tiny sizes, and prints a line for each.

    python -m pygat_tpu_torch.graft_entry [--no-cuda]
    torchrun --nproc-per-node 4 -m pygat_tpu_torch.graft_entry dryrun 4 \
        [--no-cuda]
"""

from __future__ import annotations

import torch


def entry(device=None):
    """(fn, (params, x, graph)): ``fn(params, x, graph)`` is the eval
    forward (no dropout) of the Cora-preset GAT_sparse at 1,536 input
    features, and the example arguments its parameters (seeded with 72), the
    features and the graph of the JAX entry's planted-partition citation
    graph (``data.synthetic.clustered_citation(spread=None)``), on ``device``
    (CUDA unless the caller names another device; raises without CUDA)."""
    from pygat_tpu_torch.data.synthetic import clustered_citation
    from pygat_tpu_torch.models.gat import GATConfig, apply_gat, init_gat
    from pygat_tpu_torch.models.presets import PRESETS
    from pygat_tpu_torch.utils.platform import make_generator, resolve_device

    device = resolve_device(device)
    data = clustered_citation(2708, 1536, 7, "graft-entry", None,
                              device=device)
    cfg = GATConfig(layer_type="GAT_sparse", **PRESETS["cora"])
    cfg = cfg._replace(nfeats=(1536,) + cfg.nfeats[1:])
    params = init_gat(cfg, make_generator("cpu", 72), device=device)

    def fn(params, x, graph):
        return apply_gat(params, cfg, x, graph, None, train=False)

    return fn, (params, data.features, data.graph)


def _tiny_ppi():
    """The JAX dryrun's inductive problem: 8 train graphs of 40 nodes, one
    validation graph of 35 and one test graph of 30, 16 features, 6
    labels, planted-partition topology, normalized adjacency."""
    import numpy as np
    import scipy.sparse as sp

    from pygat_tpu_torch.data.ppi import PPIData, PPIGraph
    from pygat_tpu_torch.data.preprocess import normalize_adj
    from pygat_tpu_torch.data.synthetic import planted_partition_graph

    rng = np.random.default_rng(0)
    proj = rng.standard_normal((16, 6)).astype(np.float32)

    def mk(n, name):
        s, r, _ = planted_partition_graph(n, 3, name, avg_degree=6)
        adj = sp.coo_matrix((np.ones(len(s), np.float32), (r, s)),
                            shape=(n, n)).tocsr()
        adj.data[:] = 1.0
        adj = normalize_adj(adj + sp.eye(n, format="csr",
                                         dtype=np.float32)).tocoo()
        feats = rng.standard_normal((n, 16)).astype(np.float32)
        return PPIGraph(feats, (feats @ proj > 0.5).astype(np.float32),
                        adj.col.astype(np.int64), adj.row.astype(np.int64),
                        adj.data.astype(np.float32), n)

    return PPIData(train=[mk(40, f"t{i}") for i in range(8)],
                   valid=[mk(35, "v0")], test=[mk(30, "x0")],
                   synthetic_parts=("all",))


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One training step of each of the JAX entry's distributed paths over
    an ``n_devices`` mesh of ``(n_devices // M, M)`` ranks, ``M = 2`` at
    even ``n_devices >= 4`` (heads over a model group), else 1, at its tiny
    sizes; rank 0 prints a line for each. Every rank of a process group of
    ``n_devices`` ranks calls it (raises without one, as ``make_mesh``
    does); ``device``: the rank's (default ``cuda:LOCAL_RANK``). The
    paths: the "GSPMD" train and eval step (torch has no GSPMD: the ring
    runs the sparse types) and a 3-epoch fast loop of it; the ring of
    GATv1 and GATv2; the ring over the stream kernels on a 128·D-padded
    graph, and with the halo exchange; the stacked inductive loop and the
    banked one, data-parallel. Raises if a loss is not finite."""
    import math
    import os

    import torch.distributed as dist

    from pygat_tpu_torch.data.synthetic import clustered_citation
    from pygat_tpu_torch.models.gat import GATConfig, init_gat
    from pygat_tpu_torch.ops.segment import use_impl
    from pygat_tpu_torch.parallel.mesh import make_mesh
    from pygat_tpu_torch.train.inductive import (
        fit_inductive_banked,
        fit_inductive_fast,
    )
    from pygat_tpu_torch.train.logging import TrainLogger
    from pygat_tpu_torch.train.loop import (
        ChunkedEpochs,
        _dropout_generator,
        _enter_mesh,
        make_transductive_steps,
    )
    from pygat_tpu_torch.train.state import init_state, make_optimizer
    from pygat_tpu_torch.utils.platform import make_generator

    if not dist.is_initialized():
        raise RuntimeError(
            f"dryrun_multichip({n_devices}) runs inside a process group of "
            f"{n_devices} ranks: launch with torchrun --nproc-per-node "
            f"{n_devices} -m pygat_tpu_torch.graft_entry dryrun {n_devices}")
    n_model = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    mesh = make_mesh(n_devices // n_model, n_model, device=device)
    dev = mesh.device
    quiet = TrainLogger(stream=open(os.devnull, "w"))
    shape = {"data": mesh.n_data, "model": mesh.n_model}

    def say(what, **numbers):
        for k, v in numbers.items():
            if not math.isfinite(v):
                raise AssertionError(f"dryrun_multichip [{what}]: {k} {v}")
        if mesh.is_main:
            print(f"dryrun_multichip OK [{what}]: mesh={shape} "
                  + " ".join(f"{k}={v:.4f}" for k, v in numbers.items()),
                  flush=True)

    def ring_step(cfg, data, halo=None):
        params = init_gat(cfg, make_generator("cpu", 72), device=dev)
        state = init_state(params, make_optimizer(params, 0.005, 5e-4),
                           _dropout_generator(dev, 72, mesh))
        local, loss_fn, state = _enter_mesh(cfg, data, state, mesh, quiet)
        if halo is not None:
            loss_fn.halo = halo
        train_step, eval_step = make_transductive_steps(cfg, ring=loss_fn)
        state, loss, _, _ = train_step(state, local.features, local.graph,
                                       local.labels, local.idx_train)
        loss_v, _, _ = eval_step(state.params, local.features, local.graph,
                                 local.labels, local.idx_val)
        return state, local, loss_fn, float(loss), float(loss_v)

    try:
        data = clustered_citation(300, 128, 4, "graft-dryrun", None,
                                  device=dev)
        cfg = GATConfig(nlayers=2, nheads=(4, 2), nfeats=(128, 8, 4),
                        dropout=0.6, alpha=0.2, layer_type="GAT_sparse")
        state, local, loss_fn, loss, loss_v = ring_step(cfg, data)
        say("gspmd step, the ring", loss=loss, val_loss=loss_v)

        chunk = ChunkedEpochs(cfg, state, local.features, local.graph,
                              local.labels, local.idx_train, local.idx_val,
                              n_epochs=3, max_epochs=3, ring=loss_fn)
        chunk.run()
        say("chunked fast loop, 3 epochs", best_val=float(chunk.best_val))

        for lt in ("GAT_sparse", "GATv2_sparse"):
            *_, loss, _ = ring_step(cfg._replace(layer_type=lt), data)
            say(f"ring {lt}", loss=loss)

        unit = 128 * mesh.n_data  # whole 128-row tiles a shard
        data2 = clustered_citation(300, 128, 4, "graft-dryrun-stream", None,
                                   n_pad=-(-301 // unit) * unit, device=dev)
        with use_impl("stream"):
            *_, loss, _ = ring_step(cfg, data2)
            say("ring+stream GAT_sparse", loss=loss)
            _, _, loss_fn, loss, _ = ring_step(cfg, data2, halo=True)
            say(f"ring+halo GAT_sparse (h_rows={loss_fn.blocks.h_rows})",
                loss=loss)

        pdata = _tiny_ppi()
        icfg = GATConfig(nlayers=2, nheads=(4, 2), nfeats=(128, 8, 6),
                         dropout=0.0, alpha=0.2, layer_type="GAT_sparse",
                         skip_connection=True)
        kw = dict(batch_size=2, lr=0.005, weight_decay=5e-4, epochs=1,
                  patience=10, seed=7, logger=quiet, mesh=mesh)
        res = fit_inductive_fast(icfg, pdata, **kw)
        say("inductive DP, stacked loop", val_loss=res.history[-1])
        res = fit_inductive_banked(icfg, pdata, epoch_chunk=1, **kw)
        say("banked DP", val_loss=res.history[-1])
    finally:
        quiet.stream.close()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description="the flagship forward, once; "
                                "or 'dryrun N' under torchrun")
    p.add_argument("what", nargs="*", help="dryrun N")
    p.add_argument("--no-cuda", action="store_true", default=False)
    args = p.parse_args(argv)
    if args.what:
        return _dryrun_main(args)
    fn, example = entry("cpu" if args.no_cuda else None)
    with torch.no_grad():
        out = fn(*example)
    if out.is_cuda:
        torch.cuda.synchronize()
    print("entry OK:", tuple(out.shape), out.dtype,
          bool(torch.isfinite(out).all()))
    return 0


def _dryrun_main(args) -> int:
    import torch.distributed as dist

    from pygat_tpu_torch.parallel.mesh import initialize_distributed, local_device

    if args.what[0] != "dryrun" or len(args.what) > 2:
        raise SystemExit(f"unknown arguments {args.what}: dryrun [N]")
    n = int(args.what[1]) if len(args.what) > 1 else 8
    owns = not dist.is_initialized()
    if not initialize_distributed(cpu=args.no_cuda):
        raise SystemExit(f"dryrun {n} runs under torchrun --nproc-per-node "
                         f"{n}: no launcher environment")
    try:
        dryrun_multichip(n, device=local_device(cpu=args.no_cuda))
    finally:
        if owns:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
