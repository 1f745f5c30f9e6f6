"""Check and time the ring on a process group (one process a rank):

    torchrun --nproc-per-node D -m pygat_tpu_torch.tools.ring_check
    torchrun --nproc-per-node 4 -m pygat_tpu_torch.tools.ring_check --mesh 2,2
    torchrun --nproc-per-node D -m pygat_tpu_torch.tools.ring_check --no-cuda

On a citation preset (Cora by default), over a ``(D, M)`` mesh (``--mesh``;
default every rank on the data axis), every rank runs its shard of the
ring with its heads of each split layer, and with a model axis the dense
models by receiver rows too; rank 0 holds the forward and the all-reduced
gradients (dropout off; the sparse models by the rotation and the halo
exchange; split leaves gathered over the model group) against the
single-device model on the same interleaved graph, then times the epoch
of each model by the per-epoch loop (median of ``--timed`` synchronized
epochs) and by the fast loop (median of 5 chunks of 10, one captured CUDA
graph an epoch unless the collectives refuse the capture), on the mesh
and, on rank 0 alone, on one device. Rank 0 prints one JSON line; every
rank fails if a check does.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
import torch.distributed as dist
import torch.nn.functional as F

MODEL_RTOL = 1e-4  # two f32 computations summing in other orders


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check(cfg, ds, il, mesh, local, ring):
    """The worst error of the mesh's output and gradients against the one
    device's, in units of MODEL_RTOL of each quantity's largest value
    (rank 0's number; the others return 0)."""
    from pygat_tpu_torch.models.gat import apply_gat, init_gat, parameters
    from pygat_tpu_torch.parallel import collectives as col
    from pygat_tpu_torch.parallel.distributed import all_reduce_grads
    from pygat_tpu_torch.parallel.sharding import head_slice, split_leaf
    from pygat_tpu_torch.utils.platform import make_generator

    whole = init_gat(cfg, make_generator("cpu", 72), device=mesh.device)
    flags = [split_leaf(p.shape, mesh.n_model) for p in parameters(whole)]
    params = [type(lp)(*(None if t is None else
                         t.detach().clone().requires_grad_() for t in lp))
              for lp in head_slice(whole, mesh.model_index, mesh.n_model)]
    loss, _, out = ring(params, local.features, None, local.labels,
                        local.idx_train, None, True)
    loss.backward()
    all_reduce_grads(params, ring.group)
    out = col.all_gather(out.detach(), ring.group)
    grads = [col.all_gather(p.grad, mesh.model_group) if f else p.grad
             for p, f in zip(parameters(params), flags)]
    if mesh.rank:
        return 0.0
    ref = init_gat(cfg, make_generator("cpu", 72), device=mesh.device)
    out_s = apply_gat(ref, cfg, il.features, il.graph, None, train=True)
    idx = il.idx_train.long()
    lp = F.log_softmax(F.elu(out_s), dim=1)
    F.nll_loss(lp[idx], il.labels[idx].long()).backward()
    mask = il.graph.node_mask
    worst = 0.0
    for got, want in zip([out[mask], *grads],
                         [out_s.detach()[mask],
                          *(p.grad for p in parameters(ref))]):
        scale = MODEL_RTOL * max(1.0, float(want.abs().max()))
        worst = max(worst, float((got - want).abs().max()) / scale)
    return worst


def _epoch_ms(cfg, data, ring, timed, device):
    """(per-epoch loop ms, fast loop ms, whether the fast loop replayed a
    captured graph, the capture's error)."""
    from pygat_tpu_torch.tools.profile_epoch import epoch_runners

    epoch, chunk = epoch_runners(cfg, data, 10, ring=ring)
    for _ in range(3):
        epoch()
    _sync(device)
    samples = []
    for _ in range(timed):
        t0 = time.perf_counter()
        epoch()
        _sync(device)
        samples.append((time.perf_counter() - t0) * 1e3)
    chunk.run()
    fast = []
    for _ in range(5):
        t0 = time.perf_counter()
        chunk.run()
        _sync(device)
        fast.append((time.perf_counter() - t0) * 1e3 / chunk.n_epochs)
    return (sorted(samples)[timed // 2], sorted(fast)[2],
            chunk.graph_replays > 0, chunk.capture_error)


def main(argv=None) -> int:
    from pygat_tpu_torch.data.citation import interleave_citation, load_citation
    from pygat_tpu_torch.models.gat import GATConfig
    from pygat_tpu_torch.models.presets import PRESETS
    from pygat_tpu_torch.parallel.mesh import (
        initialize_distributed,
        local_device,
        make_mesh,
    )
    from pygat_tpu_torch.parallel.ring_model import DenseRowsLoss, RingLoss
    from pygat_tpu_torch.train.logging import TrainLogger
    from pygat_tpu_torch.train.loop import _dense_setup, _ring_setup

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--no-cuda", action="store_true")
    p.add_argument("--dataset", default="cora",
                   choices=["cora", "citeseer", "pubmed"])
    p.add_argument("--timed", type=int, default=20,
                   help="epochs timed by the per-epoch loop (0: the checks "
                        "alone, no timing)")
    p.add_argument("--mesh", default=None, metavar="D,M",
                   help="the (data, model) mesh (default: every rank on "
                        "the data axis); M > 1 adds the dense models")
    args = p.parse_args(argv)
    if not initialize_distributed(cpu=args.no_cuda):
        raise SystemExit("run under torchrun: no launcher environment")
    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        shape = ((dist.get_world_size(), 1) if args.mesh is None
                 else tuple(int(v) for v in args.mesh.split(",")))
        mesh = make_mesh(*shape, device=local_device(cpu=args.no_cuda))
        ds = load_citation(args.dataset, device=mesh.device)
        report = {"world": mesh.world_size, "mesh": list(shape),
                  "device": str(mesh.device), "checks": {}, "epoch_ms": {}}
        if mesh.device.type == "cuda":
            report["card"] = torch.cuda.get_device_name(mesh.device)
        model = mesh if mesh.n_model > 1 else None
        types = ("GAT_sparse", "GATv2_sparse") + (
            ("GAT", "GATv2") if model is not None else ())
        with open(os.devnull, "w") as quiet:
            for lt in types:
                cfg = GATConfig(layer_type=lt, **PRESETS[args.dataset])
                cfg = cfg._replace(nfeats=(int(ds.features.shape[1]),)
                                   + cfg.nfeats[1:])
                setup = _ring_setup if cfg.is_sparse else _dense_setup
                local, ring = setup(cfg, ds, mesh, TrainLogger(stream=quiet))
                il = interleave_citation(ds, mesh.n_data,
                                         n_pad=local.features.shape[0]
                                         * mesh.n_data)

                def loss_of(c, halo):
                    if c.is_sparse:
                        return RingLoss(c, ring.blocks, halo, model)
                    return DenseRowsLoss(c, ring.neighborhood, mesh)

                for halo in ((False, True) if cfg.is_sparse else (None,)):
                    name = lt if halo is None else (
                        f"{lt} {'halo' if halo else 'rotation'}")
                    report["checks"][name] = _check(
                        cfg._replace(dropout=0.0), ds, il, mesh, local,
                        loss_of(cfg._replace(dropout=0.0), halo))
                    if not args.timed:
                        continue
                    per, fast, captured, err = _epoch_ms(
                        cfg, local, loss_of(cfg, halo), args.timed,
                        mesh.device)
                    where = "ring" if cfg.is_sparse else "rows"
                    report["epoch_ms"][f"{where} {name}"] = dict(
                        per_epoch=per, fast=fast, captured=captured,
                        capture_error=err)
                dist.barrier()
                if mesh.rank == 0 and args.timed:
                    per, fast, captured, err = _epoch_ms(
                        cfg, ds, None, args.timed, mesh.device)
                    report["epoch_ms"][f"one device {lt}"] = dict(
                        per_epoch=per, fast=fast, captured=captured,
                        capture_error=err)
                dist.barrier()
        if mesh.rank == 0:
            print(json.dumps(report), flush=True)
            worst = max(report["checks"].values())
            if worst > 1.0:
                raise SystemExit(f"the mesh disagrees with one device: "
                                 f"{worst:.3f} of MODEL_RTOL")
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
