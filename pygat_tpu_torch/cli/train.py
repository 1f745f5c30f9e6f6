"""Transductive trainer CLI (port of ``pygat_tpu/cli/train.py``).

Same flags as the JAX package's CLI (reference train.py:31-45 plus the
package's own), running on CUDA unless ``--no-cuda`` asks for the CPU:

    python -m pygat_tpu_torch.cli.train --dataset cora --model GAT_sparse
    python -m pygat_tpu_torch.cli.train --dataset pubmed --model GATv2_sparse \\
        --epoch-chunk 50

On D * M ranks (one process a card, brought up by a launcher), the ring
over D node shards, each layer's heads split over M model ranks where they
divide:

    torchrun --nproc-per-node D -m pygat_tpu_torch.cli.train --dataset cora \
        --model GAT_sparse --mesh D,1 --partition ring
    torchrun --nproc-per-node 4 -m pygat_tpu_torch.cli.train --dataset cora \
        --model GATv2_sparse --mesh 2,2
    torchrun --nproc-per-node 4 -m pygat_tpu_torch.cli.train --no-cuda \
        --model GAT --mesh 2,2    # on the CPU, a gloo group

``--epoch-chunk K`` with K > 1 runs ``fit_transductive_fast``: K epochs per
host sync, on CUDA as replays of one captured CUDA graph. As in the JAX
package, the large-N banded path has no flag: the trainers take it past
300k padded nodes, or when the environment asks (``PYGAT_BAND=on``; also
``PYGAT_BAND_N``, ``PYGAT_BAND_W``, ``PYGAT_BAND_MIN_FILL``). ``--corner
on`` (or ``PYGAT_CORNER=on``) runs the fused layers over the corner plans
where no band plan is taken. ``--model GAT`` / ``GATv2`` run the dense
layers; ``--backend`` picks the segment impl for the run (``xla``: the
``index_add_`` sums and the unfused sparse branch). On CUDA the last line
counts the kernel launches made through their wrappers.

``--mesh D,M`` trains over a process group of ``D * M`` ranks, brought up
from the launcher's environment (``torchrun``: NCCL on CUDA, gloo with
``--no-cuda``); without one, or with another size, it raises.
``--distributed`` asks for the group explicitly (a mesh of every rank
when ``--mesh`` is absent). Each data rank holds one node shard; the
sparse types run the ring attention over the data group
(``PYGAT_RING_HALO=1``: the direct halo exchange), the dense types the
attention of the shard's receiver rows against every sender, whose
projections are gathered over the data group. ``--partition gspmd``, the
default, runs the same (torch has no GSPMD) and says so; ``--partition
ring`` without a mesh raises. With ``M > 1`` each rank holds, updates and
computes its heads of every layer whose head count divides by M (one line
says which parameters are split), and the heads are combined over the
model group. Rank 0 alone prints the epochs and writes the checkpoints,
in the one-device format.

``--reorder`` relabels the citation graph in reverse Cuthill-McKee order
(the port's host library, ``pygat_tpu_torch/native.py``) before the
padded graph and its walks are built, with every loop and order above;
under a mesh the ring interleaves the reordered nodes over the shards:

    python -m pygat_tpu_torch.cli.train --dataset pubmed \
        --model GATv2_sparse --reorder --epoch-chunk 5
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time

import numpy as np
import torch.distributed as dist


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="pygat_tpu_torch transductive trainer")
    p.add_argument("--no-cuda", action="store_true", default=False,
                   help="run on the CPU (the default device is CUDA; without "
                        "a GPU and without this flag the trainer raises)")
    p.add_argument("--fastmode", action="store_true", default=False,
                   help="Validate during training pass.")
    p.add_argument("--dataset", type=str, default="cora",
                   choices=["cora", "pubmed", "citeseer"])
    p.add_argument("--model", type=str, default="GAT_sparse",
                   choices=["GAT_sparse", "GAT", "GATv2", "GATv2_sparse"],
                   help="GAT_sparse / GATv2_sparse: edge-list attention; "
                        "GAT / GATv2: dense [N, N] attention")
    p.add_argument("--seed", type=int, default=72)
    p.add_argument("--epochs", type=int, default=10000)
    p.add_argument("--patience", type=int, default=100)
    p.add_argument("--backend", type=str, default=None,
                   choices=["stream", "xla"],
                   help="the segment impl: stream = the stream segment "
                        "sums and (PYGAT_FUSED_ATTENTION auto) the fused "
                        "attention; xla = index_add_ sums, the unfused "
                        "branch; default: PYGAT_SEGMENT_IMPL, else auto "
                        "(as stream)")
    p.add_argument("--corner", type=str, default=None,
                   choices=["auto", "on", "off"],
                   help="gather-free window build for million-node graphs "
                        "(CSC expand + corner-turn instead of a row gather by "
                        "edge index); auto = on at or above PYGAT_CORNER_N "
                        "padded nodes (by default never)")
    p.add_argument("--platform", type=str, default=None,
                   help="the JAX package's platform switch; the port rejects "
                        "it (its one device switch is --no-cuda)")
    p.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    p.add_argument("--no-checkpoint", action="store_true", default=False)
    p.add_argument("--jsonl", type=str, default=None, help="JSONL metrics path")
    p.add_argument("--log-every", type=int, default=1)
    p.add_argument("--data-root", type=str, default=None)
    p.add_argument("--resume", dest="resume_training", action="store_true",
                   default=False,
                   help="continue from the newest checkpoint in "
                        "--checkpoint-dir (parameters, Adam moments, "
                        "generator state, best-val bookkeeping)")
    p.add_argument("--reorder", action="store_true", default=False,
                   help="RCM node relabeling (isomorphic; packs each "
                        "receiver's senders near it in id order)")
    p.add_argument("--mesh", type=str, default=None, metavar="D,M",
                   help="train over a process group of D*M ranks (from "
                        "torchrun's environment): D node shards, each "
                        "layer's heads split over M model ranks")
    p.add_argument("--partition", type=str, default="gspmd",
                   choices=["gspmd", "ring"],
                   help="with --mesh: ring = the ring exchange of node "
                        "shards; gspmd runs the ring too (torch has no "
                        "GSPMD)")
    p.add_argument("--epoch-chunk", type=int, default=1,
                   help=">1: fit_transductive_fast, this many epochs per "
                        "host sync (a replayed CUDA graph on the GPU); "
                        "early stop may overshoot by up to K-1 epochs")
    p.add_argument("--distributed", action="store_true", default=False,
                   help="bring up the process group from the launcher's "
                        "environment (torchrun); raises without one")
    return p


# --backend -> segment impl, the JAX CLI's mapping (xla = the scatter
# lowering); main() scopes it to the run
BACKEND_IMPLS = {"stream": "stream", "xla": "scatter"}


def _reject_unported(args) -> None:
    if args.platform is not None:
        raise SystemExit("--platform picks a JAX platform and has no "
                         "counterpart in the port: it runs on CUDA, or on the "
                         "CPU with --no-cuda")
    if (args.partition != "gspmd" and args.mesh is None
            and not args.distributed):
        raise SystemExit(f"--partition {args.partition} partitions a mesh: "
                         "it needs --mesh D,M (or --distributed)")


def parse_mesh(text: str) -> tuple[int, int]:
    """``"D,M"`` -> (D, M)."""
    try:
        n_data, n_model = (int(v) for v in text.split(","))
    except ValueError:
        raise SystemExit(f"--mesh takes D,M, got {text!r}") from None
    return n_data, n_model


def bring_up_mesh(args):
    """(mesh, whether this call brought the group up) for ``--mesh`` /
    ``--distributed``, or (None, False) without either: the process group
    from the launcher's environment (NCCL, or gloo with ``--no-cuda``),
    which must hold D * M ranks."""
    from pygat_tpu_torch.parallel.mesh import (
        initialize_distributed,
        local_device,
        make_mesh,
    )

    if args.mesh is None and not args.distributed:
        return None, False
    already = dist.is_initialized()
    if not initialize_distributed(cpu=args.no_cuda):
        raise SystemExit(
            f"{'--mesh' if args.mesh else '--distributed'} needs a process "
            "group: launch with torchrun --nproc-per-node D (RANK, "
            "WORLD_SIZE, MASTER_ADDR and MASTER_PORT are not set)")
    n_data, n_model = (parse_mesh(args.mesh) if args.mesh
                       else (dist.get_world_size(), 1))
    try:
        mesh = make_mesh(n_data, n_model,
                         device=local_device(cpu=args.no_cuda))
    except RuntimeError as exc:
        if not already:
            dist.destroy_process_group()
        raise SystemExit(str(exc)) from None
    return mesh, not already


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _reject_unported(args)

    from pygat_tpu_torch.ops.segment import use_impl

    with use_impl(BACKEND_IMPLS.get(args.backend)):
        return _train(args)


def _train(args) -> int:
    mesh, owns_group = bring_up_mesh(args)
    try:
        return _fit(args, mesh)
    finally:
        if owns_group:
            dist.destroy_process_group()


def _fit(args, mesh) -> int:
    from pygat_tpu_torch.data.citation import dataset_stats, load_citation
    from pygat_tpu_torch.models.gat import GATConfig
    from pygat_tpu_torch.models.presets import PRESETS, TRAIN_PRESETS
    from pygat_tpu_torch.ops import build
    from pygat_tpu_torch.train.logging import TrainLogger
    from pygat_tpu_torch.train.loop import (
        fit_transductive,
        fit_transductive_fast,
    )
    from pygat_tpu_torch.utils.platform import resolve_device

    device = mesh.device if mesh else resolve_device(cpu=args.no_cuda)
    main_rank = mesh is None or mesh.is_main
    if args.corner:
        from pygat_tpu_torch.ops.large import set_corner

        set_corner(args.corner)
    random.seed(args.seed)
    np.random.seed(args.seed)

    data = load_citation(args.dataset, data_root=args.data_root,
                         reorder=args.reorder, device=device)
    stats = dataset_stats(data)
    print(f"Number of nodes: {stats['nodes']}")
    print(f"Number of edges: {stats['edges']}")
    print(f"Number of input features: {stats['input_features']}")
    print(f"Number of classes: {stats['classes']}")
    print(f"Number of training nodes: {stats['train_nodes']}")
    print(f"Number of validation nodes: {stats['val_nodes']}")
    print(f"Number of test nodes: {stats['test_nodes']}")
    if stats["synthetic_parts"]:
        print(f"WARNING: synthetic stand-ins for: {stats['synthetic_parts']}")

    cfg = GATConfig(layer_type=args.model, **PRESETS[args.dataset])
    # first-layer width follows the padded feature matrix (padding columns
    # are zero)
    cfg = cfg._replace(nfeats=(int(data.features.shape[1]),) + cfg.nfeats[1:])
    tp = TRAIN_PRESETS[args.dataset]
    # rank 0 alone prints the epochs and writes the metrics
    logger = (TrainLogger(jsonl_path=args.jsonl) if main_rank
              else TrainLogger(stream=open(os.devnull, "w")))
    if mesh is not None:
        print(f"mesh: data={mesh.n_data} model={mesh.n_model} "
              f"partition={args.partition} rank={mesh.rank}")
        if args.partition == "gspmd" and main_rank:
            print("--partition gspmd runs the ring (the dense types: receiver "
                  "rows): torch has no GSPMD, and the JAX package's two "
                  "mechanisms compute the same thing")

    print(f"start training on {device}")
    t0 = time.time()
    fit_kw = dict(
        lr=tp["lr"],
        weight_decay=tp["weight_decay"],
        epochs=args.epochs,
        patience=args.patience,
        seed=args.seed,
        fastmode=args.fastmode,
        checkpoint_dir=None if args.no_checkpoint else args.checkpoint_dir,
        dataset_tag=args.dataset,
        logger=logger,
        log_every=args.log_every,
        resume=args.resume_training,
        mesh=mesh,
    )
    if args.epoch_chunk > 1:
        result = fit_transductive_fast(cfg, data,
                                       epoch_chunk=args.epoch_chunk, **fit_kw)
        if result.graph_replays:
            print(f"CUDA graph replays: {result.graph_replays}, each "
                  f"launching {json.dumps(result.captured_launches)}")
    else:
        result = fit_transductive(cfg, data, **fit_kw)
    print("Optimization Finished!")
    print("Total time elapsed: {:.4f}s".format(time.time() - t0))
    print("Loading {}th epoch".format(result.best_epoch))
    if device.type == "cuda":
        print(f"Kernel launches: {json.dumps(build.launch_counts())}")
    logger.close()
    if not main_rank:
        logger.stream.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
