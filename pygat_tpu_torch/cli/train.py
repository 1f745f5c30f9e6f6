"""Transductive trainer CLI (port of ``pygat_tpu/cli/train.py``).

Same flags as the JAX package's CLI (reference train.py:31-45 plus the
package's own), running on CUDA unless ``--no-cuda`` asks for the CPU:

    python -m pygat_tpu_torch.cli.train --dataset cora --model GAT_sparse
    python -m pygat_tpu_torch.cli.train --dataset pubmed --model GATv2_sparse \\
        --epoch-chunk 50

``--epoch-chunk K`` with K > 1 runs ``fit_transductive_fast``: K epochs per
host sync, on CUDA as replays of one captured CUDA graph. As in the JAX
package, the large-N banded path has no flag: the trainers take it past
300k padded nodes, or when the environment asks (``PYGAT_BAND=on``; also
``PYGAT_BAND_N``, ``PYGAT_BAND_W``, ``PYGAT_BAND_MIN_FILL``). ``--corner
on`` (or ``PYGAT_CORNER=on``) runs the fused layers over the corner plans
where no band plan is taken. On CUDA the last line counts the kernel
launches made through their wrappers. Flags whose machinery is not ported
yet (``--mesh``, ``--partition``, ``--reorder``, ``--distributed``,
``--backend xla``, the dense models ``GAT`` / ``GATv2``) raise an error
naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import argparse
import json
import random
import time

import numpy as np


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
                   help="GAT_sparse and GATv2_sparse are ported; the dense "
                        "models are not yet")
    p.add_argument("--seed", type=int, default=72)
    p.add_argument("--epochs", type=int, default=10000)
    p.add_argument("--patience", type=int, default=100)
    p.add_argument("--backend", type=str, default=None,
                   choices=["stream", "xla"],
                   help="stream = fused attention + stream segment sums "
                        "(the port's path); xla = the unfused path, not "
                        "ported yet")
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
                   help="RCM node relabeling (not ported yet)")
    p.add_argument("--mesh", type=str, default=None, metavar="D,M",
                   help="multi-device data,model mesh (not ported yet)")
    p.add_argument("--partition", type=str, default="gspmd",
                   choices=["gspmd", "ring"],
                   help="with --mesh: partitioning mechanism (not ported yet)")
    p.add_argument("--epoch-chunk", type=int, default=1,
                   help=">1: fit_transductive_fast, this many epochs per "
                        "host sync (a replayed CUDA graph on the GPU); "
                        "early stop may overshoot by up to K-1 epochs")
    p.add_argument("--distributed", action="store_true", default=False,
                   help="multi-process initialization (not ported yet)")
    return p


def _reject_unported(args) -> None:
    if args.platform is not None:
        raise SystemExit("--platform picks a JAX platform and has no "
                         "counterpart in the port: it runs on CUDA, or on the "
                         "CPU with --no-cuda")
    unported = [
        (args.mesh is not None or args.partition != "gspmd",
         "--mesh/--partition", "Queue 1, item 14: multi-GPU"),
        (args.distributed, "--distributed", "Queue 1, item 14: multi-GPU"),
        (args.reorder, "--reorder",
         "Queue 1, item 15: ctypes loader for csrc/graphops.cpp"),
        (args.model in ("GAT", "GATv2"), f"--model {args.model}",
         "Queue 1, item 10: the dense layers"),
        (args.backend == "xla", "--backend xla",
         "Queue 1, item 10: unfused layer branches"),
    ]
    for bad, flag, item in unported:
        if bad:
            raise SystemExit(f"{flag} is not ported yet (ROADMAP {item})")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _reject_unported(args)

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

    device = resolve_device(cpu=args.no_cuda)
    if args.corner:
        from pygat_tpu_torch.ops.large import set_corner

        set_corner(args.corner)
    random.seed(args.seed)
    np.random.seed(args.seed)

    data = load_citation(args.dataset, data_root=args.data_root, device=device)
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
    logger = TrainLogger(jsonl_path=args.jsonl)

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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
