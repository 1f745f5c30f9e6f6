"""Inductive PPI trainer CLI (port of ``pygat_tpu/cli/train_ppi.py``).

Same flags and defaults as the JAX package's CLI (reference
train_ppi.py:26-39, config train_ppi.py:43-55), running on CUDA unless
``--no-cuda`` asks for the CPU:

    python -m pygat_tpu_torch.cli.train_ppi
    python -m pygat_tpu_torch.cli.train_ppi --model GATv2_sparse --epoch-scan

The PPI preset: 3 layers of 4, 4 and 6 heads, 50 (padded to 128) -> 256 ->
256 -> 121 features, skip connections, no dropout, lr 0.005, batch size 2.
Without ``--epoch-scan`` it trains by the per-batch loop
(``fit_inductive``), with it by the banked loop (``fit_inductive_banked``:
every graph on the device once, a chunk of epochs per host sync).
``--fastmode`` is accepted and has no effect, as in the JAX package. On
CUDA the last line counts the kernel launches made through their
wrappers. The default ``--model GAT`` is the dense layer, as in the JAX
CLI. ``--backend`` picks the segment impl for the run (``xla``: the
``index_add_`` sums and the unfused sparse branch). ``--platform`` has no
counterpart in the port.

With ``--epoch-scan``, ``--mesh D,M`` trains the banked loop data-parallel
over a process group of ``D * M`` ranks from the launcher's environment
(one batch a rank a step, the gradients all-reduced; NCCL on CUDA, gloo
with ``--no-cuda``), as in the JAX CLI; ``--distributed`` asks for the
group explicitly:

    torchrun --nproc-per-node D -m pygat_tpu_torch.cli.train_ppi \
        --model GATv2_sparse --epoch-scan --mesh D,1

With ``M > 1`` each rank holds, updates and computes its heads of every
layer whose head count divides by M (the preset's 6-head output layer
stays whole at M = 4; one line says which parameters are split), every
model type included; the data index deals the batches. The per-batch loop
is single-device, as in the JAX package.

The reference's checkpoint rotation crashes after epoch 0
(train_ppi.py:198: int('0_ppi')); this implements the intended keep-best
policy shared with the transductive trainer.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time

import numpy as np
import torch.distributed as dist

from pygat_tpu_torch.cli.train import bring_up_mesh


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="pygat_tpu_torch inductive PPI trainer")
    p.add_argument("--no-cuda", action="store_true", default=False,
                   help="run on the CPU (the default device is CUDA; without "
                        "a GPU and without this flag the trainer raises)")
    p.add_argument("--fastmode", action="store_true", default=False,
                   help="(reference compat; accepted and ignored)")
    p.add_argument("--dataset", type=str, default="ppi", choices=["ppi"])
    p.add_argument("--model", type=str, default="GAT",
                   choices=["GAT_sparse", "GAT", "GATv2", "GATv2_sparse"],
                   help="GAT_sparse / GATv2_sparse: edge-list attention; "
                        "GAT / GATv2 (the default): dense [N, N] attention")
    p.add_argument("--seed", type=int, default=72)
    p.add_argument("--epochs", type=int, default=10000)
    p.add_argument("--patience", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=2,
                   help="Number of graphs that are passed during training")
    p.add_argument("--backend", type=str, default=None,
                   choices=["stream", "xla"],
                   help="the segment impl: stream = the stream segment "
                        "sums and (PYGAT_FUSED_ATTENTION auto) the fused "
                        "attention; xla = index_add_ sums, the unfused "
                        "branch; default: PYGAT_SEGMENT_IMPL, else auto "
                        "(as stream)")
    p.add_argument("--platform", type=str, default=None,
                   help="the JAX package's platform switch; the port rejects "
                        "it (its one device switch is --no-cuda)")
    p.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    p.add_argument("--no-checkpoint", action="store_true", default=False)
    p.add_argument("--jsonl", type=str, default=None)
    p.add_argument("--quiet-batches", action="store_true", default=False)
    p.add_argument("--data-root", type=str, default=None)
    p.add_argument("--mesh", type=str, default=None, metavar="D,M",
                   help="with --epoch-scan: data parallelism over a process "
                        "group of D*M ranks (from torchrun's environment), "
                        "each layer's heads split over M model ranks")
    p.add_argument("--epoch-scan", action="store_true", default=False,
                   help="the banked loop: every graph on the device once, "
                        "batches collated there, one host sync per chunk of "
                        "epochs; per-epoch logs only")
    p.add_argument("--distributed", action="store_true", default=False,
                   help="bring up the process group from the launcher's "
                        "environment (torchrun); raises without one")
    p.add_argument("--log-every", type=int, default=10,
                   help="with --epoch-scan: epochs between ppi_epoch records")
    return p


def _reject_unported(args) -> None:
    if args.platform is not None:
        raise SystemExit("--platform picks a JAX platform and has no "
                         "counterpart in the port: it runs on CUDA, or on the "
                         "CPU with --no-cuda")
    on_mesh = args.mesh is not None or args.distributed
    if on_mesh and not args.epoch_scan:
        raise SystemExit("--mesh requires --epoch-scan (the per-batch loop "
                         "is single-device, as in the JAX package)")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _reject_unported(args)

    from pygat_tpu_torch.cli.train import BACKEND_IMPLS
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
    from pygat_tpu_torch.data.ppi import load_ppi, ppi_config
    from pygat_tpu_torch.models.presets import TRAIN_PRESETS
    from pygat_tpu_torch.ops import build
    from pygat_tpu_torch.train.inductive import (
        fit_inductive,
        fit_inductive_banked,
    )
    from pygat_tpu_torch.train.logging import TrainLogger
    from pygat_tpu_torch.utils.platform import resolve_device

    device = mesh.device if mesh else resolve_device(cpu=args.no_cuda)
    main_rank = mesh is None or mesh.is_main
    random.seed(args.seed)
    np.random.seed(args.seed)

    data = load_ppi(data_root=args.data_root)
    print(f"PPI graphs: {len(data.train)} train / {len(data.valid)} valid / "
          f"{len(data.test)} test")
    if data.synthetic_parts:
        print(f"WARNING: synthetic stand-ins for: {list(data.synthetic_parts)}")

    cfg = ppi_config(args.model)
    tp = TRAIN_PRESETS["ppi"]
    # rank 0 alone prints the epochs and writes the metrics
    logger = (TrainLogger(jsonl_path=args.jsonl) if main_rank
              else TrainLogger(stream=open(os.devnull, "w")))
    if mesh is not None:
        print(f"mesh: data={mesh.n_data} model={mesh.n_model} "
              f"rank={mesh.rank}")

    print(f"start training on {device}")
    t0 = time.time()
    common = dict(
        batch_size=args.batch_size,
        lr=tp["lr"],
        weight_decay=tp["weight_decay"],
        epochs=args.epochs,
        patience=args.patience,
        seed=args.seed,
        checkpoint_dir=None if args.no_checkpoint else args.checkpoint_dir,
        dataset_tag="ppi",
        logger=logger,
        device=device,
    )
    if args.epoch_scan:
        result = fit_inductive_banked(cfg, data, log_every=args.log_every,
                                      mesh=mesh, **common)
    else:
        result = fit_inductive(cfg, data, log_batches=not args.quiet_batches,
                               **common)
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
