"""Inductive PPI trainer CLI (port of ``pygat_tpu/cli/train_ppi.py``).

Same flags and defaults as the JAX package's CLI (reference
train_ppi.py:26-39, config train_ppi.py:43-55), running on CUDA unless
``--no-cuda`` asks for the CPU:

    python -m pygat_tpu_torch.cli.train_ppi --model GAT_sparse
    python -m pygat_tpu_torch.cli.train_ppi --model GATv2_sparse --epoch-scan

The PPI preset: 3 layers of 4, 4 and 6 heads, 50 (padded to 128) -> 256 ->
256 -> 121 features, skip connections, no dropout, lr 0.005, batch size 2.
Without ``--epoch-scan`` it trains by the per-batch loop
(``fit_inductive``), with it by the banked loop (``fit_inductive_banked``:
every graph on the device once, a chunk of epochs per host sync).
``--fastmode`` is accepted and has no effect, as in the JAX package. On
CUDA the last line counts the kernel launches made through their
wrappers. Flags whose machinery is not ported yet raise an error naming
the ROADMAP item that ports it: the dense models ``GAT`` and ``GATv2``
(so the default ``--model GAT`` raises until item 10 lands),
``--backend xla``, ``--mesh`` and ``--distributed``; ``--platform`` has no
counterpart in the port.

The reference's checkpoint rotation crashes after epoch 0
(train_ppi.py:198: int('0_ppi')); this implements the intended keep-best
policy shared with the transductive trainer.
"""

from __future__ import annotations

import argparse
import json
import random
import time

import numpy as np


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
                   help="GAT_sparse and GATv2_sparse are ported; the dense "
                        "models (the default GAT among them) are not yet")
    p.add_argument("--seed", type=int, default=72)
    p.add_argument("--epochs", type=int, default=10000)
    p.add_argument("--patience", type=int, default=100)
    p.add_argument("--batch_size", type=int, default=2,
                   help="Number of graphs that are passed during training")
    p.add_argument("--backend", type=str, default=None,
                   choices=["stream", "xla"],
                   help="stream = fused attention + stream segment sums "
                        "(the port's path); xla = the unfused path, not "
                        "ported yet")
    p.add_argument("--platform", type=str, default=None,
                   help="the JAX package's platform switch; the port rejects "
                        "it (its one device switch is --no-cuda)")
    p.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    p.add_argument("--no-checkpoint", action="store_true", default=False)
    p.add_argument("--jsonl", type=str, default=None)
    p.add_argument("--quiet-batches", action="store_true", default=False)
    p.add_argument("--data-root", type=str, default=None)
    p.add_argument("--mesh", type=str, default=None, metavar="D,M",
                   help="inductive data parallelism (not ported yet)")
    p.add_argument("--epoch-scan", action="store_true", default=False,
                   help="the banked loop: every graph on the device once, "
                        "batches collated there, one host sync per chunk of "
                        "epochs; per-epoch logs only")
    p.add_argument("--distributed", action="store_true", default=False,
                   help="multi-process initialization (not ported yet)")
    p.add_argument("--log-every", type=int, default=10,
                   help="with --epoch-scan: epochs between ppi_epoch records")
    return p


def _reject_unported(args) -> None:
    if args.platform is not None:
        raise SystemExit("--platform picks a JAX platform and has no "
                         "counterpart in the port: it runs on CUDA, or on the "
                         "CPU with --no-cuda")
    unported = [
        (args.mesh is not None, "--mesh", "Queue 1, item 14: multi-GPU"),
        (args.distributed, "--distributed", "Queue 1, item 14: multi-GPU"),
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

    from pygat_tpu_torch.data.ppi import load_ppi, ppi_config
    from pygat_tpu_torch.models.presets import TRAIN_PRESETS
    from pygat_tpu_torch.ops import build
    from pygat_tpu_torch.train.inductive import (
        fit_inductive,
        fit_inductive_banked,
    )
    from pygat_tpu_torch.train.logging import TrainLogger
    from pygat_tpu_torch.utils.platform import resolve_device

    device = resolve_device(cpu=args.no_cuda)
    random.seed(args.seed)
    np.random.seed(args.seed)

    data = load_ppi(data_root=args.data_root)
    print(f"PPI graphs: {len(data.train)} train / {len(data.valid)} valid / "
          f"{len(data.test)} test")
    if data.synthetic_parts:
        print(f"WARNING: synthetic stand-ins for: {list(data.synthetic_parts)}")

    cfg = ppi_config(args.model)
    tp = TRAIN_PRESETS["ppi"]
    logger = TrainLogger(jsonl_path=args.jsonl)

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
                                      **common)
    else:
        result = fit_inductive(cfg, data, log_batches=not args.quiet_batches,
                               **common)
    print("Optimization Finished!")
    print("Total time elapsed: {:.4f}s".format(time.time() - t0))
    print("Loading {}th epoch".format(result.best_epoch))
    if device.type == "cuda":
        print(f"Kernel launches: {json.dumps(build.launch_counts())}")
    logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
