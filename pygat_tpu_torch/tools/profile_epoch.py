"""Where the epoch's time goes on the GPU, by ``torch.profiler``.

    python -m pygat_tpu_torch.tools.profile_epoch [--model GATv2_sparse] [--large | --ppi]

Profiles one chunk of 10 epochs of each loop on the synthetic Cora stand-in
at the reference preset: the fast loop (replays of one captured CUDA graph)
and the per-epoch loop (eager, a host sync per epoch). ``--large`` profiles
the fast loop on the 524,288-node clustered graph of the banded path
(``clustered_citation``, spread 1024, the Cora preset's widths) instead,
over the band plan ``maybe_plan_large`` picks, over the corner plans
(``set_band("off")``, ``set_corner("on")``) and over the receiver stream
(``set_band("off")``). ``--ppi`` profiles PPI_EPOCHS epochs of both
inductive loops on the PPI stand-in at the PPI preset (full width, batch
size 2): the banked loop (batches collated on the card, one host read per
chunk) and the per-batch loop (every batch built on the host with its
walks and copied, the validation loss read every epoch). For each it
prints the wall time per epoch (host
clock around a synchronize), traced and untraced, the device-busy time per
epoch (the sum of all kernel and memory-operation durations the profiler
saw), the idle share of the traced chunk, and the ten kernels with the
most device time. Exits non-zero without a GPU, when the profiler reports
no device time, or when it reports more device time than the traced
chunk's wall time.
:func:`epoch_runners` is the set-up of both loops, shared with
``chip_smoke.py``'s epoch timing.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

EPOCHS = 10
PPI_EPOCHS = 3


def epoch_runners(cfg, data, n_epochs, plans=None):
    """(epoch, chunk) on ``data``'s device, each on a fresh state from the
    same seeds: ``epoch()`` is one epoch of the per-epoch loop (train step
    and eval forward, no host sync), ``chunk`` a :class:`ChunkedEpochs` of
    ``n_epochs`` with no epoch budget, whose ``run()`` is the fast loop's
    chunk; both over the banded order of ``plans`` when one is given."""
    from pygat_tpu_torch.models.gat import init_gat
    from pygat_tpu_torch.train.loop import ChunkedEpochs, make_transductive_steps
    from pygat_tpu_torch.train.state import init_state, make_optimizer
    from pygat_tpu_torch.utils.platform import make_generator

    device = data.features.device
    args = (data.features, data.graph, data.labels)

    def fresh_state(capturable):
        params = init_gat(cfg, make_generator("cpu", 72), device=device)
        return init_state(
            params, make_optimizer(params, 0.005, 5e-4, capturable=capturable),
            make_generator(device, 73))

    state = fresh_state(False)
    train_step, eval_step = make_transductive_steps(cfg, plans)

    def epoch():
        train_step(state, *args, data.idx_train)
        return eval_step(state.params, *args, data.idx_val)[0]

    chunk = ChunkedEpochs(cfg, fresh_state(device.type == "cuda"), *args,
                          data.idx_train, data.idx_val, n_epochs=n_epochs,
                          max_epochs=10 ** 6, patience=100, plans=plans)
    return epoch, chunk


def _profile(label, run, n_epochs):
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    traced_ms = (time.perf_counter() - t0) * 1e3 / n_epochs
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n_epochs

    # device-side events only, and no annotation ranges: an operator's or an
    # annotation's device time repeats the kernels under it
    rows = [(e.key, e.self_device_time_total / 1e3 / n_epochs,
             e.count / n_epochs)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation and e.self_device_time_total > 0]
    busy_ms = sum(r[1] for r in rows)
    if busy_ms <= 0:
        raise RuntimeError("the profiler reported no device time")
    # busy and idle against the wall time of the chunk the trace covers (a
    # device-bound chunk runs some tenths of a percent slower traced)
    if busy_ms > traced_ms:
        raise RuntimeError(f"{label}: device busy {busy_ms:.4f} ms per epoch "
                           f"exceeds the traced wall time {traced_ms:.4f} ms: "
                           "rows of the trace were counted twice")
    print(f"{label}: wall {wall_ms:.4f} ms per epoch ({traced_ms:.4f} ms while "
          f"traced), device busy {busy_ms:.4f} ms per epoch in "
          f"{sum(r[2] for r in rows):.0f} kernels and memory operations, "
          f"idle share {1 - busy_ms / traced_ms:.3f} of the traced chunk")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:10]:
        print(f"    {ms:8.4f} ms  {count:5.1f}x  {key[:100]}")


def large_dataset():
    """The large graph of the banded path on CUDA: 524,288 nodes, 9
    in-edges per node from within +-1024 of the receiver plus self-loops
    (the JAX package's ``_synthetic_citation(spread=1024)``), 128 features,
    4 classes."""
    from pygat_tpu_torch.data.synthetic import clustered_citation

    return clustered_citation(524_288, 128, 4, "large", spread=1024,
                              device="cuda")


def large_config(model: str, data):
    """The Cora preset (2 layers, 8 heads of 8, 1 output head, dropout 0.6)
    at ``data``'s feature and class counts."""
    from pygat_tpu_torch.models.gat import GATConfig
    from pygat_tpu_torch.models.presets import PRESETS

    cfg = GATConfig(layer_type=model, **PRESETS["cora"])
    return cfg._replace(nfeats=(data.num_features, cfg.nfeats[1],
                                data.num_classes))


def _profile_large(model: str) -> None:
    import torch

    from pygat_tpu_torch.ops.banded import BandPlan, maybe_plan_large, set_band
    from pygat_tpu_torch.ops.large import set_corner

    data = large_dataset()
    cfg = large_config(model, data)
    for band, corner in (("auto", "auto"), ("off", "on"), ("off", "off")):
        set_band(band)
        set_corner(corner)
        plans = maybe_plan_large(data.graph)
        if plans is None:
            over = "receiver stream"
        elif isinstance(plans, BandPlan):
            over = f"band plan (w={plans.w}, fill {plans.fill:.4f})"
        else:
            over = (f"corner plans (passes {[cp.p for cp in plans.fwd.passes]}"
                    f" / {[cp.p for cp in plans.inv.passes]})")
        _, chunk = epoch_runners(cfg, data, EPOCHS, plans)
        _profile(f"524k {model} over the {over}, fast loop", chunk.run, EPOCHS)
        del chunk, plans
        torch.cuda.empty_cache()
    set_band("auto")
    set_corner("auto")


def _profile_ppi(model: str) -> None:
    from pygat_tpu_torch.data.ppi import (
        bank_bounds,
        batch_bounds,
        build_bank,
        load_ppi,
        make_batches,
        ppi_config,
    )
    from pygat_tpu_torch.models.gat import init_gat
    from pygat_tpu_torch.models.presets import TRAIN_PRESETS
    from pygat_tpu_torch.train.inductive import BankedEpochs, make_inductive_steps
    from pygat_tpu_torch.train.state import init_state, make_optimizer
    from pygat_tpu_torch.utils.platform import make_generator

    data = load_ppi()
    cfg = ppi_config(model)

    def fresh_state():
        params = init_gat(cfg, make_generator("cpu", 72), device="cuda")
        return init_state(params, make_optimizer(params, **TRAIN_PRESETS["ppi"]),
                          make_generator("cuda", 73))

    n_pg, e_pg = bank_bounds([data.train, data.valid, data.test])
    chunk = BankedEpochs(cfg, fresh_state(),
                         build_bank(data.train, n_pg, e_pg, device="cuda"),
                         build_bank(data.valid, n_pg, e_pg, device="cuda"), 2,
                         n_epochs=PPI_EPOCHS, seed=72, max_epochs=10 ** 6,
                         patience=100)
    done = [0]

    def banked():
        chunk.run(done[0])
        done[0] += PPI_EPOCHS

    _profile(f"PPI {model}, banked loop", banked, PPI_EPOCHS)

    bounds = [batch_bounds(s, 2) for s in (data.train, data.valid, data.test)]
    n_pad, e_pad = max(b[0] for b in bounds), max(b[1] for b in bounds)
    state = fresh_state()
    train_step, eval_step = make_inductive_steps(cfg)

    def per_batch():
        for epoch in range(PPI_EPOCHS):
            for pb in make_batches(data.train, 2, n_pad=n_pad, e_pad=e_pad,
                                   shuffle=True, seed=72 + epoch,
                                   device="cuda"):
                train_step(state, pb.features, pb.batch.graph, pb.labels)
            for pb in make_batches(data.valid, 2, n_pad=n_pad, e_pad=e_pad,
                                   device="cuda"):
                float(eval_step(state.params, pb.features, pb.batch.graph,
                                pb.labels)[0])

    _profile(f"PPI {model}, per-batch loop", per_batch, PPI_EPOCHS)


def main(argv=None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", default="GATv2_sparse",
                   choices=["GAT_sparse", "GATv2_sparse"])
    where = p.add_mutually_exclusive_group()
    where.add_argument("--large", action="store_true",
                       help="the 524,288-node clustered graph, fast loop, "
                            "over the band plan, the corner plans and the "
                            "receiver stream")
    where.add_argument("--ppi", action="store_true",
                       help="the PPI stand-in at the PPI preset, the banked "
                            "and the per-batch inductive loops")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_epoch: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2

    from pygat_tpu_torch.data.citation import load_citation
    from pygat_tpu_torch.models.gat import GATConfig
    from pygat_tpu_torch.models.presets import PRESETS

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0])
    if args.large:
        _profile_large(args.model)
        return 0
    if args.ppi:
        _profile_ppi(args.model)
        return 0
    cora = load_citation("cora", device="cuda")
    cfg = GATConfig(layer_type=args.model, **PRESETS["cora"])
    cfg = cfg._replace(nfeats=(int(cora.features.shape[1]),) + cfg.nfeats[1:])
    epoch, chunk = epoch_runners(cfg, cora, EPOCHS)
    _profile(f"Cora {args.model}, fast loop", chunk.run, EPOCHS)

    def eager_chunk():
        for _ in range(EPOCHS):
            float(epoch())  # the per-epoch loop reads the validation loss

    _profile(f"Cora {args.model}, per-epoch loop", eager_chunk, EPOCHS)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
