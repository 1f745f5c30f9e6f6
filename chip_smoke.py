#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pygat_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. print the card (``nvidia-smi`` name and power limit), CUDA and nvcc
   versions;
2. build the three CUDA kernels from ``pygat_tpu_torch/csrc`` and print the
   build seconds and the compiler's register / shared-memory report;
3. hold each kernel against its plain PyTorch version on the card, at every
   shape the GAT_sparse and GATv2_sparse paths give it on Cora and Pubmed
   (the synthetic stand-ins have the real node, edge and feature counts);
   both Cora models, forward and gradients, on the card against the same
   model on the CPU;
4. train through ``pygat_tpu_torch.cli.train.main`` on CUDA, each run with
   the launch counters set to 0 just before and read just after, and check
   finite, falling training losses and the counters: Cora GAT_sparse and
   Pubmed GATv2_sparse by the per-epoch loop, Cora GATv2_sparse by the
   per-epoch loop and by the fast loop (``--epoch-chunk``, one captured
   CUDA graph replayed per epoch), whose epoch losses must agree. A
   wrapper's counter counts the wrapper's launches only; what the replays
   launch is reported beside it, as replays times launches captured;
5. time the Cora epoch of both models by both loops (host clock) and each
   kernel beside its plain version, its bound and, for the segment sum,
   ``index_add_`` (device time per call: calls captured in a CUDA graph,
   replays timed with CUDA events);
6. print the ``kernels`` JSON line, the card line, and last the ``ok`` line.

The script imports nothing of JAX or of the JAX package, needs no network
and starts no process other than ``nvidia-smi`` and ``nvcc``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
F32_FLOPS = 67e12  # H100 SXM f32 peak outside the tensor cores
# Kernel vs plain version on the card: both sum in f32 in orders that vary
# from run to run (atomics on both sides). Reassociating a sum changes it by
# a small multiple of 6e-8 times the sum of the magnitudes of its terms, so
# a segment sum is held to 1e-5 of the same segment sum over |data| (the
# dummy row of the sender side sums some 20k padding edges); the fused
# forward, whose rows sum at most a few hundred bounded terms, to 1e-5 of
# its largest output. An indexing or masking fault shows at O(1).
KERNEL_RTOL = 1e-5
# Whole model on the card vs the same model on the CPU: two layers of sums
# in different orders, exp and a softmax in between.
MODEL_RTOL = 1e-4
# The fast loop against the per-epoch loop on the card, same seeds: the same
# masks and updates, with atomics reordering every sum and a capturable Adam
# that rounds its bias correction on the device.
LOOPS_RTOL = 1e-4
V1_EPOCHS = 5
TRAIN_EPOCHS = 10
EPOCH_CHUNK = 5
TIMED_CHUNKS = 5  # chunks of 10 epochs timed for the fast loop
GRAPH_CALLS = 20  # kernel calls per captured CUDA graph
GRAPH_REPLAYS = 10


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _nvcc_version(nvcc: str) -> str:
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[-1]


def _time_ms(fn, calls: int = GRAPH_CALLS, replays: int = GRAPH_REPLAYS) -> float:
    """Device milliseconds per call of ``fn``: ``calls`` calls captured in
    one CUDA graph, replayed ``replays`` times between CUDA events, so the
    Python wrapper's host time does not hide in the measurement."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(stop) / (calls * replays)
    del graph
    return ms


def _max_err(got, want) -> tuple[float, float]:
    """(max |got - want|, KERNEL_RTOL * max(1, max |want|))."""
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError("kernel output is not finite")
    err = float((got - want).abs().max())
    return err, KERNEL_RTOL * max(1.0, float(want.abs().max()))


def _bound(n_bytes: float, n_flops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _scatter_cases(name, g, heads, feats, gen):
    """The stream segment sums one train step launches, per layer. GATv1:
    df_dst [E_s, H] per receiver and dwh [E_pad, HF] per sender (through
    c_slot). GATv2: dpre [E_s, HF] per receiver and [dpre | dmsg]
    [E_pad, 2HF] per sender."""
    import torch

    cases = []
    for path, widths in (("v1", lambda h, f: (h, h * f)),
                         ("v2", lambda h, f: (h * f, 2 * h * f))):
        for h, f in zip(heads, feats):
            for side, width in zip(("recv", "send"), widths(h, f)):
                live = (g.r_local if side == "recv" else g.c_local) < 128
                data = torch.randn(g.num_edges_padded, width, generator=gen,
                                   device="cuda")
                if side == "recv":
                    data = data * live[:, None]  # the backward's rows are 0 there
                cases.append(dict(dataset=name, path=path, side=side, L=width,
                                  data=data, n_live=int(live.sum())))
    return cases


def _scatter_call(case, g, fn):
    if case["side"] == "recv":
        return fn(case["data"], g.r_local, g.r_chunk, g.num_nodes_padded)
    return fn(case["data"], g.c_local, g.c_chunk, g.num_nodes_padded,
              slot=g.c_slot)


def _fused_inputs(g, h, f, gen):
    import torch

    from pygat_tpu_torch.ops.fused_stream import leaky_relu

    n = g.num_nodes_padded
    e = g.num_edges_padded
    wh = torch.randn(n, h * f, generator=gen, device="cuda") * 0.5
    a = torch.randn(h, 2 * f, generator=gen, device="cuda") * 0.5
    wh3 = wh.view(n, h, f)
    f_dst = torch.einsum("nho,ho->nh", wh3, a[:, :f]).contiguous()
    f_src = torch.einsum("nho,ho->nh", wh3, a[:, f:])
    m_src = torch.where(g.node_mask[:, None], f_src, float("-inf")).amax(0)
    bound = leaky_relu(f_dst + m_src[None], 0.2).contiguous()
    keepq = torch.where(torch.rand(e, h, generator=gen, device="cuda") < 0.4,
                        1.0 / 0.4, 0.0)
    return (wh, f_dst, bound, a[:, f:].contiguous(), keepq, g.senders,
            g.r_local, g.r_chunk, 0.2)


def _fused_v2_inputs(g, h, f, gen):
    """whi, whj, the sign-split bound ub as the layer builds it, a, and
    keep factors of dropout 0.6."""
    import torch

    from pygat_tpu_torch.ops.fused_stream import leaky_relu

    n = g.num_nodes_padded
    e = g.num_edges_padded
    whi = torch.randn(n, h * f, generator=gen, device="cuda") * 0.5
    whj = torch.randn(n, h * f, generator=gen, device="cuda") * 0.5
    a = torch.randn(h, f, generator=gen, device="cuda") * 0.5
    mask = g.node_mask[:, None]
    hi = torch.where(mask, whj, float("-inf")).amax(0).view(1, h, f)
    lo = torch.where(mask, whj, float("inf")).amin(0).view(1, h, f)
    whi3 = whi.view(n, h, f)
    ub = (torch.einsum("nhf,hf->nh", leaky_relu(whi3 + hi, 0.2), a.clamp(min=0))
          + torch.einsum("nhf,hf->nh", leaky_relu(whi3 + lo, 0.2),
                         a.clamp(max=0))).contiguous()
    keepq = torch.where(torch.rand(e, h, generator=gen, device="cuda") < 0.4,
                        1.0 / 0.4, 0.0)
    return (whi, whj, ub, a, keepq, g.senders, g.r_local, g.r_chunk, 0.2)


def _model_card_vs_cpu(layer_type, cora):
    """Forward and gradients of the Cora model on the card against the same
    model on the CPU (kernels against plain versions, end to end)."""
    import torch

    from pygat_tpu_torch.models.gat import GATConfig, apply_gat, init_gat, parameters
    from pygat_tpu_torch.models.presets import PRESETS
    from pygat_tpu_torch.utils.platform import make_generator

    cfg = GATConfig(layer_type=layer_type, **PRESETS["cora"])
    cfg = cfg._replace(nfeats=(int(cora.features.shape[1]),) + cfg.nfeats[1:])
    results = {}
    for dev in ("cuda", "cpu"):
        params = init_gat(cfg, make_generator("cpu", 72), device=dev)
        out = apply_gat(params, cfg, cora.features.to(dev), cora.graph.to(dev),
                        None, train=False)
        torch.sin(out[: cora.num_nodes]).sum().backward()
        results[dev] = (out.detach().cpu(),
                        [p.grad.detach().cpu() for p in parameters(params)])
    out_c, grads_c = results["cuda"]
    out_p, grads_p = results["cpu"]
    if not bool(torch.isfinite(out_c).all()):
        raise AssertionError("model output on the card is not finite")
    scale = max(1.0, float(out_p.abs().max()))
    err = float((out_c - out_p).abs().max())
    print(f"phase 3: Cora {layer_type} forward card vs CPU: max_abs_err "
          f"{err:.3e} (allowed {MODEL_RTOL * scale:.3e})")
    if err > MODEL_RTOL * scale:
        raise AssertionError("model forward on the card disagrees with the CPU")
    for i, (gc, gp) in enumerate(zip(grads_c, grads_p)):
        gscale = max(1e-30, float(gp.abs().max()))
        gerr = float((gc - gp).abs().max())
        print(f"  grad {i} {tuple(gp.shape)}: max_abs_err {gerr:.3e} "
              f"(allowed {MODEL_RTOL * gscale:.3e})")
        if not (gerr <= MODEL_RTOL * gscale):
            raise AssertionError("model gradient on the card disagrees with the CPU")
    return cfg


def _train_cli(argv, epochs, counters, jsonl):
    """One run of the trainer CLI on CUDA with every launch counter set to 0
    just before and read just after. Returns (the wrappers' launch counts,
    train losses, the CUDA graph replays the CLI reported, the launches one
    replay holds by kernel name)."""
    from pygat_tpu_torch.cli.train import main as train_main

    if os.path.exists(jsonl):
        os.remove(jsonl)
    for fn in counters.values():
        fn.launches = 0
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rc = train_main([*argv, "--epochs", str(epochs), "--no-checkpoint",
                         "--log-every", "1", "--jsonl", jsonl])
    launches = {name: fn.launches for name, fn in counters.items()}
    if rc != 0:
        raise AssertionError(f"train CLI returned {rc}")
    if "start training on cuda" not in text.getvalue():
        raise AssertionError("the trainer did not run on CUDA")
    with open(jsonl) as fh:
        recs = [json.loads(line) for line in fh]
    losses = [r["loss_train"] for r in recs if r["kind"] == "epoch"]
    if len(losses) != epochs or not all(math.isfinite(v) for v in losses):
        raise AssertionError("train losses missing or not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError("training loss did not fall")
    m = re.search(r"CUDA graph replays: (\d+), each launching (\{.*\})",
                  text.getvalue())
    if m is None:
        return launches, losses, 0, dict.fromkeys(counters, 0)
    return launches, losses, int(m.group(1)), json.loads(m.group(2))


def _epoch_ms(cfg, cora):
    """Median host milliseconds per Cora epoch (train step + eval forward),
    by the per-epoch loop (30 epochs, a synchronize after each) and by the
    fast loop (TIMED_CHUNKS chunks of 10 graph replays, one sync each)."""
    import torch

    from pygat_tpu_torch.tools.profile_epoch import epoch_runners

    epoch, chunk = epoch_runners(cfg, cora, 10)
    for _ in range(5):
        epoch()
    torch.cuda.synchronize()
    samples = []
    for _ in range(30):
        t0 = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        samples.append((time.perf_counter() - t0) * 1e3)
    samples.sort()

    chunk.run()  # warm-up epoch, capture, first replays
    fast = []
    for _ in range(TIMED_CHUNKS):
        t0 = time.perf_counter()
        chunk.run()
        fast.append((time.perf_counter() - t0) * 1e3 / chunk.n_epochs)
    if chunk.graph_replays != 10 * (TIMED_CHUNKS + 1):
        raise AssertionError("the fast loop did not replay its CUDA graph")
    fast.sort()
    return samples, fast


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    from pygat_tpu_torch.data.citation import load_citation
    from pygat_tpu_torch.models.presets import PRESETS
    from pygat_tpu_torch.ops import build
    from pygat_tpu_torch.ops.fused_stream import (
        fused_v1,
        fused_v1_plain,
        fused_v2,
        fused_v2_plain,
    )
    from pygat_tpu_torch.ops.stream import stream_scatter, stream_scatter_plain

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.cuda.device_count() >= 1
    kind = torch.cuda.get_device_name(0)

    # -- phase 1: the card and the toolchain ---------------------------------
    card = _card_line()
    print(f"phase 1: card {card!r}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {_nvcc_version(build.nvcc_path())}",
          flush=True)

    # -- phase 2: build --------------------------------------------------------
    secs = build.build_all()
    print(f"phase 2: built {list(build.SOURCES)} in {secs:.2f} s", flush=True)
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # -- phase 3: kernels against their plain versions -------------------------
    gen = torch.Generator(device="cuda")
    gen.manual_seed(72)
    datasets = {}
    for name in ("cora", "pubmed"):
        t0 = time.perf_counter()
        ds = load_citation(name, device="cuda")
        datasets[name] = ds
        g = ds.graph
        print(f"phase 3: {name}: N_pad {g.num_nodes_padded}, E_s "
              f"{g.num_edges_padded}, CSC stream {g.c_slot.shape[0]}, "
              f"features {tuple(ds.features.shape)} "
              f"({time.perf_counter() - t0:.1f} s to load)", flush=True)

    kernel_cases = {"stream_scatter": [], "fused_v1": [], "fused_v2": []}
    fused = {"fused_v1": (fused_v1, fused_v1_plain, _fused_inputs),
             "fused_v2": (fused_v2, fused_v2_plain, _fused_v2_inputs)}
    for name, ds in datasets.items():
        g = ds.graph
        heads, feats = PRESETS[name]["nheads"], PRESETS[name]["nfeats"][1:]
        for case in _scatter_cases(name, g, heads, feats, gen):
            got = _scatter_call(case, g, stream_scatter)
            want = _scatter_call(case, g, stream_scatter_plain)
            mag = _scatter_call(dict(case, data=case["data"].abs()), g,
                                stream_scatter_plain)
            torch.cuda.synchronize()
            if not bool(torch.isfinite(got).all()):
                raise AssertionError("kernel output is not finite")
            diff = (got - want).abs()
            err = float(diff.max())
            worst = float((diff / (KERNEL_RTOL * mag + 1e-30)).max())
            case.update(max_abs_err=err)
            print(f"  stream_scatter {name} {case['path']} {case['side']} "
                  f"L={case['L']}: max_abs_err {err:.3e}, worst element at "
                  f"{worst:.3f} of its allowance")
            if worst > 1.0:
                raise AssertionError("stream_scatter disagrees with its plain version")
            kernel_cases["stream_scatter"].append(case)
        for kname, (kernel, plain, make_inputs) in fused.items():
            for h, f in zip(heads, feats):
                args = make_inputs(g, h, f, gen)
                out, den = kernel(*args)
                out_p, den_p = plain(*args)
                torch.cuda.synchronize()
                e1, a1 = _max_err(out, out_p)
                e2, a2 = _max_err(den, den_p)
                print(f"  {kname} {name} H={h} F={f}: max_abs_err out {e1:.3e} "
                      f"(allowed {a1:.3e}), den {e2:.3e} (allowed {a2:.3e})")
                if e1 > a1 or e2 > a2:
                    raise AssertionError(f"{kname} disagrees with its plain version")
                kernel_cases[kname].append(dict(
                    dataset=name, H=h, F=f, args=args, max_abs_err=max(e1, e2),
                    n_live=int((g.r_local < 128).sum())))

    # the whole Cora models, forward and gradients: card vs CPU
    cora = datasets["cora"]
    cfgs = {lt: _model_card_vs_cpu(lt, cora)
            for lt in ("GAT_sparse", "GATv2_sparse")}

    # -- phase 4: the main paths, through the CLI ------------------------------
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    jsonl = os.path.join(build.BUILD_DIR, "chip_smoke_train.jsonl")
    counters = dict(build.WRAPPERS)  # every kernel's wrapper, by name
    # per epoch: 2 layers x (train forward + eval forward) fused launches and
    # 2 layers x 2 segment sums in the backward; the test forward adds 2.
    # A wrapper counts its own launches and nothing else does. Under the fast
    # loop those are one eager warm-up epoch, the one epoch launched into the
    # CUDA graph's capture, and the test forward; the replays launch the
    # captured kernels without the wrappers, so the script reports them
    # apart, as replays x launches captured.
    runs = [
        ("cora GAT_sparse, per-epoch loop", "fused_v1", V1_EPOCHS,
         ["--dataset", "cora", "--model", "GAT_sparse"]),
        ("pubmed GATv2_sparse, per-epoch loop", "fused_v2", TRAIN_EPOCHS,
         ["--dataset", "pubmed", "--model", "GATv2_sparse"]),
        ("cora GATv2_sparse, per-epoch loop", "fused_v2", TRAIN_EPOCHS,
         ["--dataset", "cora", "--model", "GATv2_sparse"]),
        ("cora GATv2_sparse, fast loop", "fused_v2", TRAIN_EPOCHS,
         ["--dataset", "cora", "--model", "GATv2_sparse",
          "--epoch-chunk", str(EPOCH_CHUNK)]),
    ]
    launches = dict.fromkeys(counters, 0)
    replayed = dict.fromkeys(counters, 0)
    path_launches, path_replayed, path_losses = {}, {}, {}
    for label, fused_name, epochs, argv in runs:
        got, losses, replays, captured = _train_cli(argv, epochs, counters,
                                                    jsonl)
        by_replay = {name: replays * n for name, n in captured.items()}
        path_launches[label], path_losses[label] = got, losses
        path_replayed[label] = by_replay
        print(f"phase 4: {label}: wrapper launches {got}; {replays} CUDA "
              f"graph replays, each launching {captured}, so {by_replay} "
              f"more by replay; train losses {losses}", flush=True)
        other = "fused_v1" if fused_name == "fused_v2" else "fused_v2"
        if got[other] or captured[other]:
            raise AssertionError(f"{other} ran on the {fused_name} path")
        if "fast loop" in label:
            want = {fused_name: 4, "stream_scatter": 4, other: 0}
            if replays != epochs or captured != want:
                raise AssertionError(
                    f"{replays} replays of {captured} for {epochs} epochs of "
                    f"{want}")
            # warm-up epoch + captured epoch, and the test forward
            if (got[fused_name] != 2 * 4 + 2 or got["stream_scatter"] != 2 * 4):
                raise AssertionError("the fast loop's wrapper launches are off")
        else:
            if replays:
                raise AssertionError("CUDA graph replays in the per-epoch loop")
            if got[fused_name] != 2 * 2 * epochs + 2:
                raise AssertionError(f"{fused_name} launches are off")
            if got["stream_scatter"] != 2 * 2 * epochs:
                raise AssertionError("stream_scatter launches are off")
        for name in counters:
            launches[name] += got[name]
            replayed[name] += by_replay[name]
    slow = path_losses["cora GATv2_sparse, per-epoch loop"]
    fast = path_losses["cora GATv2_sparse, fast loop"]
    worst = max(abs(x - y) / abs(y) for x, y in zip(fast, slow))
    print(f"phase 4: fast loop vs per-epoch loop, {TRAIN_EPOCHS} epoch losses: "
          f"worst relative difference {worst:.3e} (allowed {LOOPS_RTOL:.0e})")
    if not worst <= LOOPS_RTOL:
        raise AssertionError("the fast loop's losses differ from the per-epoch loop's")

    # -- phase 5: timing --------------------------------------------------------
    epoch_ms = {}
    for lt, cfg in cfgs.items():
        samples, fast_samples = _epoch_ms(cfg, cora)
        epoch_ms[lt] = {"per_epoch_loop_ms": samples[len(samples) // 2],
                        "fast_loop_ms": fast_samples[len(fast_samples) // 2]}
        print(f"phase 5: Cora {lt} epoch (train step + eval forward), host "
              f"clock: per-epoch loop, 30 epochs with a synchronize each: "
              f"median {samples[len(samples) // 2]:.4f} ms, min "
              f"{samples[0]:.4f}, max {samples[-1]:.4f}; fast loop, "
              f"{TIMED_CHUNKS} chunks of 10 CUDA graph replays: median "
              f"{fast_samples[len(fast_samples) // 2]:.4f} ms per epoch, min "
              f"{fast_samples[0]:.4f}, max {fast_samples[-1]:.4f}", flush=True)

    for case in kernel_cases["stream_scatter"]:
        g = datasets[case["dataset"]].graph
        n_pad, width = g.num_nodes_padded, case["L"]
        case["ms"] = _time_ms(lambda: _scatter_call(case, g, stream_scatter))
        case["plain_ms"] = _time_ms(
            lambda: _scatter_call(case, g, stream_scatter_plain))
        # one PyTorch call computing the same sums: index_add_ into a zeroed
        # buffer with one scratch row taking the dead slots
        if case["side"] == "recv":
            idx = torch.where(g.r_local < 128,
                              g.r_chunk.long().repeat_interleave(256) * 128
                              + g.r_local.long(), n_pad)
        else:
            idx = g.senders.long()
        lib_out = torch.zeros(n_pad + 1, width, device="cuda")
        case["library_ms"] = _time_ms(
            lambda: lib_out.index_add_(0, idx, case["data"]))
        idx_words = g.r_local.numel() + g.r_chunk.numel() + (
            g.c_slot.numel() if case["side"] == "send" else 0)
        n_bytes = 4 * (case["n_live"] * width + idx_words + n_pad * width)
        case["bound_ms"], case["bound_by"] = _bound(
            n_bytes, case["n_live"] * width)
        print(f"  stream_scatter {case['dataset']} {case['path']} "
              f"{case['side']} L={width}: "
              f"{case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
              f"index_add_ {case['library_ms']:.4f} ms, bound "
              f"{case['bound_ms']:.5f} ms ({case['bound_by']})")
    for kname, (kernel, plain, _) in fused.items():
        for case in kernel_cases[kname]:
            args = case["args"]
            g = datasets[case["dataset"]].graph
            n_pad, h, f = g.num_nodes_padded, case["H"], case["F"]
            case["ms"] = _time_ms(lambda: kernel(*args))
            case["plain_ms"] = _time_ms(lambda: plain(*args))
            case["library_ms"] = None
            n_live = case["n_live"]
            index_words = 2 * g.num_edges_padded + g.r_chunk.numel()
            if kname == "fused_v1":
                n_bytes = 4 * (n_pad * h * f + 2 * n_pad * h + h * f
                               + n_live * h + index_words
                               + n_pad * (h * f + h))
                n_flops = n_live * (4 * h * f + 6 * h)
            else:
                # each input once: the node tables whi and whj (their
                # gathered rows are re-read from L2, not from memory), ub,
                # a, a live slot's keep factors, the index words; out and
                # den written
                n_bytes = 4 * (2 * n_pad * h * f + n_pad * h + h * f
                               + n_live * h + index_words
                               + n_pad * (h * f + h))
                n_flops = n_live * (6 * h * f + 6 * h)
            case["bound_ms"], case["bound_by"] = _bound(n_bytes, n_flops)
            print(f"  {kname} {case['dataset']} H={h} F={f}: "
                  f"{case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
                  f"bound {case['bound_ms']:.5f} ms ({case['bound_by']})")

    # -- phase 6: the kernels line ----------------------------------------------
    replaces = {"stream_scatter": "pygat_tpu/ops/stream.py:153",
                "fused_v1": "pygat_tpu/ops/fused_stream.py:134",
                "fused_v2": "pygat_tpu/ops/fused_stream.py:207"}
    entries = []
    for name, cases in kernel_cases.items():
        # the Cora numbers sum the shapes one train step gives the kernel
        # (stream_scatter: the 4 backward launches of each model's step; the
        # fused kernels: one forward's 2 launches); every shape of both
        # datasets is listed under "cases". "launches" sums the wrapper's
        # count over the main-path runs of phase 4 (one by one under
        # "launches_by_path"); "replayed_launches" are those of the fast
        # loop's CUDA graph replays, replays x launches captured.
        cora_cases = [c for c in cases if c["dataset"] == "cora"]
        lib = [c["library_ms"] for c in cora_cases]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"pygat_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "launches_by_path": {k: v[name] for k, v in path_launches.items()},
            "replayed_launches": replayed[name],
            "replayed_launches_by_path": {
                k: v[name] for k, v in path_replayed.items()},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": sum(c["ms"] for c in cora_cases),
            "plain_ms": sum(c["plain_ms"] for c in cora_cases),
            "bound_ms": sum(c["bound_ms"] for c in cora_cases),
            "bound_by": "bytes" if all(c["bound_by"] == "bytes" for c in cora_cases)
            else "operations",
            "library_ms": None if None in lib else sum(lib),
            "cases": [{k: c[k] for k in ("dataset", "path", "side", "L", "H",
                                         "F", "ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by",
                                         "max_abs_err") if k in c}
                      for c in cases],
        })
    print(json.dumps({"kernels": entries, "epoch_ms": epoch_ms,
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
