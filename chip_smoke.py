#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pygat_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:

1. print the card (``nvidia-smi`` name and power limit), CUDA and nvcc
   versions;
2. build both CUDA kernels from ``pygat_tpu_torch/csrc`` and print the build
   seconds and the compiler's register / shared-memory report;
3. hold each kernel against its plain PyTorch version on the card, at every
   shape the main path gives it on Cora and Pubmed (the synthetic stand-ins
   have the real node, edge and feature counts); the Cora GAT_sparse model
   forward and gradients on the card against the same model on the CPU;
4. train Cora GAT_sparse through ``pygat_tpu_torch.cli.train.main`` on CUDA,
   with the launch counters set to 0 just before and read just after, and
   check finite, falling training losses and both counters;
5. time one train epoch (host clock) and each kernel beside its plain
   version, its bound and, for the segment sum, ``index_add_`` (device time
   per call: calls captured in a CUDA graph, replays timed with CUDA
   events);
6. print the ``kernels`` JSON line, the card line, and last the ``ok`` line.

The script imports nothing of JAX or of the JAX package, needs no network
and starts no process other than ``nvidia-smi`` and ``nvcc``.
"""

from __future__ import annotations

import json
import math
import os
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
TRAIN_EPOCHS = 10
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
    """The stream segment sums one train step launches: per layer, df_dst
    [E_s, H] per receiver and dwh [E_pad, HF] per sender (through c_slot)."""
    import torch

    cases = []
    for h, f in zip(heads, feats):
        for side, width in (("recv", h), ("send", h * f)):
            live = (g.r_local if side == "recv" else g.c_local) < 128
            data = torch.randn(g.num_edges_padded, width, generator=gen,
                               device="cuda")
            if side == "recv":
                data = data * live[:, None]  # the backward's draw is 0 there
            cases.append(dict(dataset=name, side=side, L=width, data=data,
                              n_live=int(live.sum())))
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    from pygat_tpu_torch.data.citation import load_citation
    from pygat_tpu_torch.models.gat import GATConfig, apply_gat, init_gat, parameters
    from pygat_tpu_torch.models.presets import PRESETS
    from pygat_tpu_torch.ops import build
    from pygat_tpu_torch.ops.fused_stream import fused_v1, fused_v1_plain
    from pygat_tpu_torch.ops.stream import stream_scatter, stream_scatter_plain
    from pygat_tpu_torch.train.loop import make_transductive_steps
    from pygat_tpu_torch.train.state import init_state, make_optimizer
    from pygat_tpu_torch.utils.platform import make_generator

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

    kernel_cases = {"stream_scatter": [], "fused_v1": []}
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
            print(f"  stream_scatter {name} {case['side']} L={case['L']}: "
                  f"max_abs_err {err:.3e}, worst element at {worst:.3f} of "
                  f"its allowance")
            if worst > 1.0:
                raise AssertionError("stream_scatter disagrees with its plain version")
            kernel_cases["stream_scatter"].append(case)
        for h, f in zip(heads, feats):
            args = _fused_inputs(g, h, f, gen)
            out, den = fused_v1(*args)
            out_p, den_p = fused_v1_plain(*args)
            torch.cuda.synchronize()
            e1, a1 = _max_err(out, out_p)
            e2, a2 = _max_err(den, den_p)
            err = max(e1, e2)
            print(f"  fused_v1 {name} H={h} F={f}: max_abs_err out {e1:.3e} "
                  f"(allowed {a1:.3e}), den {e2:.3e} (allowed {a2:.3e})")
            if e1 > a1 or e2 > a2:
                raise AssertionError("fused_v1 disagrees with its plain version")
            kernel_cases["fused_v1"].append(dict(
                dataset=name, H=h, F=f, args=args, max_abs_err=err,
                n_live=int((g.r_local < 128).sum())))

    # the whole Cora model, forward and gradients: card vs CPU
    cora = datasets["cora"]
    cfg = GATConfig(layer_type="GAT_sparse", **PRESETS["cora"])
    cfg = cfg._replace(nfeats=(int(cora.features.shape[1]),) + cfg.nfeats[1:])
    results = {}
    for dev in ("cuda", "cpu"):
        params = init_gat(cfg, make_generator("cpu", 72), device=dev)
        g_dev = cora.graph.to(dev)
        x = cora.features.to(dev)
        out = apply_gat(params, cfg, x, g_dev, None, train=False)
        torch.sin(out[: cora.num_nodes]).sum().backward()
        results[dev] = (out.detach().cpu(),
                        [p.grad.detach().cpu() for p in parameters(params)])
    out_c, grads_c = results["cuda"]
    out_p, grads_p = results["cpu"]
    if not bool(torch.isfinite(out_c).all()):
        raise AssertionError("model output on the card is not finite")
    scale = max(1.0, float(out_p.abs().max()))
    err = float((out_c - out_p).abs().max())
    print(f"phase 3: Cora GAT_sparse forward card vs CPU: max_abs_err "
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

    # -- phase 4: the main path, through the CLI -------------------------------
    from pygat_tpu_torch.cli.train import main as train_main

    os.makedirs(build.BUILD_DIR, exist_ok=True)
    jsonl = os.path.join(build.BUILD_DIR, "chip_smoke_train.jsonl")
    if os.path.exists(jsonl):
        os.remove(jsonl)
    stream_scatter.launches = 0
    fused_v1.launches = 0
    rc = train_main(["--dataset", "cora", "--model", "GAT_sparse",
                     "--epochs", str(TRAIN_EPOCHS), "--no-checkpoint",
                     "--jsonl", jsonl])
    launches = {"stream_scatter": stream_scatter.launches,
                "fused_v1": fused_v1.launches}
    if rc != 0:
        raise AssertionError(f"train CLI returned {rc}")
    with open(jsonl) as fh:
        recs = [json.loads(line) for line in fh]
    losses = [r["loss_train"] for r in recs if r["kind"] == "epoch"]
    print(f"phase 4: launches {launches}; train losses {losses}", flush=True)
    if len(losses) != TRAIN_EPOCHS or not all(math.isfinite(v) for v in losses):
        raise AssertionError("train losses missing or not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError("training loss did not fall")
    # per epoch: 2 layers x (train forward + eval forward) fused launches and
    # 2 layers x 2 segment sums in the backward; the test forward adds 2
    if launches["fused_v1"] < 2 * 2 * TRAIN_EPOCHS + 2:
        raise AssertionError("fused_v1 was launched too few times")
    if launches["stream_scatter"] < 2 * 2 * TRAIN_EPOCHS:
        raise AssertionError("stream_scatter was launched too few times")

    # -- phase 5: timing --------------------------------------------------------
    params = init_gat(cfg, make_generator("cpu", 72), device="cuda")
    state = init_state(params, make_optimizer(params, 0.005, 5e-4),
                       make_generator("cuda", 73))
    train_step, eval_step = make_transductive_steps(cfg)

    def epoch():
        train_step(state, cora.features, cora.graph, cora.labels, cora.idx_train)
        eval_step(state.params, cora.features, cora.graph, cora.labels,
                  cora.idx_val)

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
    epoch_ms = samples[len(samples) // 2]
    print(f"phase 5: Cora GAT_sparse epoch (train step + eval forward), "
          f"host clock with synchronize, 30 epochs: median {epoch_ms:.4f} ms, "
          f"min {samples[0]:.4f}, max {samples[-1]:.4f}", flush=True)

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
        print(f"  stream_scatter {case['dataset']} {case['side']} L={width}: "
              f"{case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
              f"index_add_ {case['library_ms']:.4f} ms, bound "
              f"{case['bound_ms']:.5f} ms ({case['bound_by']})")
    for case in kernel_cases["fused_v1"]:
        args = case["args"]
        g = datasets[case["dataset"]].graph
        n_pad, h, f = g.num_nodes_padded, case["H"], case["F"]
        case["ms"] = _time_ms(lambda: fused_v1(*args))
        case["plain_ms"] = _time_ms(lambda: fused_v1_plain(*args))
        case["library_ms"] = None
        n_live = case["n_live"]
        n_bytes = 4 * (n_pad * h * f + 2 * n_pad * h + h * f
                       + n_live * h + 2 * g.num_edges_padded
                       + g.r_chunk.numel() + n_pad * (h * f + h))
        case["bound_ms"], case["bound_by"] = _bound(
            n_bytes, n_live * (4 * h * f + 6 * h))
        print(f"  fused_v1 {case['dataset']} H={h} F={f}: {case['ms']:.4f} ms, "
              f"plain {case['plain_ms']:.4f} ms, bound "
              f"{case['bound_ms']:.5f} ms ({case['bound_by']})")

    # -- phase 6: the kernels line ----------------------------------------------
    replaces = {"stream_scatter": "pygat_tpu/ops/stream.py:153",
                "fused_v1": "pygat_tpu/ops/fused_stream.py:134"}
    entries = []
    for name, cases in kernel_cases.items():
        # the Cora numbers sum the shapes one train step gives the kernel
        # (stream_scatter: its 4 backward launches; fused_v1: one forward's
        # 2 launches); every shape of both datasets is listed under "cases"
        cora_cases = [c for c in cases if c["dataset"] == "cora"]
        lib = [c["library_ms"] for c in cora_cases]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"pygat_tpu_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": sum(c["ms"] for c in cora_cases),
            "plain_ms": sum(c["plain_ms"] for c in cora_cases),
            "bound_ms": sum(c["bound_ms"] for c in cora_cases),
            "bound_by": "bytes" if all(c["bound_by"] == "bytes" for c in cora_cases)
            else "operations",
            "library_ms": None if None in lib else sum(lib),
            "cases": [{k: c[k] for k in ("dataset", "side", "L", "H", "F",
                                         "ms", "plain_ms", "library_ms",
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
