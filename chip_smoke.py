#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pygat_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure, and each
of which prints its seconds:

1. print the card (``nvidia-smi`` name and power limit), CUDA and nvcc
   versions;
2. build the fourteen CUDA kernels from ``pygat_tpu_torch/csrc`` and print
   the build seconds and the compiler's register / shared-memory report;
3. hold each kernel against its plain PyTorch version on the card, at every
   shape the GAT_sparse and GATv2_sparse paths give it: the stream kernels
   on Cora and Pubmed (the synthetic stand-ins have the real node, edge and
   feature counts) and on the 524,288-node graph's receiver stream (the
   order ``set_band("off")`` trains over), the segment sums
   (``stream_scatter``, receiver side over the stream's walk, sender side
   over the CSC stream's) and the fused forwards over each graph's walk,
   called twice (the two results equal bit for bit; the plain versions in
   f64), the banded kernels (and ``stream_scatter`` at its
   banded widths, over the plan's receiver walk; ``banded_sender_sum``
   over its sender walk, with data on the dead slots) on the 524,288-node
   clustered graph with the band plan
   that ``maybe_plan_large`` picks by itself, and on Cora with
   ``set_band("on")``, the fused banded forwards also on the hub graph's
   band plan (a tile cut into pieces), each of them called twice (the two
   results equal bit for bit), and the stream kernels on the hub graph's
   stream (both sides: the hub's run and the dummy sender's cut into
   segments, their tiles into pieces); the corner kernels: ``permute_pass`` bit-exact on
   every pass of both 524k corner plans (built once, their set-up timed) at
   every width the two models turn (64, 4, 128, 8), the whole pass chain
   with its fix-ups on a Cora plan with overflow rows (span cap 3) card vs
   CPU, and the window forwards at the Cora and 524k shapes (called twice,
   equal bit for bit); both Cora
   models, forward and gradients, on the card against the same model on
   the CPU, over the receiver stream, over the band plan and over the
   corner plans, and over the corner plans against the receiver stream
   under dropout with one generator seed (the same masks);
4. train on CUDA, each run with the launch counters set to 0 just before
   and read just after, and check finite, falling training losses and the
   counters: through ``pygat_tpu_torch.cli.train.main``, Cora GAT_sparse
   and Pubmed GATv2_sparse by the per-epoch loop, Cora GATv2_sparse by the
   per-epoch loop and by the fast loop (``--epoch-chunk``, one captured
   CUDA graph replayed per epoch), whose epoch losses must agree; the
   524,288-node graph through the trainers with no switch (the band plan
   chosen automatically): GAT_sparse by ``fit_transductive`` and both
   models by ``fit_transductive_fast``, with no launch of the stream's
   fused kernels (there the validation loss must fall: the graph's train
   split holds one label, and its training loss moves with the dropout
   masks in the first epochs); both models by ``fit_transductive_fast``
   under ``set_band("off")`` and ``set_corner("on")``, over the corner
   plans the trainer builds, with the launch counts ``_want_corner``
   states and no banded or stream-fused launch; ``--corner on`` through
   the CLI on Cora, whose printed counts must equal the counters; and
   ``PYGAT_BAND=on python -m pygat_tpu_torch.cli.train`` on Cora as a
   subprocess, whose own counts it prints. A wrapper's counter
   counts the wrapper's launches only; what the replays launch is reported
   beside it, as replays times launches captured;
5. time the Cora epoch of both models by both loops and the 524,288-node
   epoch of both models by the fast loop, over the band plan, over the
   corner plans and over the receiver stream (``set_band("off")``), in
   turns, one captured epoch on the card at a time (host clock), and each
   kernel at each shape beside its plain
   version, its bound and, where one PyTorch call computes the same
   function, that call (``index_add_`` for the segment sums,
   ``index_select`` of rows for the gathers and the corner passes): device
   time per call, calls captured in a CUDA graph, replays timed with CUDA
   events;
6. the SpMM path, after every captured epoch is freed: the op family
   (``spmm_graph``, ``sddmm_graph``, ``panel_spmm_graph`` with and without
   ``plans=``, ``spmm_corner_graph``, ``spmm_banded`` fused and two-pass)
   forward and backward at L = 128 on the Pubmed stand-in and the 524k
   graph (its band plan and corner plans from phase 3, panel layouts
   uncapped and capped at 8 panels), with the launch counters set to 0
   just before and read just after: each op's outputs and gradients held
   against the plain SpMM (``ops.spmm``, row gathers and ``index_add_``)
   and against ``spmm_graph``, each call's launches as its route states;
   then the two SpMM kernels (``spmm_banded``, ``panel_spmm``) against
   their plain versions, there and on a small graph with a hub whose tile
   the kernels split, each called twice (the two results equal bit for
   bit), and timed beside them, their bounds and ``torch.sparse.mm`` over
   the same weighted graph; the panel layouts' set-up seconds and the
   phase's peak device memory;
7. the BCSR path (``pygat_tpu_torch.legacy_bcsr``, which no model
   reaches): the Cora and Pubmed stand-ins, the 524k graph and the hub
   graph, each tiled once (its seconds printed, and its walk's: the
   kernel's walk over the valid slots, built with the tiling and timed
   again alone); with the launch counters set to 0 just before and read
   just after, ``gat_attention_v1`` by the fused route
   (``backend="pallas"``: one ``bcsr_attention`` launch forward, two
   ``stream_scatter`` launches backward) against the segment-op route
   (``"xla"``), forward and gradients, at the Cora and Pubmed preset
   widths, with dropout off and at p = 0.6 (one generator seed per pair,
   so one mask); then ``bcsr_attention`` against its plain version in f64
   at those widths, the 524k graph's and the hub graph's (its tile cut
   into pieces, the hub's run into segments), with no dropout mask and
   with one, called twice (the two results equal bit for bit), and timed
   beside its plain version and its bound; at 524k also the stream and
   banded fused forwards (``fused_v1``, ``fused_v1_banded``) over the same
   attention;
8. the PPI path (``pygat_tpu_torch.cli.train_ppi``, the inductive
   trainer): load the PPI stand-in (20 / 2 / 2 graphs at the real sizes);
   on the first train batch of ``make_batches`` and on a batch assembled
   from the device-resident bank with a dead member (whose walks, assembled
   on the card, must equal those built on the host from its fields) hold
   rows 1-3 at the preset's widths (fused forwards at H 4 F 256 and H 6 F
   121, GATv2's with exact bounds; segment sums at L = 4, 6, 726, 1,024,
   1,452 and 2,048) against their f64 plain versions, each called twice
   (equal bit for bit); both models on the train batch, forward and
   gradients, card vs CPU; then through the CLI, with the counters set to
   0 just before each run and read just after, both models by the
   per-batch loop and by the banked loop (``--epoch-scan``) for
   PPI_EPOCHS epochs: finite, falling training losses, the launches
   ``_want_ppi`` states (and the CLI prints) and no other kernel, and the
   banked loop's first-epoch losses equal to the per-batch loop's within
   LOOPS_RTOL; then the kernels on the train batch timed as in phase 5,
   and the epoch of both loops of both models (the per-batch loop split
   into host batch building, copies and device steps); the phase fails
   past PPI_BUDGET_S seconds;
9. print the ``kernels`` JSON line, the card line, and last the ``ok`` line.

The script imports nothing of JAX or of the JAX package, needs no network
and starts no process other than ``nvidia-smi``, ``nvcc`` and the one
trainer subprocess, and waits for each. Without the PPI files under
``data/ppi/`` it builds the loader's deterministic stand-ins.
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
# Kernel vs plain version on the card: the kernels sum in f32 in an order
# fixed by their walk, the plain versions are evaluated in f64
# (``f64=True``): the hub graph's row sums 9,000 terms, whose f32 sum by
# index_add_ alone (atomics, in an order that varies from run to run) is
# off by up to about 1e-5 of it. Reassociating a sum changes it by a small
# multiple of 6e-8 times the sum of the magnitudes of its terms, so a
# segment sum is held to 1e-5 of the same segment sum over |data| (the
# dummy row of the sender side sums some 20k padding edges); the fused
# forward to 1e-5 of its largest output. An indexing or masking fault
# shows at O(1).
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
# the large graph of the banded path (profile_epoch.large_dataset)
LARGE_EPOCHS = 3  # per-epoch loop
LARGE_CHUNK = 5  # fast loop: 2 chunks of 5 epochs
LARGE_TIMED_CHUNKS = 3
LARGE_ROUNDS = 2  # visits of each plan in the large epoch timing
BIG_CALLS, BIG_REPLAYS = 5, 4  # _time_ms at the large graph's shapes
# the SpMM path: full width (the --f default of benchmarks/bench_kernels.py,
# and h*f = 4*32 of benchmarks/bench_large.py), and a panel cap at 524k that
# makes the overflow pass run
SPMM_L = 128
SPMM_P_MAX = 8
# the BCSR path: the preset widths (heads, features) of each graph's layers
# (Pubmed's layer 1 and, at the Pubmed preset's 8 output heads, its output
# layer; the 524k graph and the hub graph have the Cora preset's layer 1),
# and the preset's dropout rate
BCSR_WIDTHS = {"cora": ((8, 8), (1, 7)), "pubmed": ((8, 8), (8, 3)),
               "large": ((8, 8),), "hub": ((8, 8),)}
BCSR_P = 0.6
# route vs route: the fused route's analytic backward (stream sums with
# atomics, S[i] from the forward's output) against autograd of the segment
# ops, as tests/test_torch_bcsr.py holds the gradients to the JAX package's
BCSR_GRAD_RTOL = 5e-5
# the PPI path: the preset's distinct (heads, features) of its layers (4 x
# 256 twice, 6 x 121), the epochs of each CLI run, the epochs timed after a
# warm-up one, and the phase's budget on the card
PPI_WIDTHS = ((4, 256), (6, 121))
PPI_EPOCHS = 2
PPI_TIMED_EPOCHS = 3
PPI_BUDGET_S = 90.0
REPLACES = {"stream_scatter": "pygat_tpu/ops/stream.py:153",
            "corner_permute": "pygat_tpu/ops/corner.py:216",
            "fused_v1_window": "pygat_tpu/ops/fused_stream.py:134",
            "fused_v2_window": "pygat_tpu/ops/fused_stream.py:207",
            "fused_v1": "pygat_tpu/ops/fused_stream.py:134",
            "fused_v2": "pygat_tpu/ops/fused_stream.py:207",
            "expand": "pygat_tpu/ops/large.py:47",
            "banded_take": "pygat_tpu/ops/banded.py:314",
            "banded_sender_sum": "pygat_tpu/ops/banded.py:411",
            "fused_v1_banded": "pygat_tpu/ops/banded.py:978",
            "fused_v2_banded": "pygat_tpu/ops/banded.py:1046",
            "spmm_banded": "pygat_tpu/ops/banded.py:744",
            "panel_spmm": "pygat_tpu/ops/panel.py:141",
            "bcsr_attention": "tests/legacy_bcsr/fused_attention.py:55"}


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


def _scatter_call(case, g, fn, **kw):
    """One call of ``fn`` on ``case``'s side of ``g``: ``stream_scatter``
    over the side's walk (the receiver stream's, or the CSC stream's by the
    slot map), or its plain version with ``kw`` (``f64``)."""
    if fn.__name__ == "stream_scatter":
        kw = dict(kw, walk=(g.stream_walk if case["side"] == "recv"
                            else g.sender_walk))
    if case["side"] == "recv":
        return fn(case["data"], g.r_local, g.r_chunk, g.num_nodes_padded,
                  **kw)
    return fn(case["data"], g.c_local, g.c_chunk, g.num_nodes_padded,
              slot=g.c_slot, **kw)


def _stream_kernel_cases(name, g, heads, feats, gen, fused, kernel_cases):
    """The receiver stream's kernels at one graph's layer widths against
    their plain versions: the segment sums of :func:`_scatter_cases` over
    the graph's walks to KERNEL_RTOL of the same sums over |data| (their
    plain version in f64), the fused forwards over the graph's walk to
    KERNEL_RTOL of their largest output (their plain versions in f64);
    each, called again, equal bit for bit. Appends each case to
    ``kernel_cases``."""
    import torch

    from pygat_tpu_torch.ops.stream import stream_scatter, stream_scatter_plain

    for case in _scatter_cases(name, g, heads, feats, gen):
        got = _scatter_call(case, g, stream_scatter)
        want = _scatter_call(case, g, stream_scatter_plain, f64=True)
        mag = _scatter_call(dict(case, data=case["data"].abs()), g,
                            stream_scatter_plain)
        again = _scatter_call(case, g, stream_scatter)
        torch.cuda.synchronize()
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("kernel output is not finite")
        diff = (got - want).abs()
        err = float(diff.max())
        worst = float((diff / (KERNEL_RTOL * mag + 1e-30)).max())
        repeat = torch.equal(got, again)
        case.update(max_abs_err=err, bitwise_repeat=repeat)
        print(f"  stream_scatter {name} {case['path']} {case['side']} "
              f"L={case['L']}: max_abs_err {err:.3e}, worst element at "
              f"{worst:.3f} of its allowance; a second call "
              f"{'' if repeat else 'NOT '}equal bit for bit")
        if worst > 1.0 or not repeat:
            raise AssertionError("stream_scatter disagrees with its plain version")
        kernel_cases["stream_scatter"].append(case)
        del got, want, mag, diff, again
    for kname, (kernel, plain, make_inputs) in fused.items():
        for h, f in zip(heads, feats):
            args = make_inputs(g, h, f, gen)
            out, den = kernel(*args, walk=g.stream_walk)
            out_p, den_p = plain(*args, f64=True)
            torch.cuda.synchronize()
            e1, a1 = _max_err(out, out_p)
            e2, a2 = _max_err(den, den_p)
            again = kernel(*args, walk=g.stream_walk)
            repeat = torch.equal(out, again[0]) and torch.equal(den, again[1])
            print(f"  {kname} {name} H={h} F={f}: max_abs_err out {e1:.3e} "
                  f"(allowed {a1:.3e}), den {e2:.3e} (allowed {a2:.3e}); a "
                  f"second call {'' if repeat else 'NOT '}equal bit for bit")
            if e1 > a1 or e2 > a2 or not repeat:
                raise AssertionError(f"{kname} disagrees with its plain version")
            kernel_cases[kname].append(dict(
                dataset=name, H=h, F=f, args=args, max_abs_err=max(e1, e2),
                bitwise_repeat=repeat, n_live=int((g.r_local < 128).sum())))


def _time_scatter(case, g):
    """Time a segment-sum case of :func:`_scatter_cases` over ``g``'s
    walks: the kernel, its plain version, ``index_add_`` and the byte
    bound, into ``case``."""
    import torch

    from pygat_tpu_torch.ops.stream import stream_scatter, stream_scatter_plain

    kw = (dict(calls=BIG_CALLS, replays=BIG_REPLAYS)
          if case["dataset"] == "large" else {})
    n_pad, width = g.num_nodes_padded, case["L"]
    case["ms"] = _time_ms(lambda: _scatter_call(case, g, stream_scatter), **kw)
    case["plain_ms"] = _time_ms(
        lambda: _scatter_call(case, g, stream_scatter_plain), **kw)
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
        lambda: lib_out.index_add_(0, idx, case["data"]), **kw)
    del idx, lib_out
    idx_words = g.r_local.numel() + g.r_chunk.numel() + (
        g.c_slot.numel() if case["side"] == "send" else 0)
    n_bytes = 4 * (case["n_live"] * width + idx_words + n_pad * width)
    case["bound_ms"], case["bound_by"] = _bound(n_bytes, case["n_live"] * width)
    print(f"  stream_scatter {case['dataset']} {case['path']} "
          f"{case['side']} L={width}: "
          f"{case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
          f"index_add_ {case['library_ms']:.4f} ms, bound "
          f"{case['bound_ms']:.5f} ms ({case['bound_by']})")


def _time_fused(kname, kernel, plain, case, g):
    """Time a fused-forward case of :func:`_stream_kernel_cases` over
    ``g``'s walk: the kernel, its plain version and the byte bound, into
    ``case`` (no one PyTorch call computes it)."""
    args = case["args"]
    kw = (dict(calls=BIG_CALLS, replays=BIG_REPLAYS)
          if case["dataset"] == "large" else {})
    n_pad, h, f = g.num_nodes_padded, case["H"], case["F"]
    case["ms"] = _time_ms(lambda: kernel(*args, walk=g.stream_walk), **kw)
    case["plain_ms"] = _time_ms(lambda: plain(*args), **kw)
    case["library_ms"] = None
    n_live = case["n_live"]
    index_words = 2 * g.num_edges_padded + g.r_chunk.numel()
    if kname == "fused_v1":
        n_bytes = 4 * (n_pad * h * f + 2 * n_pad * h + h * f
                       + n_live * h + index_words
                       + n_pad * (h * f + h))
        n_flops = n_live * (4 * h * f + 6 * h)
    else:
        # each input once: the node tables whi and whj (their gathered rows
        # are re-read from L2, not from memory), ub, a, a live slot's keep
        # factors, the index words; out and den written
        n_bytes = 4 * (2 * n_pad * h * f + n_pad * h + h * f
                       + n_live * h + index_words
                       + n_pad * (h * f + h))
        n_flops = n_live * (6 * h * f + 6 * h)
    case["bound_ms"], case["bound_by"] = _bound(n_bytes, n_flops)
    print(f"  {kname} {case['dataset']} H={h} F={f}: "
          f"{case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
          f"bound {case['bound_ms']:.5f} ms ({case['bound_by']})")


def _tail(g, plan, e, h, gen):
    """Keep factors of dropout 0.6 over ``e`` slots, then the edge order's
    arguments: the receiver stream of ``g``, or the band ``plan``."""
    import torch

    keepq = torch.where(torch.rand(e, h, generator=gen, device="cuda") < 0.4,
                        1.0 / 0.4, 0.0)
    if plan is not None:
        return (keepq, plan, 0.2)
    return (keepq, g.senders, g.r_local, g.r_chunk, 0.2)


def _fused_inputs(g, h, f, gen, plan=None):
    """wh, f_dst, the bound as the GATv1 layer builds it, a_src, then
    :func:`_tail`."""
    import torch

    from pygat_tpu_torch.ops.fused_stream import leaky_relu

    n = g.num_nodes_padded
    e = g.num_edges_padded if plan is None else plan.num_slots
    wh = torch.randn(n, h * f, generator=gen, device="cuda") * 0.5
    a = torch.randn(h, 2 * f, generator=gen, device="cuda") * 0.5
    wh3 = wh.view(n, h, f)
    f_dst = torch.einsum("nho,ho->nh", wh3, a[:, :f]).contiguous()
    f_src = torch.einsum("nho,ho->nh", wh3, a[:, f:])
    m_src = torch.where(g.node_mask[:, None], f_src, float("-inf")).amax(0)
    bound = leaky_relu(f_dst + m_src[None], 0.2).contiguous()
    return (wh, f_dst, bound, a[:, f:].contiguous()) + _tail(g, plan, e, h, gen)


def _fused_v2_inputs(g, h, f, gen, plan=None):
    """whi, whj, the sign-split bound ub as the layer builds it, a, then
    :func:`_tail`."""
    import torch

    from pygat_tpu_torch.ops.fused_stream import leaky_relu

    n = g.num_nodes_padded
    e = g.num_edges_padded if plan is None else plan.num_slots
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
    return (whi, whj, ub, a) + _tail(g, plan, e, h, gen)


def _card_vs_cpu(label, cfg, x, graph, plan=None):
    """Forward and gradients of the model ``cfg`` on the card against the
    same model on the CPU (kernels against plain versions, end to end),
    the loss summing sin of the outputs of the graph's real rows, over the
    band plan or the corner plans ``plan`` when one is given."""
    import torch

    from pygat_tpu_torch.models.gat import apply_gat, init_gat, parameters
    from pygat_tpu_torch.utils.platform import make_generator

    results = {}
    for dev in ("cuda", "cpu"):
        params = init_gat(cfg, make_generator("cpu", 72), device=dev)
        gd = graph.to(dev)
        out = apply_gat(params, cfg, x.to(dev), gd, None, train=False,
                        plans=None if plan is None else plan.to(dev))
        torch.sin(out[gd.node_mask]).sum().backward()
        results[dev] = (out.detach().cpu(),
                        [p.grad.detach().cpu() for p in parameters(params)])
    out_c, grads_c = results["cuda"]
    out_p, grads_p = results["cpu"]
    if not bool(torch.isfinite(out_c).all()):
        raise AssertionError("model output on the card is not finite")
    scale = max(1.0, float(out_p.abs().max()))
    err = float((out_c - out_p).abs().max())
    print(f"{label}, forward card vs CPU: max_abs_err "
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


def _fused_v2_exact_inputs(g, h, f, gen):
    """:func:`_fused_v2_inputs` over the receiver stream, with each row's
    exact largest logit as ub: at F = 121 and 256 the layer's sign-split
    bound lies so far above the logits of random tables that every
    numerator underflows and the comparison would hold nothing."""
    import torch

    from pygat_tpu_torch.ops.fused_stream import leaky_relu, stream_receivers

    whi, whj, _, a, *tail = _fused_v2_inputs(g, h, f, gen)
    n, e = g.num_nodes_padded, g.num_edges_padded
    rcv, snd = stream_receivers(g.r_local, g.r_chunk), g.senders.long()
    logits = (leaky_relu(whi[rcv] + whj[snd], 0.2).view(e, h, f) * a).sum(-1)
    logits = torch.where((g.r_local < 128)[:, None], logits, float("-inf"))
    ub = torch.full((n, h), float("-inf"), device=whi.device).scatter_reduce(
        0, rcv[:, None].expand(e, h), logits, "amax")
    ub = torch.where(torch.isfinite(ub), ub, 0.0).contiguous()
    return (whi, whj, ub, a, *tail)


def _model_card_vs_cpu(layer_type, cora, plan=None):
    """:func:`_card_vs_cpu` of the Cora model over the receiver stream, or
    over the band plan or the corner plans ``plan``; returns its config."""
    from pygat_tpu_torch.models.gat import GATConfig
    from pygat_tpu_torch.ops.banded import BandPlan
    from pygat_tpu_torch.models.presets import PRESETS

    cfg = GATConfig(layer_type=layer_type, **PRESETS["cora"])
    cfg = cfg._replace(nfeats=(int(cora.features.shape[1]),) + cfg.nfeats[1:])
    over = ("receiver stream" if plan is None else
            f"band plan (w={plan.w})" if isinstance(plan, BandPlan) else
            f"corner plans ({len(plan.fwd.passes)} + {len(plan.inv.passes)} "
            "passes)")
    _card_vs_cpu(f"phase 3: Cora {layer_type} over the {over}", cfg,
                 cora.features, cora.graph, plan)
    return cfg


def _train_cli(argv, epochs, counters, jsonl, ppi=False):
    """One run of the trainer CLI on CUDA (``cli.train``, or with ``ppi``
    ``cli.train_ppi``) with every launch counter set to 0 just before and
    read just after. Returns (the wrappers' launch counts, train losses,
    the CUDA graph replays the CLI reported, the launches one replay holds
    by kernel name, the CLI's standard output)."""
    if ppi:
        from pygat_tpu_torch.cli.train_ppi import main as train_main
    else:
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
    kind = "ppi_epoch" if ppi else "epoch"
    losses = [r["loss_train"] for r in recs if r["kind"] == kind]
    if len(losses) != epochs or not all(math.isfinite(v) for v in losses):
        raise AssertionError("train losses missing or not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError("training loss did not fall")
    m = re.search(r"CUDA graph replays: (\d+), each launching (\{.*\})",
                  text.getvalue())
    if m is None:
        return launches, losses, 0, dict.fromkeys(counters, 0), text.getvalue()
    return (launches, losses, int(m.group(1)), json.loads(m.group(2)),
            text.getvalue())


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


def _slot_rows(plan, side):
    """[E_b] int64 node row of every banded slot, its receiver (``recv``)
    or its sender (``send``), and N_pad at dead slots: the index of the
    library calls."""
    import torch

    from pygat_tpu_torch.ops.banded import banded_senders

    if side == "send":
        return banded_senders(plan, plan.n_pad)
    rows = plan.r_chunk.long().repeat_interleave(256) * 128 + plan.r_local.long()
    return torch.where(plan.r_local < 128, rows, plan.n_pad)


def _banded_cases(label, g, plan, heads, feats, gen):
    """The calls one train step of each model makes over ``plan``, per
    layer, with inputs of their shapes: the fused forward, and in the
    backward banded_take of the sender rows (GATv1: wh, L = HF; GATv2:
    [whj | whi], 2HF), one expand of the receiver operands (GATv1: [f_dst |
    bound | g_out | g_den], 3H + HF; GATv2: [whi | ub | g_out | g_den],
    2HF + 2H), stream_scatter per receiver (GATv1: H; GATv2: HF) and
    banded_sender_sum per sender (GATv1: HF; GATv2: 2HF)."""
    import torch

    live = (plan.r_local < 128)[:, None]
    cases = []
    for path, make in (("v1", _fused_inputs), ("v2", _fused_v2_inputs)):
        for h, f in zip(heads, feats):
            hf = h * f
            base = dict(dataset=label, path=path, H=h, F=f,
                        n_live=int(live.sum()))
            cases.append(dict(base, kernel=f"fused_{path}_banded",
                              args=make(g, h, f, gen, plan)))
            widths = (dict(banded_take=hf, expand=3 * h + hf,
                           stream_scatter=h, banded_sender_sum=hf)
                      if path == "v1" else
                      dict(banded_take=2 * hf, expand=2 * hf + 2 * h,
                           stream_scatter=hf, banded_sender_sum=2 * hf))
            for kname, width in widths.items():
                rows = plan.n_pad if kname in ("banded_take", "expand") else (
                    plan.num_slots)
                data = torch.randn(rows, width, generator=gen, device="cuda")
                if kname == "stream_scatter":
                    data = data * live  # the backward's rows are 0 there
                cases.append(dict(base, kernel=kname, L=width, data=data))
    return cases


def _banded_call(case, plan, plain=False, f64=False):
    """One call of ``case``'s kernel (or its plain version, for a fused
    forward or a segment sum evaluated in f64 with ``f64``) over ``plan``:
    ``stream_scatter`` over the plan's receiver walk, as the banded
    backward calls it."""
    from pygat_tpu_torch.ops import banded, large, stream

    k = case["kernel"]
    kw = {"f64": True} if f64 else {}
    if k == "expand":
        fn = large.expand_plain if plain else large.expand
        return fn(case["data"], plan.r_local, plan.r_chunk)
    if k == "stream_scatter":
        if not plain:
            return banded._receiver_sum(case["data"], plan)
        return stream.stream_scatter_plain(case["data"], plan.r_local,
                                           plan.r_chunk, plan.n_pad, **kw)
    fn = getattr(banded, k + ("_plain" if plain else ""))
    if k == "banded_take":
        return fn(case["data"], plan)
    if k == "banded_sender_sum":
        return fn(case["data"], plan, **kw)
    return fn(*case["args"], **kw)


def _check_banded(case, plan):
    """``case``'s kernel against its plain version: the gathers bit-exact,
    the segment sums to KERNEL_RTOL of the same sums over |data| (their
    plain versions in f64; the sender sum's data on dead slots too), the
    fused forward to KERNEL_RTOL of its largest output (its plain version
    in f64); the segment sums and the fused forward, called again, equal
    bit for bit."""
    import torch

    k = case["kernel"]
    got = _banded_call(case, plan)
    want = _banded_call(case, plan, plain=True,
                        f64=k not in ("expand", "banded_take"))
    torch.cuda.synchronize()
    if k in ("expand", "banded_take"):
        err = float((got - want).abs().max())
        note = "bit-exact" if torch.equal(got, want) else "NOT bit-exact"
        ok = torch.equal(got, want)
    elif k in ("stream_scatter", "banded_sender_sum"):
        mag = _banded_call(dict(case, data=case["data"].abs()), plan,
                           plain=True)
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{k} output is not finite")
        diff = (got - want).abs()
        err = float(diff.max())
        worst = float((diff / (KERNEL_RTOL * mag + 1e-30)).max())
        case["bitwise_repeat"] = torch.equal(got, _banded_call(case, plan))
        note = (f"worst element at {worst:.3f} of its allowance; a second "
                "call " + ("equal bit for bit" if case["bitwise_repeat"]
                           else "NOT equal bit for bit"))
        ok = worst <= 1.0 and case["bitwise_repeat"]
    else:
        (out, den), (out_p, den_p) = got, want
        e1, a1 = _max_err(out, out_p)
        e2, a2 = _max_err(den, den_p)
        err = max(e1, e2)
        again = _banded_call(case, plan)
        case["bitwise_repeat"] = (torch.equal(out, again[0])
                                  and torch.equal(den, again[1]))
        note = (f"out {e1:.3e} (allowed {a1:.3e}), den {e2:.3e} (allowed "
                f"{a2:.3e}); a second call "
                + ("equal bit for bit" if case["bitwise_repeat"]
                   else "NOT equal bit for bit"))
        ok = e1 <= a1 and e2 <= a2 and case["bitwise_repeat"]
    case["max_abs_err"] = err
    shape = f"H={case['H']} F={case['F']}" + (
        f" L={case['L']}" if "L" in case else "")
    print(f"  {k} {case['dataset']} {case['path']} {shape}: max_abs_err "
          f"{err:.3e}, {note}")
    if not ok:
        raise AssertionError(f"{k} disagrees with its plain version")


def _time_banded(case, plan, big):
    """Device ms of ``case``'s kernel, its plain version and, where one
    PyTorch call computes the same function, that call; and the bound:
    each input read once (a node table once, the edge data of live slots
    only), each output written once, over the card's memory rate."""
    import torch

    kw = dict(calls=BIG_CALLS, replays=BIG_REPLAYS) if big else {}
    k = case["kernel"]
    n, e, c = plan.n_pad, plan.num_slots, plan.num_chunks
    n_live = case["n_live"]
    case["ms"] = _time_ms(lambda: _banded_call(case, plan), **kw)
    case["plain_ms"] = _time_ms(lambda: _banded_call(case, plan, plain=True),
                                **kw)
    case["library_ms"] = None
    if k in ("expand", "banded_take"):
        width = case["L"]
        # index_select of rows from the table with one zero row appended,
        # which the dead slots name
        idx = _slot_rows(plan, "recv" if k == "expand" else "send")
        padded = torch.cat([case["data"],
                            torch.zeros(1, width, device="cuda")])
        case["library_ms"] = _time_ms(
            lambda: torch.index_select(padded, 0, idx), **kw)
        n_bytes, n_flops = 4 * (n * width + e + c + e * width), 0
    elif k in ("stream_scatter", "banded_sender_sum"):
        width = case["L"]
        # index_add_ into a zeroed buffer with one scratch row taking the
        # dead slots
        idx = _slot_rows(plan, "recv" if k == "stream_scatter" else "send")
        lib_out = torch.zeros(n + 1, width, device="cuda")
        case["library_ms"] = _time_ms(
            lambda: lib_out.index_add_(0, idx, case["data"]), **kw)
        n_bytes = 4 * (n_live * width + e + c + n * width)
        n_flops = n_live * width
    else:
        h, f = case["H"], case["F"]
        index_words = 2 * e + 2 * c  # s_loc, r_local; band, r_chunk
        tables = 1 if k == "fused_v1_banded" else 2
        narrow = 2 if k == "fused_v1_banded" else 1
        n_bytes = 4 * (tables * n * h * f + narrow * n * h + h * f
                       + n_live * h + index_words + n * (h * f + h))
        n_flops = n_live * ((4 if tables == 1 else 6) * h * f + 6 * h)
    case["bound_ms"], case["bound_by"] = _bound(n_bytes, n_flops)
    lib = "" if case["library_ms"] is None else (
        f", library {case['library_ms']:.4f} ms")
    shape = f"H={case['H']} F={case['F']}" + (
        f" L={case['L']}" if "L" in case else "")
    print(f"  {k} {case['dataset']} {case['path']} {shape}: "
          f"{case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms{lib}, "
          f"bound {case['bound_ms']:.5f} ms ({case['bound_by']})")


def _corner_widths(heads, feats):
    """(path, width) of every turn of one train step: GATv1 turns the
    sender rows of wh forward and dgathered back, HF wide; GATv2 turns
    [whj | whi] forward and [dpre | dmsg] back, 2HF wide."""
    return ([("v1", h * f) for h, f in zip(heads, feats)]
            + [("v2", 2 * h * f) for h, f in zip(heads, feats)])


def _corner_chains(label, plans, widths, seed):
    """Every pass of both corner plans at every width, each pass fed the
    kernel's output of the pass before, from a seeded input: yields (case,
    input, pass) with the case's dataset, path, direction, pass, span,
    width and row counts."""
    import torch

    from pygat_tpu_torch.ops.corner import permute_pass

    for d, (direction, plan) in enumerate((("fwd", plans.fwd),
                                           ("inv", plans.inv))):
        for path, width in widths:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed + 1000 * d + width)
            src = torch.randn(plan.n_rows, width, generator=gen, device="cuda")
            for i, cp in enumerate(plan.passes):
                case = {"dataset": label, "path": path, "dir": direction,
                        "pass": i, "p": cp.p, "L": width,
                        "rows_in": src.shape[0],
                        "rows_out": cp.lo.shape[0] * 128}
                yield case, src, cp
                src = permute_pass(src, cp)


def _check_corner(label, plans, widths, seed):
    """``permute_pass`` against its plain version on every pass of both
    plans at every width, bit-exact. Returns the cases."""
    import torch

    from pygat_tpu_torch.ops.corner import permute_pass, permute_pass_plain

    cases = []
    for case, src, cp in _corner_chains(label, plans, widths, seed):
        got = permute_pass(src, cp)
        want = permute_pass_plain(src, cp)
        torch.cuda.synchronize()
        case["max_abs_err"] = float((got - want).abs().max())
        ok = torch.equal(got, want)
        print(f"  corner_permute {label} {case['path']} {case['dir']} pass "
              f"{case['pass']} (p {cp.p}) L={case['L']}: {case['rows_in']} -> "
              f"{case['rows_out']} rows, max_abs_err {case['max_abs_err']:.3e}, "
              f"{'bit-exact' if ok else 'NOT bit-exact'}")
        if not ok:
            raise AssertionError("corner_permute disagrees with its plain version")
        cases.append(case)
    return cases


def _time_corner(label, plans, widths, seed, cases):
    """Device ms of every pass in ``cases`` (from :func:`_check_corner`,
    the same inputs again): the kernel, its plain version, and
    ``index_select`` of the same rows (one PyTorch call computing the
    pass); the bound reads the input once and writes the output and the
    index words (g per row, lo per tile) once."""
    import torch

    from pygat_tpu_torch.ops.corner import pass_rows, permute_pass, permute_pass_plain

    kw = dict(calls=BIG_CALLS, replays=BIG_REPLAYS)
    for case, (_, src, cp) in zip(cases,
                                  _corner_chains(label, plans, widths, seed)):
        rows = pass_rows(cp)
        case["ms"] = _time_ms(lambda: permute_pass(src, cp), **kw)
        case["plain_ms"] = _time_ms(lambda: permute_pass_plain(src, cp), **kw)
        case["library_ms"] = _time_ms(
            lambda: torch.index_select(src, 0, rows), **kw)
        width, e_out = case["L"], case["rows_out"]
        n_bytes = 4 * (case["rows_in"] * width + e_out * width + e_out
                       + e_out // 128)
        case["bound_ms"], case["bound_by"] = _bound(n_bytes, 0)
        print(f"  corner_permute {label} {case['path']} {case['dir']} pass "
              f"{case['pass']} (p {case['p']}) L={width}: {case['ms']:.4f} ms, "
              f"plain {case['plain_ms']:.4f} ms, index_select "
              f"{case['library_ms']:.4f} ms, bound {case['bound_ms']:.5f} ms "
              f"({case['bound_by']})")


def _check_corner_overflow(cora, widths):
    """A Cora plan with a span cap of 3 tiles, whose passes have overflow
    rows: the whole chain with its fix-ups on the card against the same
    chain on the CPU, bit-exact (every row of it is determined by the
    input and the plan). Returns the cases."""
    import torch

    from pygat_tpu_torch.ops.corner import corner_permute
    from pygat_tpu_torch.ops.large import plan_csc_to_csr

    plans = plan_csc_to_csr(cora.graph, p_cap=3)
    cases = []
    for direction, plan in (("fwd", plans.fwd), ("inv", plans.inv)):
        overflow = [cp.n_overflow for cp in plan.passes]
        if not any(overflow):
            raise AssertionError("the span-capped Cora plan has no overflow")
        cpu_plan = plan.to("cpu")
        for path, width in widths:
            x = torch.randn(plan.n_rows, width, device="cuda")
            got = corner_permute(x, plan)
            want = corner_permute(x.cpu(), cpu_plan)
            torch.cuda.synchronize()
            err = float((got.cpu() - want).abs().max())
            ok = torch.equal(got.cpu(), want)
            print(f"  corner_permute cora, span cap 3, {path} {direction}: "
                  f"{len(plan.passes)} passes (p {[cp.p for cp in plan.passes]}"
                  f", overflow rows {overflow}) L={width}: chain card vs CPU "
                  f"max_abs_err {err:.3e}, "
                  f"{'bit-exact' if ok else 'NOT bit-exact'}")
            if not ok:
                raise AssertionError("the corner chain with fix-ups disagrees "
                                     "with its CPU run")
            cases.append({"dataset": "cora, span cap 3", "path": path,
                          "dir": direction, "L": width, "max_abs_err": err})
    return cases


def _window_cases(label, g, plans, heads, feats, gen):
    """The window forwards of one forward of each model, per layer, over
    windows that ``gather_corner`` builds from node tables and bounds as
    the layers build them, checked against their plain versions (in f64)
    to KERNEL_RTOL of their largest output and, called again, to repeat bit
    for bit. Returns the cases."""
    import torch

    from pygat_tpu_torch.ops import fused_corner as fc

    cases = []
    n_live = int((g.r_local < 128).sum())
    for h, f in zip(heads, feats):
        wh, f_dst, bound, a, keepq = _fused_inputs(g, h, f, gen)[:5]
        whi, whj, ub, a2, keepq2 = _fused_v2_inputs(g, h, f, gen)[:5]
        for name, args in (
                ("fused_v1_window",
                 (fc.gather_corner(wh, g, plans.fwd), f_dst, bound, a, keepq,
                  g.r_local, g.r_chunk, 0.2)),
                ("fused_v2_window",
                 (whi, fc.gather_corner(torch.cat([whj, whi], 1), g,
                                        plans.fwd), ub, a2, keepq2,
                  g.r_local, g.r_chunk, 0.2))):
            kernel, plain = getattr(fc, name), getattr(fc, name + "_plain")
            out, den = kernel(*args, walk=g.stream_walk)
            out_p, den_p = plain(*args, f64=True)
            torch.cuda.synchronize()
            e1, a1 = _max_err(out, out_p)
            e2, a2_ = _max_err(den, den_p)
            again = kernel(*args, walk=g.stream_walk)
            repeat = torch.equal(out, again[0]) and torch.equal(den, again[1])
            print(f"  {name} {label} H={h} F={f}: max_abs_err out {e1:.3e} "
                  f"(allowed {a1:.3e}), den {e2:.3e} (allowed {a2_:.3e}); a "
                  f"second call {'' if repeat else 'NOT '}equal bit for bit")
            if e1 > a1 or e2 > a2_ or not repeat:
                raise AssertionError(f"{name} disagrees with its plain version")
            cases.append(dict(dataset=label, kernel=name, H=h, F=f, args=args,
                              max_abs_err=max(e1, e2), bitwise_repeat=repeat,
                              n_live=n_live, n_pad=g.num_nodes_padded,
                              n_chunks=g.r_chunk.numel(),
                              walk=g.stream_walk))
            del out, den, out_p, den_p, again
    return cases


def _time_window(case, big):
    """Device ms of a window forward and its plain version, and the bound:
    each input read once (the window's live rows, the receiver-side node
    tables, a live slot's keep factors, the index words), out and den
    written once."""
    from pygat_tpu_torch.ops import fused_corner as fc

    kw = dict(calls=BIG_CALLS, replays=BIG_REPLAYS) if big else {}
    k, args = case["kernel"], case["args"]
    case["ms"] = _time_ms(lambda: getattr(fc, k)(*args, walk=case["walk"]),
                          **kw)
    case["plain_ms"] = _time_ms(lambda: getattr(fc, k + "_plain")(*args), **kw)
    case["library_ms"] = None
    h, f, n, n_live = case["H"], case["F"], case["n_pad"], case["n_live"]
    index_words = args[5].numel() + case["n_chunks"]
    if k == "fused_v1_window":
        n_bytes = 4 * (n_live * h * f + 2 * n * h + h * f + n_live * h
                       + index_words + n * (h * f + h))
        n_flops = n_live * (4 * h * f + 6 * h)
    else:
        n_bytes = 4 * (n * h * f + n_live * 2 * h * f + n * h + h * f
                       + n_live * h + index_words + n * (h * f + h))
        n_flops = n_live * (6 * h * f + 6 * h)
    case["bound_ms"], case["bound_by"] = _bound(n_bytes, n_flops)
    print(f"  {k} {case['dataset']} H={h} F={f}: {case['ms']:.4f} ms, plain "
          f"{case['plain_ms']:.4f} ms, bound {case['bound_ms']:.5f} ms "
          f"({case['bound_by']})")


def _corner_vs_stream(layer_type, cora, plans):
    """The Cora model in training mode (dropout 0.6) over the corner plans
    against the same model over the receiver stream, on the card, with
    generators of one seed: the same masks at the same sites, so forward
    and gradients agree to MODEL_RTOL."""
    import torch

    from pygat_tpu_torch.models.gat import GATConfig, apply_gat, init_gat, parameters
    from pygat_tpu_torch.models.presets import PRESETS
    from pygat_tpu_torch.utils.platform import make_generator

    cfg = GATConfig(layer_type=layer_type, **PRESETS["cora"])
    cfg = cfg._replace(nfeats=(int(cora.features.shape[1]),) + cfg.nfeats[1:])
    results = {}
    for label, p in (("corner", plans), ("stream", None)):
        params = init_gat(cfg, make_generator("cpu", 72), device="cuda")
        gen = torch.Generator(device="cuda")
        gen.manual_seed(5)
        out = apply_gat(params, cfg, cora.features, cora.graph, gen,
                        train=True, plans=p)
        torch.sin(out[: cora.num_nodes]).sum().backward()
        results[label] = (out.detach(), [q.grad for q in parameters(params)])
    (out_c, grads_c), (out_s, grads_s) = results["corner"], results["stream"]
    scale = max(1.0, float(out_s.abs().max()))
    err = float((out_c - out_s).abs().max())
    gerr = max(float((a - b).abs().max()) / max(1e-30, float(b.abs().max()))
               for a, b in zip(grads_c, grads_s))
    print(f"phase 3: Cora {layer_type}, dropout 0.6, one generator seed: "
          f"corner plans vs receiver stream on the card: forward max_abs_err "
          f"{err:.3e} (allowed {MODEL_RTOL * scale:.3e}), worst gradient "
          f"error {gerr:.3e} of its largest entry (allowed {MODEL_RTOL:.0e})")
    if not (err <= MODEL_RTOL * scale and gerr <= MODEL_RTOL):
        raise AssertionError("the corner model disagrees with the stream model")


def _want_corner(fused_name, epochs, fast, k_f, k_i):
    """The launches a corner run makes through the wrappers, and those one
    replay of the fast loop's captured epoch holds, for plans of ``k_f``
    forward and ``k_i`` inverse passes: per epoch 2 layers x (train + eval
    forward) of one expand, k_f passes and the window forward each, and per
    layer's backward the window again (expand, k_f passes), one expand of
    the receiver operands, k_i inverse passes and 2 stream_scatters; the
    test forward adds one forward per layer. The fast loop's wrappers see
    the eager warm-up epoch and the captured one."""
    per_epoch = {fused_name: 4, "expand": 8, "stream_scatter": 4,
                 "corner_permute": 6 * k_f + 2 * k_i}
    calls = 2 if fast else epochs
    wrappers = {k: v * calls for k, v in per_epoch.items()}
    for k, v in ((fused_name, 2), ("expand", 2), ("corner_permute", 2 * k_f)):
        wrappers[k] += v
    return wrappers, (per_epoch if fast else {})


BACKWARD_KERNELS = ("banded_take", "expand", "stream_scatter",
                    "banded_sender_sum")


def _want_banded(fused_name, epochs, fast):
    """The launches a banded run makes through the wrappers, and those one
    replay of the fast loop's captured epoch holds: per epoch 2 layers x
    (train forward + eval forward) fused and one call of each backward
    kernel per layer; the test forward adds 2 fused. The fast loop's
    wrappers see the eager warm-up epoch and the captured one."""
    per_epoch = {fused_name: 4, **dict.fromkeys(BACKWARD_KERNELS, 2)}
    calls = 2 if fast else epochs
    wrappers = {k: v * calls for k, v in per_epoch.items()}
    wrappers[fused_name] += 2
    return wrappers, (per_epoch if fast else {})


def _train_large(label, fit, cfg, data, counters, jsonl, corner=False, **kw):
    """One trainer run on the large graph, every launch counter set to 0
    just before and read just after. Checks that the trainer chose the band
    plan (or, with ``corner``, the corner plans) by itself, finite losses,
    a falling validation loss, and the launch counts.
    Returns (launches, train losses, result, replayed launches)."""
    from pygat_tpu_torch.models.presets import TRAIN_PRESETS
    from pygat_tpu_torch.train.logging import TrainLogger

    if os.path.exists(jsonl):
        os.remove(jsonl)
    logger = TrainLogger(jsonl_path=jsonl, stream=io.StringIO())
    for fn in counters.values():
        fn.launches = 0
    result = fit(cfg, data, **TRAIN_PRESETS["cora"], patience=100,
                 checkpoint_dir=None, logger=logger, log_every=1, **kw)
    got = {name: fn.launches for name, fn in counters.items()}
    logger.close()
    with open(jsonl) as fh:
        recs = [json.loads(line) for line in fh]
    kind = "corner_plan" if corner else "band_plan"
    plans = [r for r in recs if r["kind"] == kind]
    if len(plans) != 1:
        raise AssertionError(f"{label}: the trainer chose no {kind}")
    losses = [r["loss_train"] for r in recs if r["kind"] == "epoch"]
    val = [r["loss_val"] for r in recs if r["kind"] == "epoch"]
    epochs = kw["epochs"]
    print(f"phase 4: {label}: train losses {losses}; validation losses "
          f"{val}", flush=True)
    if len(losses) != epochs or not all(math.isfinite(v)
                                        for v in losses + val):
        raise AssertionError(f"{label}: losses missing or not finite")
    # the graph's train split (its first tenth of nodes) holds one label,
    # so under dropout 0.6 the training loss starts near ln 4 at high
    # training accuracy and moves with the masks for the first epochs; the
    # eval-mode validation loss is the learning signal that must fall
    if not val[-1] < val[0]:
        raise AssertionError(f"{label}: validation loss did not fall")
    fast = "epoch_chunk" in kw
    if corner:
        fused_name = "fused_v2_window" if cfg.is_v2 else "fused_v1_window"
        k_f, k_i = plans[0]["passes"]
        want, want_captured = _want_corner(fused_name, epochs, fast, k_f, k_i)
        chosen = (f"corner plans chosen by the trainer: {plans[0]['rows']} "
                  f"rows, spans {plans[0]['p']}, overflow rows "
                  f"{plans[0]['overflow']}")
    else:
        fused_name = "fused_v2_banded" if cfg.is_v2 else "fused_v1_banded"
        want, want_captured = _want_banded(fused_name, epochs, fast)
        chosen = (f"band plan chosen by the trainer: w {plans[0]['w']}, "
                  f"{plans[0]['chunks']} chunks, {plans[0]['slots']} slots, "
                  f"fill {plans[0]['fill']:.4f}")
    captured = {k: v for k, v in result.captured_launches.items() if v}
    replays = result.graph_replays
    by_replay = {k: replays * v for k, v in captured.items()}
    print(f"phase 4: {label}: {chosen}; wrapper launches "
          f"{ {k: v for k, v in got.items() if v} }; {replays} CUDA graph "
          f"replays, each launching {captured}, so {by_replay} more by "
          f"replay", flush=True)
    if {k: v for k, v in got.items() if v} != want:
        raise AssertionError(f"{label}: wrapper launches {got}, want {want} "
                             "and no other kernel")
    if captured != want_captured or replays != (epochs if fast else 0):
        raise AssertionError(f"{label}: {replays} replays of {captured}")
    return got, losses, result, by_replay


def _cli_band(jsonl, epochs):
    """``PYGAT_BAND=on python -m pygat_tpu_torch.cli.train --dataset cora
    --model GAT_sparse`` as a subprocess: the environment knob reaches the
    banded path. Returns (the launch counts the CLI printed, train losses,
    the plan line)."""
    if os.path.exists(jsonl):
        os.remove(jsonl)
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "pygat_tpu_torch.cli.train", "--dataset",
         "cora", "--model", "GAT_sparse", "--epochs", str(epochs),
         "--no-checkpoint", "--log-every", "1", "--jsonl", jsonl],
        cwd=root, env=dict(os.environ, PYGAT_BAND="on"), capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"PYGAT_BAND=on CLI returned {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    counts = re.search(r"Kernel launches: (\{.*\})", proc.stdout)
    plan = re.search(r"band_plan: (.*)", proc.stdout)
    if counts is None or plan is None or "start training on cuda" not in proc.stdout:
        raise AssertionError("the PYGAT_BAND=on CLI did not plan, run on "
                             "CUDA or print its launches:\n" + proc.stdout[-3000:])
    with open(jsonl) as fh:
        recs = [json.loads(line) for line in fh]
    losses = [r["loss_train"] for r in recs if r["kind"] == "epoch"]
    if len(losses) != epochs or not all(math.isfinite(v) for v in losses):
        raise AssertionError("train losses missing or not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError("training loss did not fall")
    return json.loads(counts.group(1)), losses, plan.group(1)


def _large_epoch_ms(cfg, data, plans):
    """Host ms per epoch of the fast loop on the large graph over each of
    ``plans`` (name -> a band plan, corner plans, or None: the receiver
    stream). One captured epoch lives on the card at a time (two captured
    GATv2_sparse epochs at 524k with their private pools can take most of
    the 80 GB): each visit captures its plan's epoch (one warm-up chunk),
    times LARGE_TIMED_CHUNKS chunks of LARGE_CHUNK epochs and frees it; the
    plans are visited in LARGE_ROUNDS rounds, the order reversed from round
    to round. Returns the sorted samples per plan and the most memory
    allocated on the card during a visit, in GiB."""
    import torch

    from pygat_tpu_torch.tools.profile_epoch import epoch_runners

    samples = {k: [] for k in plans}
    peak = 0.0
    names = list(plans)
    for r in range(LARGE_ROUNDS):
        for k in names if r % 2 == 0 else names[::-1]:
            torch.cuda.reset_peak_memory_stats()
            chunk = epoch_runners(cfg, data, LARGE_CHUNK, plans[k])[1]
            chunk.run()  # warm-up epoch, capture, first replays
            for _ in range(LARGE_TIMED_CHUNKS):
                t0 = time.perf_counter()
                chunk.run()  # ends in the chunk's one host sync
                samples[k].append((time.perf_counter() - t0) * 1e3
                                  / LARGE_CHUNK)
            if chunk.graph_replays != LARGE_CHUNK * (LARGE_TIMED_CHUNKS + 1):
                raise AssertionError(f"the {k} fast loop did not replay its graph")
            peak = max(peak, torch.cuda.max_memory_allocated() / 2 ** 30)
            del chunk
            torch.cuda.empty_cache()
    return {k: sorted(v) for k, v in samples.items()}, peak


def _hub_graph():
    """The hub graph (``data.synthetic.hub_edges``) on the card: its hub's
    tile owns some 38 chunks of the receiver stream and of a w = 4 band
    plan, more than HEAVY_CHUNKS: the SpMM kernels split it."""
    from pygat_tpu_torch.data.synthetic import hub_edges
    from pygat_tpu_torch.graph import build_graph

    s, r, n = hub_edges()
    return build_graph(s, r, None, n, device="cuda")


def _hub_spec():
    """The hub graph (``_hub_graph``) with its band plan (w = 4) and panel
    layout, whose hub tile the SpMM kernels split: a case of the two SpMM
    kernels, not of the SpMM path (its hub row sums 9,000 terms, whose f32
    reordering between routes passes KERNEL_RTOL of max |out|)."""
    from pygat_tpu_torch.ops.banded import build_band_plan
    from pygat_tpu_torch.ops.panel import build_panel_layout

    hub = _hub_graph()
    plan, layout = build_band_plan(hub, w=4), build_panel_layout(hub)
    print(f"phase 6: hub: N_pad {hub.num_nodes_padded}; pieces of split "
          f"tiles past the first: band plan {plan.split_at.numel()} (of "
          f"{plan.num_chunks} chunks), panel layout "
          f"{layout.split_at.numel()} (of {hub.r_chunk.numel()}, P "
          f"{layout.n_panels})", flush=True)
    if not (plan.split_at.numel() and layout.split_at.numel()):
        raise AssertionError("the hub graph has no split tile")
    return dict(graph=hub, band=plan, corner=None, layouts={"hub": layout})


def _banded_values(plan, w):
    """Per-edge values ``w`` in the band plan's slot order (0 on dead
    slots), and the plan's ``perm`` on the card."""
    import torch

    perm = torch.from_numpy(plan.perm).to("cuda")
    return torch.where(perm >= 0, w[perm.clamp(min=0)], 0.0), perm


def _spmm_graphs(pubmed, large, band_plan, large_corner):
    """The graphs of the SpMM path and what each route needs: the Pubmed
    stand-in with its own corner plans and a panel layout (uniform, so P
    near its tile count), and the 524k graph with the band plan and corner
    plans of phase 3 and two panel layouts, uncapped and capped at
    SPMM_P_MAX panels (overflow slots). Returns them and the set-up seconds
    of what is built here."""
    from pygat_tpu_torch.ops.large import plan_csc_to_csr
    from pygat_tpu_torch.ops.panel import build_panel_layout

    setup, layouts = {}, {}
    t0 = time.perf_counter()
    pubmed_corner = plan_csc_to_csr(pubmed.graph)
    setup["pubmed_corner_plans"] = time.perf_counter() - t0
    print(f"phase 6: pubmed: corner plans built in "
          f"{setup['pubmed_corner_plans']:.2f} s: spans "
          f"{[cp.p for cp in pubmed_corner.fwd.passes]} / "
          f"{[cp.p for cp in pubmed_corner.inv.passes]}", flush=True)
    for name, key, g, p_max in (
            ("pubmed", "pubmed_panel_layout", pubmed.graph, None),
            ("large", "large_panel_layout", large.graph, None),
            (f"large, p_max {SPMM_P_MAX}",
             f"large_panel_layout_p{SPMM_P_MAX}", large.graph, SPMM_P_MAX)):
        t0 = time.perf_counter()
        lay = layouts[name] = build_panel_layout(g, p_max=p_max)
        setup[key] = time.perf_counter() - t0
        print(f"phase 6: {name}: panel layout P {lay.n_panels}, "
              f"{lay.n_overflow} overflow slots (fraction "
              f"{lay.overflow_frac:.4f}), built in {setup[key]:.2f} s",
              flush=True)
    specs = {
        "pubmed": dict(graph=pubmed.graph, band=None, corner=pubmed_corner,
                       layouts={"pubmed": layouts["pubmed"]}),
        "large": dict(graph=large.graph, band=band_plan, corner=large_corner,
                      layouts={k: v for k, v in layouts.items()
                               if k.startswith("large")}),
    }
    return specs, setup


def _spmm_inputs(g, seed):
    """Per-edge values (padding edges too: the ops must ignore them), node
    rows, a second node table (the SDDMM's), and cotangents, at SPMM_L."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n, e = g.num_nodes_padded, g.num_edges_padded
    return {"w": torch.randn(e, generator=gen, device="cuda"),
            "x": torch.randn(n, SPMM_L, generator=gen, device="cuda"),
            "b": torch.randn(n, SPMM_L, generator=gen, device="cuda"),
            "ct": torch.randn(n, SPMM_L, generator=gen, device="cuda"),
            "ct_e": torch.randn(e, generator=gen, device="cuda")}


def _vjp(fn, first, second, ct):
    """(output, gradient of ``first``, gradient of ``second``) for the
    cotangent ``ct``."""
    import torch

    a = first.detach().clone().requires_grad_()
    b = second.detach().clone().requires_grad_()
    out = fn(a, b)
    ga, gb = torch.autograd.grad(out, (a, b), ct)
    return out.detach(), ga, gb


def _spmm_routes(label, spec, inp):
    """(route, op of (values, x), values, launches one forward and backward
    make) of every SpMM op on graph ``label``: spmm_graph first (the route
    the others are held against), then the panel layouts with and without
    the corner backward, the corner plans, and the band plan's fused and
    two-pass forms (values permuted into banded order)."""
    import torch

    from pygat_tpu_torch import ops

    g, plans = spec["graph"], spec["corner"]
    k_f, k_i = len(plans.fwd.passes), len(plans.inv.passes)
    routes = [("spmm_graph", lambda v, d: ops.spmm_graph(v, d, g), inp["w"],
               {"stream_scatter": 2})]
    for name, lay in spec["layouts"].items():
        routes.append((f"panel_spmm_graph ({name} layout)",
                       lambda v, d, lay=lay: ops.panel_spmm_graph(v, d, g,
                                                                  lay),
                       inp["w"], {"panel_spmm": 1}))
        if name == label:
            routes.append((f"panel_spmm_graph ({name} layout, plans=)",
                           lambda v, d, lay=lay: ops.panel_spmm_graph(
                               v, d, g, lay, plans=plans), inp["w"],
                           {"panel_spmm": 1, "expand": 2,
                            "corner_permute": k_f + k_i,
                            "stream_scatter": 1}))
    routes.append(("spmm_corner_graph",
                   lambda v, d: ops.spmm_corner_graph(v, d, g, plans),
                   inp["w"], {"expand": 2, "corner_permute": k_f + k_i,
                              "stream_scatter": 2}))
    plan = spec["band"]
    if plan is not None:
        # the plan's slots hold the real edges only, which the mask keeps
        vals_b, perm = _banded_values(plan, inp["w"])
        inp["vals_b"], inp["perm"] = vals_b, perm
        routes += [
            ("spmm_banded (fused)",
             lambda v, d: ops.spmm_banded(v, d, plan), vals_b,
             {"spmm_banded": 1, "banded_take": 1, "expand": 1,
              "banded_sender_sum": 1}),
            ("spmm_banded (two-pass)",
             lambda v, d: ops.spmm_banded(v, d, plan, fused=False), vals_b,
             {"banded_take": 2, "stream_scatter": 1, "expand": 1,
              "banded_sender_sum": 1})]
    return routes


def _held(got, want):
    """(max |got - want|, KERNEL_RTOL * max(1, max |want|), within)."""
    err, allowed = _max_err(got, want)
    return err, allowed, err <= allowed


def _spmm_path(specs, inputs, counters):
    """The SpMM path: every op of the family, forward and backward (the
    gradients of the values and of the node rows), at SPMM_L on each graph,
    through the entry points a user calls. Each op's outputs and gradients
    are held against the plain SpMM (``ops.spmm``: row gathers and
    ``index_add_``, on the card) and against spmm_graph's, to KERNEL_RTOL
    of max(1, max |want|); each call's launches (forward and backward) must
    be as the route states. ``sddmm_graph`` is held against ``ops.sddmm``.
    Returns the route errors for the kernels line."""
    import torch

    from pygat_tpu_torch import ops

    errors = {}
    for label, spec in specs.items():
        g, inp = spec["graph"], inputs[label]
        w, x, ct = inp["w"], inp["x"], inp["ct"]
        plain = _vjp(lambda v, d: ops.spmm(v, d, g.senders, g.receivers,
                                           g.edge_mask), w, x, ct)
        ref = None
        for route, fn, vals, want in _spmm_routes(label, spec, inp):
            before = {k: f.launches for k, f in counters.items()}
            got = _vjp(fn, vals, x, ct)
            torch.cuda.synchronize()
            made = {k: f.launches - before[k] for k, f in counters.items()
                    if f.launches != before[k]}
            if vals is not w:  # banded order: the values' gradient to edges
                live = inp["perm"] >= 0
                dv = torch.zeros_like(w).index_put_(
                    (inp["perm"][live],), got[1][live])
                got = (got[0], dv, got[2])
            ref = got if ref is None else ref
            checks = [(what, _held(a, b)) for what, a, b in (
                ("out vs plain", got[0], plain[0]),
                ("d values vs plain", got[1], plain[1]),
                ("d x vs plain", got[2], plain[2]),
                ("out vs spmm_graph", got[0], ref[0]),
                ("d values vs spmm_graph", got[1], ref[1]),
                ("d x vs spmm_graph", got[2], ref[2]))]
            errors[f"{label} {route}"] = max(c[1][0] for c in checks)
            print(f"  {label} {route}: launches {made}; " + "; ".join(
                f"{what} {e:.3e} (allowed {a:.3e})"
                for what, (e, a, _) in checks), flush=True)
            if made != want:
                raise AssertionError(f"{label} {route}: launches {made}, "
                                     f"want {want}")
            if not all(ok for _, (_, _, ok) in checks):
                raise AssertionError(f"{label} {route} disagrees")
            del got
        # the SDDMM, held against the plain one
        before = {k: f.launches for k, f in counters.items()}
        got = _vjp(lambda p, q: ops.sddmm_graph(p, q, g), x, inp["b"],
                   inp["ct_e"])
        torch.cuda.synchronize()
        made = {k: f.launches - before[k] for k, f in counters.items()
                if f.launches != before[k]}
        want = _vjp(lambda p, q: ops.sddmm(p, q, g.senders, g.receivers,
                                           g.edge_mask), x, inp["b"],
                    inp["ct_e"])
        checks = [_held(a, b) for a, b in zip(got, want)]
        errors[f"{label} sddmm_graph"] = max(c[0] for c in checks)
        print(f"  {label} sddmm_graph: launches {made}; out, d a, d b vs "
              f"plain " + ", ".join(f"{e:.3e} (allowed {a:.3e})"
                                    for e, a, _ in checks), flush=True)
        if made != {"stream_scatter": 2} or not all(c[2] for c in checks):
            raise AssertionError(f"{label} sddmm_graph disagrees or launched "
                                 f"{made}")
        del plain, ref, got, want
    return errors


def _library_csr(g, w):
    """``torch.sparse_csr_tensor`` of the graph weighted by ``w`` (its live
    edges, repeated edges summed, as CSR needs one entry per row and
    column), built once outside the timing: ``torch.sparse.mm`` of it
    computes the SpMM."""
    import torch

    live = g.edge_mask
    n = g.num_nodes_padded
    coo = torch.sparse_coo_tensor(
        torch.stack([g.receivers[live].long(), g.senders[live].long()]),
        w[live], size=(n, n)).coalesce()
    return coo.to_sparse_csr()


def _spmm_kernel_cases(specs, inputs):
    """Rows 7 and 9 at the shapes of the SpMM path (the 524k band plan; the
    Pubmed layout and both 524k layouts; the hub graph's band plan and
    layout), each held against its plain version on the same inputs to
    KERNEL_RTOL of max(1, max |plain|), and called twice: the two results
    must agree bit for bit. The hub's row sums 9,000 terms, whose f32
    reordering moves it by up to some 4e-5 of its value, so the hub is held
    to KERNEL_RTOL of the same sums over |values| and |x| elementwise (the
    segment-sum rule of phase 3)."""
    import torch

    from pygat_tpu_torch import ops
    from pygat_tpu_torch.ops.banded import (
        banded_weighted_sum,
        banded_weighted_sum_plain,
    )
    from pygat_tpu_torch.ops.panel import (
        panel_weighted_sum,
        panel_weighted_sum_plain,
    )

    cases = []
    for label, spec in specs.items():
        g, inp = spec["graph"], inputs[label]
        lib = _library_csr(g, inp["w"])
        plan = spec["band"]
        if plan is not None:
            n_live = int((plan.s_loc < plan.w * 128).sum())
            cases.append(dict(
                kernel="spmm_banded", dataset=label, L=SPMM_L, n_live=n_live,
                run=lambda plan=plan, inp=inp: banded_weighted_sum(
                    inp["vals_b"], inp["x"], plan),
                plain=lambda plan=plan, inp=inp: banded_weighted_sum_plain(
                    inp["vals_b"], inp["x"], plan),
                ops={"op": lambda plan=plan, inp=inp: ops.spmm_banded(
                         inp["vals_b"], inp["x"], plan),
                     "two_pass": lambda plan=plan, inp=inp: ops.spmm_banded(
                         inp["vals_b"], inp["x"], plan, fused=False)},
                mag=lambda plan=plan, inp=inp: banded_weighted_sum_plain(
                    inp["vals_b"].abs(), inp["x"].abs(), plan),
                lib=lib, x=inp["x"], split_at=plan.split_at.numel(),
                n_bytes=4 * (3 * plan.num_slots + 2 * plan.num_chunks
                             + 2 * plan.n_pad * SPMM_L)))
        for name, lay in spec["layouts"].items():
            args = (lay.panel_tiles, lay.g_idx, g.edge_mask, g.r_local,
                    g.r_chunk, lay.tile_ptr, lay.split_at)
            fits = ((lay.g_idx < lay.n_panels * 128) & (g.r_local < 128)
                    & g.edge_mask)
            e_s = g.num_edges_padded
            cases.append(dict(
                kernel="panel_spmm", dataset=name, L=SPMM_L, P=lay.n_panels,
                n_live=int(fits.sum()),
                run=lambda args=args, inp=inp: panel_weighted_sum(
                    inp["w"], inp["x"], *args),
                plain=lambda args=args, inp=inp: panel_weighted_sum_plain(
                    inp["w"], inp["x"], *args),
                mag=lambda args=args, inp=inp: panel_weighted_sum_plain(
                    inp["w"].abs(), inp["x"].abs(), *args),
                ops={"op": lambda g=g, lay=lay, inp=inp: ops.panel_spmm_graph(
                         inp["w"], inp["x"], g, lay),
                     "spmm_graph": lambda g=g, inp=inp: ops.spmm_graph(
                         inp["w"], inp["x"], g)},
                lib=lib, x=inp["x"], split_at=lay.split_at.numel(),
                n_bytes=(4 * (3 * e_s + g.r_chunk.numel()
                              + lay.panel_tiles.numel()
                              + 2 * g.num_nodes_padded * SPMM_L) + e_s)))
    for case in cases:
        got, again, want = case["run"](), case["run"](), case["plain"]()
        mag = case.pop("mag")()
        torch.cuda.synchronize()
        err, allowed = _max_err(got, want)
        worst = float(((got - want).abs()
                       / (KERNEL_RTOL * mag + 1e-30)).max())
        case["max_abs_err"] = err
        case["bitwise_repeat"] = bool(torch.equal(got, again))
        shape = f"L={SPMM_L}" + (f" P={case['P']}" if "P" in case else "")
        print(f"  {case['kernel']} {case['dataset']} {shape} ({case['split_at']} "
              f"extra pieces of split tiles): kernel vs plain max_abs_err "
              f"{err:.3e} (allowed {allowed:.3e}), worst element at "
              f"{worst:.3f} of its segment-sum allowance; two calls equal "
              f"bit for bit: {case['bitwise_repeat']}", flush=True)
        held = worst <= 1.0 if case["dataset"] == "hub" else err <= allowed
        if not held:
            raise AssertionError(f"{case['kernel']} disagrees with its plain "
                                 "version")
        if not case["bitwise_repeat"]:
            raise AssertionError(f"{case['kernel']}: two calls on the same "
                                 "inputs differ")
        del got, again, want, mag
    return cases


def _time_spmm(case):
    """Device ms of a SpMM kernel, its plain version and ``torch.sparse.mm``
    of the same weighted graph (CSR, built once), and the bound: each input
    read once (the values, index words and mask per slot, the tile ranges,
    the node table),
    the output written once, over the card's memory rate; two FLOPs per
    live slot and column. Beside them, the forward of the op around the
    kernel (``op_ms``: with a capped layout, the kernel and the overflow
    pass) and of the route it is an alternative to (the banded two-pass
    form, ``two_pass_ms``; the receiver stream, ``spmm_graph_ms``)."""
    import torch

    big = case["dataset"].startswith("large")
    kw = dict(calls=BIG_CALLS, replays=BIG_REPLAYS) if big else {}
    case["ms"] = _time_ms(case["run"], **kw)
    case["plain_ms"] = _time_ms(case["plain"], **kw)
    lib, x = case["lib"], case["x"]
    case["library_ms"] = _time_ms(lambda: torch.sparse.mm(lib, x), **kw)
    for name, fn in case["ops"].items():
        case[f"{name}_ms"] = _time_ms(fn, **kw)
    case["bound_ms"], case["bound_by"] = _bound(
        case["n_bytes"], 2 * case["n_live"] * case["L"])
    shape = f"L={case['L']}" + (f" P={case['P']}" if "P" in case else "")
    print(f"  {case['kernel']} {case['dataset']} {shape}: {case['ms']:.4f} "
          f"ms, plain {case['plain_ms']:.4f} ms, torch.sparse.mm "
          f"{case['library_ms']:.4f} ms, bound {case['bound_ms']:.5f} ms "
          f"({case['bound_by']}); forward of " + ", ".join(
              f"{name} {case[f'{name}_ms']:.4f} ms" for name in case["ops"]),
          flush=True)
    for k in ("run", "plain", "lib", "x", "ops"):
        case.pop(k)


def _bcsr_tilings(graphs):
    """Each graph's BCSR tiling, built once with its walk; returns the
    tilings and their set-up seconds: the tiling's (the walk included),
    and the walk's alone, built again from the tiling's tensors."""
    import torch

    from pygat_tpu_torch.legacy_bcsr.tiles import (
        attach_walk,
        tile_graph,
        tile_stats,
    )

    tilings, secs = {}, {}
    for label, g in graphs.items():
        t0 = time.perf_counter()
        tilings[label] = tile_graph(g)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        walk = attach_walk(tilings[label])
        torch.cuda.synchronize()
        secs[f"{label}_bcsr_tiling"] = t1 - t0
        secs[f"{label}_bcsr_walk"] = time.perf_counter() - t1
        st = tile_stats(tilings[label])
        print(f"phase 7: {label}: BCSR tiling in "
              f"{secs[f'{label}_bcsr_tiling']:.2f} s: {st['chunks']} chunks, "
              f"{st['edge_slots']} slots, {st['real_edges']} real edges, "
              f"utilization {st['utilization']:.4f}; its walk alone "
              f"{secs[f'{label}_bcsr_walk']:.2f} s: {walk.rows.numel()} "
              f"positions, {walk.stream.split_at.numel()} extra pieces, "
              f"longest run {walk.stream.max_run}", flush=True)
    return tilings, secs


def _bcsr_inputs(g, h, f, seed):
    """f_dst, f_src [H, N_pad], wh [H, N_pad, F] and a cotangent of the
    output, from ``seed``."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    n = g.num_nodes_padded
    return (torch.randn(h, n, generator=gen, device="cuda"),
            torch.randn(h, n, generator=gen, device="cuda"),
            torch.randn(h, n, f, generator=gen, device="cuda"),
            torch.randn(h, n, f, generator=gen, device="cuda"))


def _bcsr_path(graphs, tilings, counters):
    """The BCSR path: ``gat_attention_v1`` by the fused route against the
    segment-op route, forward and the gradients of f_dst, f_src and wh, at
    the Cora and Pubmed preset widths, with dropout off and at BCSR_P (each
    pair draws its mask from one generator seed). The forward is held to
    KERNEL_RTOL of max(1, max |want|), the gradients to BCSR_GRAD_RTOL of
    max |want|; each call's launches must be as its route states. Returns
    the worst error of each comparison."""
    import torch

    from pygat_tpu_torch.legacy_bcsr.sparse_attention import gat_attention_v1

    errors = {}
    for label in ("cora", "pubmed"):
        g, tiles = graphs[label], tilings[label]
        for i, (h, f) in enumerate(BCSR_WIDTHS[label]):
            fd, fs, wh, ct = _bcsr_inputs(g, h, f, 40 + i)
            for rate in (0.0, BCSR_P):
                res = {}
                for backend, want in (("xla", {}),
                                      ("pallas", {"bcsr_attention": 1,
                                                  "stream_scatter": 2})):
                    leaves = [t.clone().requires_grad_() for t in (fd, fs, wh)]
                    gen = torch.Generator(device="cuda")
                    gen.manual_seed(50 + i)
                    before = {k: c.launches for k, c in counters.items()}
                    out = gat_attention_v1(
                        *leaves, g, tiles, alpha=0.2, backend=backend,
                        dropout_rate=rate, generator=gen, train=rate > 0)
                    grads = torch.autograd.grad(out, leaves, ct)
                    torch.cuda.synchronize()
                    made = {k: c.launches - before[k]
                            for k, c in counters.items()
                            if c.launches != before[k]}
                    if made != want:
                        raise AssertionError(f"{label} {backend}: launches "
                                             f"{made}, want {want}")
                    res[backend] = (out.detach(), *grads)
                errs = [_max_err(res["pallas"][0], res["xla"][0])]
                for a, b in zip(res["pallas"][1:], res["xla"][1:]):
                    err = float((a - b).abs().max())
                    errs.append((err, BCSR_GRAD_RTOL * float(b.abs().max())))
                key = f"{label} H={h} F={f} dropout={rate}"
                errors[key] = max(e for e, _ in errs)
                print(f"  {key}: pallas vs xla, out {errs[0][0]:.3e} (allowed "
                      f"{errs[0][1]:.3e}); d f_dst, d f_src, d wh "
                      + ", ".join(f"{e:.3e} (allowed {a:.3e})"
                                  for e, a in errs[1:]), flush=True)
                if not all(e <= a for e, a in errs):
                    raise AssertionError(f"{key}: the routes disagree")
                del res
    return errors


def _bcsr_kernel_cases(graphs, tilings):
    """``bcsr_attention`` at the BCSR path's widths, the 524k graph's and
    the hub graph's, with no mask and with a keep mask at BCSR_P (the keep
    factors of the graph's edges carried into chunk layout), each output
    (out, m, den) held against the plain version in f64 to KERNEL_RTOL of
    max(1, max |want|), and called twice (the two results equal bit for
    bit)."""
    import torch

    from pygat_tpu_torch.legacy_bcsr.fused_attention import (
        bcsr_attention,
        bcsr_attention_plain,
    )

    cases = []
    for label, widths in BCSR_WIDTHS.items():
        g, tiles = graphs[label], tilings[label]
        n_valid = int(tiles.valid.sum())
        for i, (h, f) in enumerate(widths):
            fd, fs, wh, _ = _bcsr_inputs(g, h, f, 60 + i)
            gen = torch.Generator(device="cuda")
            gen.manual_seed(70 + i)
            keep = torch.where(torch.rand(g.num_edges_padded, generator=gen,
                                          device="cuda") < 1 - BCSR_P,
                               1 / (1 - BCSR_P), 0.0)
            masked = keep[tiles.edge_perm.long().clamp(min=0)] * tiles.valid
            for rate, drop in ((0.0, None), (BCSR_P, masked)):
                args = (fd, fs, wh, tiles, 0.2, drop)
                got = bcsr_attention(*args)
                again = bcsr_attention(*args)
                want = bcsr_attention_plain(*args, f64=True)
                torch.cuda.synchronize()
                errs = [_max_err(a, b) for a, b in zip(got, want)]
                same = all(torch.equal(a, b) for a, b in zip(got, again))
                print(f"  bcsr_attention {label} H={h} F={f} dropout={rate}: "
                      "max_abs_err out, m, den " + ", ".join(
                          f"{e:.3e} (allowed {a:.3e})" for e, a in errs)
                      + f"; second call equal bit for bit: {same}",
                      flush=True)
                if not all(e <= a for e, a in errs):
                    raise AssertionError("bcsr_attention disagrees with its "
                                         "plain version")
                if not same:
                    raise AssertionError("bcsr_attention: a second call "
                                         "gave other bits")
                cases.append(dict(kernel="bcsr_attention", dataset=label, H=h,
                                  F=f, dropout=rate, args=args,
                                  n_valid=n_valid, bitwise_repeat=same,
                                  max_abs_err=max(e for e, _ in errs)))
                del got, again, want
    return cases


def _time_bcsr(case, large=None, band_plan=None):
    """Device ms of ``bcsr_attention`` at ``case``'s shape and, without a
    dropout mask, of its plain version; and the bound: f_dst, f_src and wh read once, the slot data of
    the valid slots (recv_local, send_local, valid; drop when masked),
    chunk_col and the tile offsets, out, m and den written, over the
    card's memory rate; about 2F + 10 FLOPs per valid slot and head. With
    ``large``, also the stream and banded fused forwards (``fused_v1``,
    ``fused_v1_banded``: numerators and denominators of the same attention,
    f_src = wh . a_src, no dropout) over the same wh and f_dst."""
    import torch

    from pygat_tpu_torch.legacy_bcsr.fused_attention import (
        bcsr_attention,
        bcsr_attention_plain,
    )
    from pygat_tpu_torch.ops.banded import fused_v1_banded
    from pygat_tpu_torch.ops.fused_stream import fused_v1, leaky_relu

    args = case.pop("args")
    fd, fs, wh, tiles, _, drop = args
    h, n, f = wh.shape
    # the plain version takes 50-80 ms a call at Pubmed and 524k
    kw = (dict(calls=BIG_CALLS, replays=BIG_REPLAYS)
          if case["dataset"] in ("pubmed", "large") else {})
    case["ms"] = _time_ms(lambda: bcsr_attention(*args), **kw)
    if drop is None:  # with a mask, the kernel is held to it but not timed
        case["plain_ms"] = _time_ms(lambda: bcsr_attention_plain(*args), **kw)
    case["library_ms"] = None
    n_bytes = (4 * (2 * h * n + 2 * h * n * f + 2 * h * n)
               + (16 if drop is not None else 12) * case["n_valid"]
               + 4 * (tiles.num_chunks + tiles.n_tiles + 1))
    case["bound_ms"], case["bound_by"] = _bound(
        n_bytes, case["n_valid"] * h * (2 * f + 10))
    extra = ""
    if large is not None:
        g = large.graph
        a_src = torch.randn(h, f, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(80))
        wh_n = wh.permute(1, 0, 2).reshape(n, h * f).contiguous()
        fd_n = fd.T.contiguous()
        f_src = torch.einsum("hnf,hf->nh", wh, a_src)
        m_src = torch.where(g.node_mask[:, None], f_src, float("-inf")).amax(0)
        bound = leaky_relu(fd_n + m_src[None], 0.2).contiguous()
        keepq = torch.ones(g.num_edges_padded, h, device="cuda")
        case["fused_v1_ms"] = _time_ms(lambda: fused_v1(
            wh_n, fd_n, bound, a_src, keepq, g.senders, g.r_local, g.r_chunk,
            0.2, walk=g.stream_walk), **kw)
        keepq_b = torch.ones(band_plan.num_slots, h, device="cuda")
        case["fused_v1_banded_ms"] = _time_ms(lambda: fused_v1_banded(
            wh_n, fd_n, bound, a_src, keepq_b, band_plan, 0.2), **kw)
        extra = (f"; same attention: fused_v1 {case['fused_v1_ms']:.4f} ms, "
                 f"fused_v1_banded {case['fused_v1_banded_ms']:.4f} ms")
        del wh_n, fd_n, f_src, bound, keepq, keepq_b
    plain = (f", plain {case['plain_ms']:.4f} ms" if "plain_ms" in case
             else "")
    print(f"  bcsr_attention {case['dataset']} H={h} F={f} "
          f"dropout={case['dropout']}: {case['ms']:.4f} ms{plain}, bound "
          f"{case['bound_ms']:.5f} ms ({case['bound_by']}){extra}", flush=True)


def _ppi_batches(data, gen, fused, kernel_cases):
    """The PPI path's kernels at the preset's widths against their plain
    versions (:func:`_stream_kernel_cases`): on the first train batch of
    ``make_batches`` (shuffled, as the per-batch loop's first epoch) and on
    a batch assembled from the train bank with a dead member, whose walks
    must equal those built on the host from its own fields. Returns (the
    two graphs by name, the bank's and the batch's set-up seconds, the
    train batch)."""
    import torch

    from pygat_tpu_torch.data.ppi import (
        assemble_banked_batch,
        bank_bounds,
        batch_bounds,
        build_bank,
        make_batches,
    )
    from pygat_tpu_torch.ops.stream import build_stream_walk

    bounds = [batch_bounds(s, 2) for s in (data.train, data.valid, data.test)]
    n_pad, e_pad = max(b[0] for b in bounds), max(b[1] for b in bounds)
    t1 = time.perf_counter()
    pb = next(make_batches(data.train, 2, n_pad=n_pad, e_pad=e_pad,
                           shuffle=True, seed=72, device="cuda"))
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t1
    n_pg, e_pg = bank_bounds([data.train, data.valid, data.test])
    t1 = time.perf_counter()
    bank = build_bank(data.train, n_pg, e_pg, device="cuda")
    torch.cuda.synchronize()
    bank_s = time.perf_counter() - t1
    last = len(data.train) - 1
    _, gb, _ = assemble_banked_batch(bank, [last, 0], [True, False])
    for side, (local, chunk, walk) in (
            ("receiver", (gb.r_local, gb.r_chunk, gb.stream_walk)),
            ("sender", (gb.c_local, gb.c_chunk, gb.sender_walk))):
        ref = build_stream_walk(local.cpu().numpy(), chunk.cpu().numpy(),
                                gb.num_nodes_padded // 128, "cuda")
        same = all(torch.equal(getattr(walk, f), getattr(ref, f))
                   for f in ("row_ptr", "tile_ptr", "split_at"))
        print(f"phase 8: banked batch (graphs {last} and 0, 0 dead), {side} "
              f"walk assembled on the card: {walk.split_at.numel()} split "
              f"pieces, max_run {walk.max_run}; "
              f"{'equal' if same else 'NOT equal'} to the host-built walk "
              "of its fields")
        if not same or walk.max_run != ref.max_run:
            raise AssertionError(f"the banked batch's {side} walk is wrong")
    graphs = {"ppi batch": pb.batch.graph, "ppi bank": gb}
    for name, g in graphs.items():
        print(f"phase 8: {name}: N_pad {g.num_nodes_padded}, E_s "
              f"{g.num_edges_padded}, CSC stream {g.c_slot.shape[0]}, live "
              f"slots {int((g.r_local < 128).sum())}", flush=True)
        _stream_kernel_cases(name, g, *zip(*PPI_WIDTHS), gen, fused,
                             kernel_cases)
    del bank
    return graphs, {"ppi_bank": bank_s, "ppi_batch": batch_s}, pb


def _want_ppi(fused_name, epochs, n_train, n_eval):
    """The launches a PPI run makes through the wrappers, by either loop:
    per train batch 3 layers of one fused forward and, in its backward, 2
    stream_scatters (receiver and sender side); per eval batch (the
    validation batches of every epoch, then the test batches) 3 fused
    forwards."""
    return {fused_name: 3 * (epochs * n_train + n_eval),
            "stream_scatter": 2 * 3 * epochs * n_train}


def _train_ppi(label, argv, counters, jsonl, data):
    """One run of ``cli.train_ppi`` on CUDA for PPI_EPOCHS epochs through
    :func:`_train_cli`: finite, falling training losses, launches as
    :func:`_want_ppi` states and as the CLI printed them, no other kernel.
    Returns (launches, the ppi_epoch records)."""
    model = argv[argv.index("--model") + 1]
    got, losses, _, _, text = _train_cli(argv, PPI_EPOCHS, counters, jsonl,
                                         ppi=True)
    with open(jsonl) as fh:
        recs = [r for r in map(json.loads, fh) if r["kind"] == "ppi_epoch"]
    n_train = -(-len(data.train) // 2)
    n_eval = PPI_EPOCHS * -(-len(data.valid) // 2) + -(-len(data.test) // 2)
    fused_name = "fused_v2" if model == "GATv2_sparse" else "fused_v1"
    want = _want_ppi(fused_name, PPI_EPOCHS, n_train, n_eval)
    counts = re.search(r"Kernel launches: (\{.*\})", text)
    print(f"phase 8: {label}: wrapper launches "
          f"{ {k: v for k, v in got.items() if v} }; train losses {losses}; "
          f"validation losses {[r['loss_val'] for r in recs]}", flush=True)
    if counts is None or json.loads(counts.group(1)) != got:
        raise AssertionError(f"{label}: the CLI printed no or other counts")
    if {k: v for k, v in got.items() if v} != want:
        raise AssertionError(f"{label}: launches {got}, want {want} and no "
                             "other kernel")
    return got, recs


def _ppi_epoch_s(cfg, data):
    """Host seconds per PPI epoch of both loops, PPI_TIMED_EPOCHS epochs
    each after a warm-up one: the per-batch loop (``fit_inductive``
    without per-batch records) and the banked loop (``epoch_chunk`` 1, one
    host read an epoch), from their ppi_epoch records; and the per-batch
    loop's parts, from the same building blocks: building the epoch's
    train and validation batches on the host (stream layouts and walks),
    copying them to the card, and the steps over them (host clock after a
    synchronize, and CUDA events)."""
    import torch

    from pygat_tpu_torch.data.ppi import batch_bounds, make_batches
    from pygat_tpu_torch.models.gat import init_gat
    from pygat_tpu_torch.models.presets import TRAIN_PRESETS
    from pygat_tpu_torch.train.inductive import (
        fit_inductive,
        fit_inductive_banked,
        make_inductive_steps,
    )
    from pygat_tpu_torch.train.logging import TrainLogger
    from pygat_tpu_torch.train.state import init_state, make_optimizer
    from pygat_tpu_torch.utils.platform import make_generator

    kw = dict(batch_size=2, **TRAIN_PRESETS["ppi"],
              epochs=PPI_TIMED_EPOCHS + 1, patience=100, device="cuda")
    out = {}
    for name, fit, extra in (
            ("per_batch", fit_inductive, dict(log_batches=False)),
            ("banked", fit_inductive_banked, dict(epoch_chunk=1,
                                                  log_every=1))):
        text = io.StringIO()
        fit(cfg, data, logger=TrainLogger(stream=text), **kw, **extra)
        times = [float(m) for m in re.findall(r"^Epoch: .* time: ([0-9.]+)s$",
                                              text.getvalue(), re.M)]
        out[f"{name}_epoch_s"] = times[1:]

    bounds = [batch_bounds(s, 2) for s in (data.train, data.valid, data.test)]
    n_pad, e_pad = max(b[0] for b in bounds), max(b[1] for b in bounds)
    params = init_gat(cfg, make_generator("cpu", 72), device="cuda")
    state = init_state(params, make_optimizer(params, **TRAIN_PRESETS["ppi"]),
                       make_generator("cuda", 73))
    train_step, eval_step = make_inductive_steps(cfg)
    parts = {"host_build_s": [], "copy_s": [], "steps_s": [],
             "steps_device_s": []}
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    for epoch in range(PPI_TIMED_EPOCHS + 1):
        t0 = time.perf_counter()
        host = [list(make_batches(data.train, 2, n_pad=n_pad, e_pad=e_pad,
                                  shuffle=True, seed=72 + epoch,
                                  device="cpu")),
                list(make_batches(data.valid, 2, n_pad=n_pad, e_pad=e_pad,
                                  device="cpu"))]
        t1 = time.perf_counter()
        dev = [[(pb.features.to("cuda"), pb.batch.graph.to("cuda"),
                 pb.labels.to("cuda")) for pb in split] for split in host]
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        start.record()
        for x, g, y in dev[0]:
            train_step(state, x, g, y)
        for x, g, y in dev[1]:
            eval_step(state.params, x, g, y)
        stop.record()
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        if epoch:
            parts["host_build_s"].append(t1 - t0)
            parts["copy_s"].append(t2 - t1)
            parts["steps_s"].append(t3 - t2)
            parts["steps_device_s"].append(start.elapsed_time(stop) / 1e3)
        del host, dev
    out.update(parts)
    return out


def _ppi_phase(gen, fused, kernel_cases, counters, jsonl, path_launches,
               path_replayed):
    """Phase 8, the PPI path: load the data; rows 1-3 at the preset's
    widths (:func:`_ppi_batches`, GATv2 with exact bounds); each model on
    a train batch, card vs CPU; both loops of both models through the CLI
    (:func:`_train_ppi`, adding their launches to ``path_launches``), the
    banked loop's first epoch held to the per-batch loop's; the kernels
    timed on the train batch; the epochs timed (:func:`_ppi_epoch_s`).
    Returns (the epoch seconds by model, the set-up seconds)."""
    import torch

    from pygat_tpu_torch.data.ppi import load_ppi, ppi_config
    from pygat_tpu_torch.ops.fused_stream import fused_v2, fused_v2_plain

    t1 = time.perf_counter()
    ppi = load_ppi()
    ppi_setup = {"ppi_load": time.perf_counter() - t1}
    print(f"phase 8: PPI loaded in {ppi_setup['ppi_load']:.2f} s: graphs "
          f"{[len(s) for s in ppi[:3]]}, nodes "
          f"{[sum(g.num_nodes for g in s) for s in ppi[:3]]}, edges "
          f"{[sum(len(g.senders) for g in s) for s in ppi[:3]]}; synthetic "
          f"stand-ins for {list(ppi.synthetic_parts)}", flush=True)
    ppi_fused = dict(fused, fused_v2=(fused_v2, fused_v2_plain,
                                      _fused_v2_exact_inputs))
    ppi_graphs, setup, ppi_pb = _ppi_batches(ppi, gen, ppi_fused,
                                             kernel_cases)
    ppi_setup.update(setup)
    for lt in ("GAT_sparse", "GATv2_sparse"):
        _card_vs_cpu(f"phase 8: PPI {lt}, one train batch", ppi_config(lt),
                     ppi_pb.features, ppi_pb.batch.graph)
    del ppi_pb
    ppi_runs = {}
    for lt in ("GAT_sparse", "GATv2_sparse"):
        for loop, flags in (("per-batch loop", []),
                            ("banked loop", ["--epoch-scan"])):
            label = f"ppi {lt}, {loop}"
            got, recs = _train_ppi(label, ["--model", lt, *flags], counters,
                                   jsonl, ppi)
            path_launches[label] = got
            path_replayed[label] = dict.fromkeys(counters, 0)
            ppi_runs[label] = recs
        a = ppi_runs[f"ppi {lt}, per-batch loop"][0]
        b = ppi_runs[f"ppi {lt}, banked loop"][0]
        worst = max(abs(a[k] - b[k]) / abs(a[k])
                    for k in ("loss_train", "loss_val"))
        print(f"phase 8: PPI {lt}, banked loop vs per-batch loop, first "
              f"epoch's train and validation losses: worst relative "
              f"difference {worst:.3e} (allowed {LOOPS_RTOL:.0e})", flush=True)
        if not worst <= LOOPS_RTOL:
            raise AssertionError("the banked loop's losses differ from the "
                                 "per-batch loop's")
    for case in kernel_cases["stream_scatter"]:
        if case.get("dataset") == "ppi batch":
            _time_scatter(case, ppi_graphs["ppi batch"])
    for kname, (kernel, plain, _) in fused.items():
        for case in kernel_cases[kname]:
            if case["dataset"] == "ppi batch":
                _time_fused(kname, kernel, plain, case,
                            ppi_graphs["ppi batch"])
    for cases in kernel_cases.values():
        for case in cases:
            case.pop("args", None)
            case.pop("data", None)
    del ppi_graphs
    torch.cuda.empty_cache()
    ppi_epoch_s = {}
    for lt in ("GAT_sparse", "GATv2_sparse"):
        res = _ppi_epoch_s(ppi_config(lt), ppi)
        ppi_epoch_s[lt] = res
        print(f"phase 8: PPI {lt} epoch, host clock, {PPI_TIMED_EPOCHS} "
              "epochs after a warm-up one: "
              + "; ".join(f"{k} {[round(v, 4) for v in vs]}"
                          for k, vs in res.items()), flush=True)
    return ppi_epoch_s, ppi_setup


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 2

    from pygat_tpu_torch.data.citation import load_citation
    from pygat_tpu_torch.models.presets import PRESETS
    from pygat_tpu_torch.ops import build
    from pygat_tpu_torch.ops.banded import (
        BandPlan,
        build_band_plan,
        maybe_plan_large,
        set_band,
    )
    from pygat_tpu_torch.ops.large import plan_csc_to_csr, set_corner
    from pygat_tpu_torch.ops.fused_stream import (
        fused_v1,
        fused_v1_plain,
        fused_v2,
        fused_v2_plain,
    )
    from pygat_tpu_torch.tools.profile_epoch import large_config, large_dataset
    from pygat_tpu_torch.train.loop import fit_transductive, fit_transductive_fast

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.cuda.device_count() >= 1
    kind = torch.cuda.get_device_name(0)
    t_start = time.perf_counter()

    def phase_done(n, t0):
        print(f"phase {n}: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 1: the card and the toolchain ---------------------------------
    t0 = time.perf_counter()
    card = _card_line()
    print(f"phase 1: card {card!r}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; {_nvcc_version(build.nvcc_path())}",
          flush=True)
    phase_done(1, t0)

    # -- phase 2: build --------------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build_all()
    print(f"phase 2: built {list(build.SOURCES)} in {secs:.2f} s", flush=True)
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    phase_done(2, t0)

    # -- phase 3: kernels against their plain versions -------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(72)
    datasets = {}
    for name in ("cora", "pubmed"):
        t1 = time.perf_counter()
        ds = load_citation(name, device="cuda")
        datasets[name] = ds
        g = ds.graph
        print(f"phase 3: {name}: N_pad {g.num_nodes_padded}, E_s "
              f"{g.num_edges_padded}, CSC stream {g.c_slot.shape[0]}, "
              f"features {tuple(ds.features.shape)} "
              f"({time.perf_counter() - t1:.1f} s to load)", flush=True)

    kernel_cases = {name: [] for name in build.SOURCES}
    fused = {"fused_v1": (fused_v1, fused_v1_plain, _fused_inputs),
             "fused_v2": (fused_v2, fused_v2_plain, _fused_v2_inputs)}
    # the receiver stream's kernels at each graph's layer widths: Cora's
    # and Pubmed's here, the 524k graph's (set_band("off")) once it is built
    stream_graphs = {name: ds.graph for name, ds in datasets.items()}
    for name, g in stream_graphs.items():
        _stream_kernel_cases(name, g, PRESETS[name]["nheads"],
                             PRESETS[name]["nfeats"][1:], gen, fused,
                             kernel_cases)

    # the banded kernels: on the large clustered graph with the plan the
    # JAX package's selection picks by itself (auto, past 300k nodes), and
    # on Cora with set_band("on"); built once, shared with phases 4 and 5
    t1 = time.perf_counter()
    large = large_dataset()
    t2 = time.perf_counter()
    large_plan = maybe_plan_large(large.graph)
    band_plan_s = time.perf_counter() - t2
    if not isinstance(large_plan, BandPlan):
        raise AssertionError("maybe_plan_large chose no band plan at 524k nodes")
    print(f"phase 3: large: N_pad {large.graph.num_nodes_padded}, E_s "
          f"{large.graph.num_edges_padded}, features "
          f"{tuple(large.features.shape)} ({t2 - t1:.1f} s to build); band "
          f"plan chosen by maybe_plan_large: w {large_plan.w}, "
          f"{large_plan.num_chunks} chunks, {large_plan.num_slots} slots, "
          f"fill {large_plan.fill:.4f} ({band_plan_s:.1f} s)",
          flush=True)
    stream_graphs["large"] = large.graph
    _stream_kernel_cases("large", large.graph, PRESETS["cora"]["nheads"],
                         (PRESETS["cora"]["nfeats"][1], large.num_classes),
                         gen, fused, kernel_cases)
    cora = datasets["cora"]
    set_band("on", w=4)
    cora_plan = maybe_plan_large(cora.graph)
    set_band("auto")
    print(f"phase 3: cora with set_band('on'): w {cora_plan.w}, "
          f"{cora_plan.num_chunks} chunks, fill {cora_plan.fill:.4f}")
    hub = _hub_graph()
    plans = {"large": large_plan, "cora, band plan": cora_plan,
             "hub": build_band_plan(hub, w=4)}
    print(f"phase 3: hub: band plan of {plans['hub'].num_chunks} chunks, "
          f"pieces of split tiles past the first "
          f"{plans['hub'].split_at.numel()}", flush=True)
    if not plans["hub"].split_at.numel():
        raise AssertionError("the hub graph's band plan has no split tile")
    # the stream kernels on the hub's receiver stream, whose walk cuts the
    # hub's tile into pieces and its run into segments
    if not hub.stream_walk.split_at.numel() or hub.stream_walk.max_run <= 32:
        raise AssertionError("the hub graph's stream walk has no split tile")
    stream_graphs["hub"] = hub
    _stream_kernel_cases("hub", hub, PRESETS["cora"]["nheads"][:1],
                         PRESETS["cora"]["nfeats"][1:2], gen, fused,
                         kernel_cases)
    banded_cases = []
    for label, ds, preset in (("large", large, "cora"),
                              ("cora, band plan", cora, "cora")):
        heads = PRESETS[preset]["nheads"]
        feats = (PRESETS[preset]["nfeats"][1], ds.num_classes)
        for case in _banded_cases(label, ds.graph, plans[label], heads, feats,
                                  gen):
            _check_banded(case, plans[label])
            kernel_cases[case["kernel"]].append(case)
            banded_cases.append(case)
    # the fused banded forwards on the hub's cut tile, at the preset's
    # layer-1 width
    for path, make in (("v1", _fused_inputs), ("v2", _fused_v2_inputs)):
        h, f = PRESETS["cora"]["nheads"][0], PRESETS["cora"]["nfeats"][1]
        case = dict(dataset="hub", path=path, H=h, F=f,
                    kernel=f"fused_{path}_banded",
                    n_live=int((plans["hub"].r_local < 128).sum()),
                    args=make(hub, h, f, gen, plans["hub"]))
        _check_banded(case, plans["hub"])
        kernel_cases[case["kernel"]].append(case)
        banded_cases.append(case)

    # the corner kernels: every pass of both 524k corner plans (built once
    # here; the trainers of phase 4 build their own) at every width the
    # corner path turns, a Cora plan with overflow rows, and the window
    # forwards at the Cora and 524k shapes
    t1 = time.perf_counter()
    large_corner = plan_csc_to_csr(large.graph)
    corner_plan_s = time.perf_counter() - t1
    print(f"phase 3: large: corner plans built in {corner_plan_s:.2f} s: "
          f"{large_corner.fwd.n_rows} rows, forward spans "
          f"{[cp.p for cp in large_corner.fwd.passes]}, inverse spans "
          f"{[cp.p for cp in large_corner.inv.passes]}, overflow rows "
          f"{[cp.n_overflow for cp in large_corner.fwd.passes]} / "
          f"{[cp.n_overflow for cp in large_corner.inv.passes]}", flush=True)
    large_heads = PRESETS["cora"]["nheads"]
    large_feats = (PRESETS["cora"]["nfeats"][1], large.num_classes)
    cora_feats = (PRESETS["cora"]["nfeats"][1], cora.num_classes)
    large_widths = _corner_widths(large_heads, large_feats)
    corner_cases = _check_corner("large", large_corner, large_widths, 7)
    kernel_cases["corner_permute"] += corner_cases
    kernel_cases["corner_permute"] += _check_corner_overflow(
        cora, _corner_widths(large_heads, cora_feats))
    cora_corner = plan_csc_to_csr(cora.graph)
    window_cases = (_window_cases("cora", cora.graph, cora_corner, large_heads,
                                  cora_feats, gen)
                    + _window_cases("large", large.graph, large_corner,
                                    large_heads, large_feats, gen))
    for case in window_cases:
        kernel_cases[case["kernel"]].append(case)

    # the whole Cora models, forward and gradients: card vs CPU, over the
    # receiver stream, the band plan and the corner plans; and over the
    # corner plans against the receiver stream with the same masks
    cfgs = {lt: _model_card_vs_cpu(lt, cora)
            for lt in ("GAT_sparse", "GATv2_sparse")}
    for lt in cfgs:
        _model_card_vs_cpu(lt, cora, cora_plan)
        _model_card_vs_cpu(lt, cora, cora_corner)
        _corner_vs_stream(lt, cora, cora_corner)
    phase_done(3, t0)

    # -- phase 4: the main paths ------------------------------------------------
    t0 = time.perf_counter()
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
    path_launches, path_replayed, path_losses = {}, {}, {}
    for label, fused_name, epochs, argv in runs:
        got, losses, replays, captured, _ = _train_cli(argv, epochs, counters,
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
        if any(got[k] or captured[k] for k in counters
               if k not in (fused_name, other, "stream_scatter")):
            raise AssertionError(f"a banded kernel ran on the {label} path")
        if "fast loop" in label:
            want = {fused_name: 4, "stream_scatter": 4,
                    **{k: 0 for k in counters
                       if k not in (fused_name, "stream_scatter")}}
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
    slow = path_losses["cora GATv2_sparse, per-epoch loop"]
    fast = path_losses["cora GATv2_sparse, fast loop"]
    worst = max(abs(x - y) / abs(y) for x, y in zip(fast, slow))
    print(f"phase 4: fast loop vs per-epoch loop, {TRAIN_EPOCHS} epoch losses: "
          f"worst relative difference {worst:.3e} (allowed {LOOPS_RTOL:.0e})")
    if not worst <= LOOPS_RTOL:
        raise AssertionError("the fast loop's losses differ from the per-epoch loop's")

    # the large graph through the trainers, with no switch: each asks
    # maybe_plan_large, which picks the band plan past 300k padded nodes
    large_cfgs = {lt: large_config(lt, large)
                  for lt in ("GAT_sparse", "GATv2_sparse")}
    large_runs = [
        ("large GAT_sparse, per-epoch loop", fit_transductive, "GAT_sparse",
         dict(epochs=LARGE_EPOCHS)),
        ("large GAT_sparse, fast loop", fit_transductive_fast, "GAT_sparse",
         dict(epochs=2 * LARGE_CHUNK, epoch_chunk=LARGE_CHUNK)),
        ("large GATv2_sparse, fast loop", fit_transductive_fast,
         "GATv2_sparse", dict(epochs=2 * LARGE_CHUNK, epoch_chunk=LARGE_CHUNK)),
    ]
    for label, fit, lt, kw in large_runs:
        t1 = time.perf_counter()
        got, losses, _, by_replay = _train_large(label, fit, large_cfgs[lt],
                                                 large, counters, jsonl, **kw)
        print(f"  ({time.perf_counter() - t1:.1f} s)", flush=True)
        path_launches[label], path_losses[label] = got, losses
        path_replayed[label] = {k: by_replay.get(k, 0) for k in counters}
    slow = path_losses["large GAT_sparse, per-epoch loop"]
    fast = path_losses["large GAT_sparse, fast loop"][:LARGE_EPOCHS]
    worst = max(abs(x - y) / abs(y) for x, y in zip(fast, slow))
    print(f"phase 4: large GAT_sparse, fast loop vs per-epoch loop over "
          f"{LARGE_EPOCHS} shared epochs: worst relative difference "
          f"{worst:.3e} (allowed {LOOPS_RTOL:.0e})")
    if not worst <= LOOPS_RTOL:
        raise AssertionError("the large fast loop's losses differ from the "
                             "per-epoch loop's")

    # the corner plans through the trainers: under set_band("off") and
    # set_corner("on") each trainer asks maybe_plan_large, which returns the
    # corner plans it builds; no banded and no stream-fused kernel runs
    set_band("off")
    set_corner("on")
    for lt in ("GAT_sparse", "GATv2_sparse"):
        label = f"large {lt}, corner plans, fast loop"
        t1 = time.perf_counter()
        got, losses, _, by_replay = _train_large(
            label, fit_transductive_fast, large_cfgs[lt], large, counters,
            jsonl, corner=True, epochs=2 * LARGE_CHUNK, epoch_chunk=LARGE_CHUNK)
        print(f"  ({time.perf_counter() - t1:.1f} s)", flush=True)
        path_launches[label], path_losses[label] = got, losses
        path_replayed[label] = {k: by_replay.get(k, 0) for k in counters}
    set_band("auto")
    set_corner("auto")

    # --corner on through the CLI on Cora, which prints its own counts
    label = "cora GAT_sparse, --corner on CLI"
    got, losses, _, _, text = _train_cli(
        ["--dataset", "cora", "--model", "GAT_sparse", "--corner", "on"],
        V1_EPOCHS, counters, jsonl)
    set_corner("auto")
    counts = re.search(r"Kernel launches: (\{.*\})", text)
    plan_line = re.search(r"corner_plan: (.*)", text)
    if counts is None or plan_line is None:
        raise AssertionError(f"{label}: no corner plan or no launch counts "
                             f"printed:\n{text[-3000:]}")
    print(f"phase 4: {label}: {plan_line.group(1)}; launches it printed "
          f"{counts.group(1)}; train losses {losses}", flush=True)
    want, _ = _want_corner("fused_v1_window", V1_EPOCHS, False,
                           len(cora_corner.fwd.passes),
                           len(cora_corner.inv.passes))
    if json.loads(counts.group(1)) != got or {
            k: v for k, v in got.items() if v} != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")
    path_launches[label], path_losses[label] = got, losses
    path_replayed[label] = dict.fromkeys(counters, 0)

    # the environment knob reaches the banded path through the CLI
    t1 = time.perf_counter()
    label = "cora GAT_sparse, PYGAT_BAND=on CLI"
    got, losses, plan_line = _cli_band(jsonl, V1_EPOCHS)
    print(f"phase 4: {label} (subprocess, {time.perf_counter() - t1:.1f} s): "
          f"{plan_line}; launches it counted {got}; train losses {losses}",
          flush=True)
    want, _ = _want_banded("fused_v1_banded", V1_EPOCHS, False)
    if {k: v for k, v in got.items() if v} != want:
        raise AssertionError(f"{label}: launches {got}, want {want}")
    path_launches[label], path_losses[label] = got, losses
    path_replayed[label] = dict.fromkeys(counters, 0)
    phase_done(4, t0)

    # -- phase 5: timing --------------------------------------------------------
    t0 = time.perf_counter()
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
        if "side" not in case:
            continue  # a banded width, timed below
        _time_scatter(case, stream_graphs[case["dataset"]])
    for kname, (kernel, plain, _) in fused.items():
        for case in kernel_cases[kname]:
            _time_fused(kname, kernel, plain, case,
                        stream_graphs[case["dataset"]])
    for case in banded_cases:
        _time_banded(case, plans[case["dataset"]], case["dataset"] == "large")
    _time_corner("large", large_corner, large_widths, 7, corner_cases)
    for case in window_cases:
        _time_window(case, case["dataset"] == "large")
    # the large graph's epoch over the band plan, over the corner plans
    # and over the receiver stream (what set_band("off") leaves the
    # trainers), in turns; the kernels' inputs are freed first
    for cases in kernel_cases.values():
        for case in cases:
            case.pop("args", None)
            case.pop("data", None)
            case.pop("walk", None)
    torch.cuda.empty_cache()
    set_band("off")
    stream_plan = maybe_plan_large(large.graph)
    set_band("auto")
    for lt, cfg in large_cfgs.items():
        res, peak_gib = _large_epoch_ms(cfg, large, {"banded": large_plan,
                                                     "corner": large_corner,
                                                     "stream": stream_plan})
        epoch_ms[f"large {lt}"] = {
            f"fast_loop_{k}_ms": v[len(v) // 2] for k, v in res.items()}
        epoch_ms[f"large {lt}"]["peak_allocated_gib"] = peak_gib
        print(f"phase 5: large {lt} epoch by the fast loop, host clock, "
              f"{LARGE_ROUNDS} rounds of {LARGE_TIMED_CHUNKS} chunks of "
              f"{LARGE_CHUNK} CUDA graph replays each, one captured epoch on "
              f"the card at a time (peak allocated {peak_gib:.2f} GiB), in "
              f"turns: "
              + "; ".join(f"{k}: median {v[len(v) // 2]:.4f} ms per epoch "
                          f"(all {[round(x, 4) for x in v]})"
                          for k, v in res.items()), flush=True)

    phase_done(5, t0)

    # -- phase 6: the SpMM path -------------------------------------------------
    # every op of the family forward and backward at full width, on the
    # Pubmed stand-in and the 524k graph, after every captured epoch and its
    # pool are freed; the counters are set to 0 just before the path and
    # read just after it, and the kernel checks and timings come after
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    spmm_specs, spmm_setup = _spmm_graphs(datasets["pubmed"], large,
                                          large_plan, large_corner)
    spmm_inputs = {label: _spmm_inputs(spec["graph"], 17 + i)
                   for i, (label, spec) in enumerate(spmm_specs.items())}
    for label, spec in spmm_specs.items():  # built at a plan's first SpMM
        if spec["band"] is not None:
            t1 = time.perf_counter()
            walk = spec["band"].spmm_walk
            torch.cuda.synchronize()
            print(f"phase 6: {label}: band plan's SpMM walk of "
                  f"{walk.order.numel()} slots built in "
                  f"{time.perf_counter() - t1:.4f} s", flush=True)
    for fn in counters.values():
        fn.launches = 0
    route_errors = _spmm_path(spmm_specs, spmm_inputs, counters)
    path_launches["spmm"] = {name: fn.launches
                             for name, fn in counters.items()}
    path_replayed["spmm"] = dict.fromkeys(counters, 0)
    print(f"phase 6: SpMM path: wrapper launches "
          f"{ {k: v for k, v in path_launches['spmm'].items() if v} }",
          flush=True)
    spmm_specs["hub"] = _hub_spec()
    spmm_inputs["hub"] = _spmm_inputs(spmm_specs["hub"]["graph"], 19)
    spmm_inputs["hub"]["vals_b"], _ = _banded_values(
        spmm_specs["hub"]["band"], spmm_inputs["hub"]["w"])
    spmm_cases = _spmm_kernel_cases(spmm_specs, spmm_inputs)
    for case in spmm_cases:
        _time_spmm(case)
        kernel_cases[case["kernel"]].append(case)
    spmm_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase 6: SpMM phase peak allocated {spmm_peak_gib:.2f} GiB",
          flush=True)
    del spmm_specs, spmm_inputs
    torch.cuda.empty_cache()
    phase_done(6, t0)

    # -- phase 7: the BCSR path -------------------------------------------------
    # gat_attention_v1's two routes against each other on Cora and Pubmed,
    # with the counters set to 0 just before and read just after; then the
    # kernel against its plain version, and timed, there and at 524k
    t0 = time.perf_counter()
    bcsr_graphs = {"cora": datasets["cora"].graph,
                   "pubmed": datasets["pubmed"].graph, "large": large.graph,
                   "hub": _hub_graph()}
    bcsr_tilings, bcsr_setup = _bcsr_tilings(bcsr_graphs)
    for fn in counters.values():
        fn.launches = 0
    bcsr_errors = _bcsr_path(bcsr_graphs, bcsr_tilings, counters)
    path_launches["bcsr"] = {name: fn.launches
                             for name, fn in counters.items()}
    path_replayed["bcsr"] = dict.fromkeys(counters, 0)
    print(f"phase 7: BCSR path: wrapper launches "
          f"{ {k: v for k, v in path_launches['bcsr'].items() if v} }",
          flush=True)
    for case in _bcsr_kernel_cases(bcsr_graphs, bcsr_tilings):
        big = case["dataset"] == "large"
        _time_bcsr(case, large if big and not case["dropout"] else None,
                   large_plan)
        kernel_cases["bcsr_attention"].append(case)
    del bcsr_tilings
    torch.cuda.empty_cache()
    phase_done(7, t0)

    # -- phase 8: the PPI path --------------------------------------------------
    # the inductive trainer at the PPI preset's full width: the kernels at
    # its shapes, the model card vs CPU, both loops through the CLI with
    # the counters set to 0 just before each run and read just after, and
    # the epoch times
    t0 = time.perf_counter()
    ppi_epoch_s, ppi_setup = _ppi_phase(gen, fused, kernel_cases, counters,
                                        jsonl, path_launches, path_replayed)
    ppi_s = time.perf_counter() - t0
    print(f"phase 8: PPI phase {ppi_s:.1f} s (budget {PPI_BUDGET_S:.0f} s)",
          flush=True)
    if ppi_s > PPI_BUDGET_S:
        raise AssertionError("the PPI phase took longer than its budget")
    phase_done(8, t0)

    # -- phase 9: the kernels line ----------------------------------------------
    launches = {name: sum(v[name] for v in path_launches.values())
                for name in counters}
    replayed = {name: sum(v[name] for v in path_replayed.values())
                for name in counters}
    entries = []
    for name, cases in kernel_cases.items():
        # the summary numbers sum the shapes one train step gives the kernel
        # on its path's graph: Cora for the stream kernels (stream_scatter:
        # the 4 backward launches of each model's step; the fused kernels:
        # one forward's 2 launches), the large graph for the banded ones
        # (each of the 4 backward kernels: one launch per layer of each
        # model's step; the fused kernels: one forward's 2 launches), and the
        # large graph for the corner ones (corner_permute: every pass of
        # both plans at each of the 4 widths the two models turn, once; the
        # window forwards: one forward's 2 launches), and the large graph
        # for the SpMM ones (one forward at L = 128: spmm_banded over the
        # band plan, panel_spmm over the uncapped layout), and the large
        # graph for bcsr_attention (one forward at H = 8, F = 8, no
        # dropout mask); every shape is
        # listed under "cases". "launches" sums the wrapper's count over the
        # main-path runs of phases 4, 6, 7 and 8 (one by one under
        # "launches_by_path"); "replayed_launches" are those of the fast
        # loop's CUDA graph replays, replays x launches captured.
        main_set = "cora" if name in ("stream_scatter", "fused_v1",
                                      "fused_v2") else "large"
        main_cases = [c for c in cases if c["dataset"] == main_set
                      and not c.get("dropout")]
        lib = [c["library_ms"] for c in main_cases]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"pygat_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": launches[name],
            "launches_by_path": {k: v[name] for k, v in path_launches.items()},
            "replayed_launches": replayed[name],
            "replayed_launches_by_path": {
                k: v[name] for k, v in path_replayed.items()},
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": sum(c["ms"] for c in main_cases),
            "plain_ms": sum(c["plain_ms"] for c in main_cases),
            "bound_ms": sum(c["bound_ms"] for c in main_cases),
            "bound_by": "bytes" if all(c["bound_by"] == "bytes"
                                       for c in main_cases) else "operations",
            "library_ms": None if None in lib else sum(lib),
            "cases": [{k: c[k] for k in ("dataset", "path", "side", "dir",
                                         "pass", "p", "L", "H", "F", "P",
                                         "ms", "op_ms", "two_pass_ms",
                                         "spmm_graph_ms", "dropout",
                                         "fused_v1_ms", "fused_v1_banded_ms",
                                         "plain_ms", "library_ms",
                                         "bound_ms", "bound_by",
                                         "max_abs_err", "split_at",
                                         "bitwise_repeat") if k in c}
                      for c in cases],
        })
        if not launches[name]:
            raise AssertionError(f"{name} was not launched on any main path")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": entries, "epoch_ms": epoch_ms,
                      "setup_s": {"large_band_plan": band_plan_s,
                                  "large_corner_plans": corner_plan_s,
                                  **spmm_setup, **bcsr_setup},
                      "spmm": {"route_max_abs_err": route_errors,
                               "peak_allocated_gib": spmm_peak_gib},
                      "bcsr": {"route_max_abs_err": bcsr_errors},
                      "ppi": {"epoch_s": ppi_epoch_s, "setup_s": ppi_setup},
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
