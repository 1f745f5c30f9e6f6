#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``pygat_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure, and each
of which prints its seconds:

1. print the card (``nvidia-smi`` name and power limit), CUDA and nvcc
   versions;
2. build the twenty-five CUDA kernel libraries (twenty-nine kernels:
   the ring's per-hop forwards sit in the stream forwards' sources, f32
   and one-limb) from ``pygat_tpu_torch/csrc`` and print
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
   the same weighted graph; then, with the counters set to 0 just before
   and read just after, the ops that take a precision under "fastest" (one
   bf16 limb: ``panel_spmm_graph`` with and without ``plans=``,
   ``spmm_corner_graph``, ``spmm_banded`` fused and two-pass) forward and
   backward on the same graphs, held to the plain SpMM under each route's
   rounding, each call launching the one-limb kernels as its route states
   and no f32 SpMM kernel or sum; the one-limb SpMM kernels
   (``spmm_banded_bf16``, ``panel_spmm_bf16``) against their plain
   versions under "fastest" in f64, to KERNEL_RTOL of the same sums over
   |message|, at L = 128 there and on the hub graph and at SPMM_ODD_L
   (scalar loads) on Pubmed and the hub, each called twice (equal bit for
   bit), and timed beside the f32 kernel, their bf16 cast, the kernel
   alone, their bound with bf16 x and ``torch.sparse.mm`` in f32 and (where
   PyTorch runs it on the card) in bf16; the panel layouts' set-up
   seconds and the phase's peak device memory; the phase fails past
   SPMM_BUDGET_S seconds;
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
9. the dense layers and the unfused sparse branches: ``stream_scatter`` at
   the unfused branches' widths (Cora's L = 1, 7, 8, 64 and 72, PPI's 726,
   732, 1,024 and 1,028; each input a contiguous transpose, as the layers
   hand it over) against its f64 plain version, called twice (equal bit
   for bit) and timed beside ``index_add_``; the Cora dense models (GAT,
   GATv2) card vs CPU, and their remat path (the threshold lowered to 0,
   dropout on) against the batched heads fed the same masks, on the card;
   the Cora sparse models through the unfused branch
   (``set_fused_attention("off")``) card vs CPU under the ``stream`` and
   ``scatter`` impls; through the CLIs on CUDA, with the counters set to 0
   just before each run and read just after, Cora GAT by the fast loop,
   Cora GATv2 by the per-epoch loop, Cora GAT_sparse with ``--backend
   xla``, PPI's default (the dense GAT) by the per-batch loop, PPI GATv2
   by the banked loop and PPI GATv2_sparse with the fused attention off:
   finite, falling training and validation losses, no kernel launched but
   ``stream_scatter`` in the last run (as many as the unfused branch
   takes), each run's peak memory; the dense epochs of Cora and PPI by
   both loops timed as in phases 5 and 8; two Pubmed dense GAT epochs
   through the remat path (its [8, N, N] attention is 12.6 GB a layer),
   their seconds and peak memory; the phase fails past DENSE_BUDGET_S
   seconds;
10. the ring (``pygat_tpu_torch.parallel``): Cora and Pubmed interleaved
    and repadded for RING_SHARDS shards, their ``partition_edges`` and
    every shard's blocks and walks (host seconds printed); at the presets'
    widths, both models, every hop into every shard, by the rotation (the
    source shard's rows) and by the halo exchange (the rows it gathers by
    ``halo_idx``), the parts kernels (``fused_v1_parts``,
    ``fused_v2_parts``) against their f64 plain versions, called twice
    (equal bit for bit); each shard's summed hops, after ``softmax_div``,
    against the single-device fused attention on the same graph, output
    and gradients, within MODEL_RTOL; ``stream_scatter`` over every
    block's receiver, sender and halo views against its f64 plain version,
    twice; the hops timed (Cora, Pubmed and the 524k graph) beside their
    bounds and row 2 or 3's single-device time, row 1's views beside
    ``index_add_``; the ring model at one shard on the card against the
    single-device model on the CPU; through both CLIs at world size 1
    (the launcher's variables of one rank, the CLI bringing up an NCCL
    group of one), with the counters set to 0 just before each run and
    read just after, Cora GAT_sparse and GATv2_sparse by both loops with
    ``--mesh 1,1 --partition ring --distributed`` and PPI GATv2_sparse by
    the banked loop: finite, falling training and validation losses; on
    Cora the parts kernels and row 1 launched, the single-device forwards
    not;
    the Cora epoch of the ring at one shard beside the single device's;
    the phase fails past RING_BUDGET_S seconds;
11. the RCM order (``load_citation(reorder=True)``, ``--reorder``) and the
    stacked PPI loop (``fit_inductive_fast``): build and load the host
    graph library (``pygat_tpu_torch/native.py``, its seconds printed);
    load Cora and Pubmed in RCM order, with RCM's host seconds and, before
    and after, E_s, the receiver walk's chunks and split pieces, the mean
    sender-to-receiver distance of the live edges and the distinct
    (receiver tile, sender tile) pairs; rows 1-3 at the presets' widths on
    both reordered graphs against their f64 plain versions, called twice
    (equal bit for bit); both Cora sparse models in RCM order card vs CPU;
    through the CLI, with the counters set to 0 just before each run and
    read just after, Cora GAT_sparse ``--reorder`` by the per-epoch loop
    and Pubmed GATv2_sparse ``--reorder --epoch-chunk`` by the fast loop:
    finite, falling training losses and only the stream path's kernels, as
    many as phase 4 states; ``fit_inductive_fast`` on the PPI stand-in,
    both sparse models, FAST_PPI_EPOCHS epochs, its launches as
    ``_want_ppi`` states and its losses against ``fit_inductive``'s within
    LOOPS_RTOL, both loops' epoch seconds; rows 1-3 timed on both graphs
    unreordered and in RCM order in turns, beside their bounds and
    ``index_add_``; the Cora epoch of both models by both loops in both
    orders; the phase fails past REORDER_BUDGET_S seconds;
12. the model axis on one card (one card holds one NCCL rank, so every
    model rank's per-rank code runs in turn on this device): rows 1-3 at
    every H/M width a split layer gives them (Cora GAT_sparse and
    GATv2_sparse at M = 2 and 4, Pubmed's 8 + 8 heads at M = 2, PPI's
    preset at M = 2 and 4, whose 6-head output layer stays whole at 4)
    against their f64 plain versions, called twice (equal bit for bit),
    and the ring's per-hop kernels at Cora's H/M widths; with the counters
    set to 0 just before and read just after, ``apply_gat_pieces`` of
    every configuration and both sparse models over every model rank's
    heads, forward and gradients joined and held to the single-device
    model on the card within MODEL_RTOL, MODEL_AXIS_STEPS Adam steps of
    Cora's split states against one device's (losses within LOOPS_RTOL)
    and a step under dropout from each rank's generators; the split
    state's bytes a rank; Cora's dense GAT and GATv2 at (D, M) = (2, 2) as
    four row x head pieces against the single-device dense model; the H/M
    launches timed beside the full-H ones and their bounds; the phase
    fails past MODEL_AXIS_BUDGET_S seconds;
13. the ``fastest`` precision mode (one bf16 limb, ``PYGAT_STREAM_PRECISION=
    fastest``; every earlier phase runs under the unset default,
    ``high``): the one-limb kernels of rows 1-3 (``stream_scatter_bf16``,
    ``fused_v1_bf16``, ``fused_v2_bf16``, and the ring's hop forms
    ``fused_v1_parts_bf16``, ``fused_v2_parts_bf16``) against their plain
    versions under "fastest" in f64 at the Cora, Pubmed, 524k and PPI
    shapes and on one Cora ring hop (the segment sums and den to
    KERNEL_RTOL, the fused forwards' out to FASTEST_RTOL of the same sum
    over |message|), called twice (equal bit for bit) and timed beside the
    f32 kernels at the same shapes, their bf16 casts and their bounds with
    bf16 data and table bytes; Cora GAT_sparse and GATv2_sparse through
    the CLI under "fastest" by both loops (one run a subprocess with the
    environment variable) and through the ring CLI at world size 1, each
    with the counters set to 0 just before and read just after: finite,
    falling losses, the one-limb kernels launched and the f32 ones not;
    the one-limb kernels of the band plan and the corner plans
    (``banded_take_bf16``, ``banded_sender_sum_bf16``,
    ``fused_v1_banded_bf16``, ``fused_v2_banded_bf16`` on the 524k graph's
    automatic band plan, on Cora's and on the hub graph's;
    ``fused_v1_window_bf16``, ``fused_v2_window_bf16`` at the Cora and
    524k corner shapes) against their plain versions under "fastest" in
    f64 (the take bit for bit), called twice (equal bit for bit) and timed
    beside the f32 kernels, their casts and their bf16 bounds; the 524k
    graph, both models, by ``fit_transductive_fast`` under "fastest" over
    the band plan it picks with no switch and over the corner plans
    (``set_band("off")``, ``set_corner("on")``), and Cora with ``--corner
    on`` through the CLI, each with the counters set to 0 just before and
    read just after: finite losses, a falling validation loss, only the
    one-limb kernels of the order launched (with expand and the corner
    passes, f32 moves in both modes); over the receiver stream, the band
    plan and the corner plans, FASTEST_STEPS Adam steps of each Cora model
    without dropout within FASTEST_STEPS_RTOL of the same steps under
    "high", and the model card vs CPU under "fastest" (FASTEST_RTOL); the
    SpMM ops under "fastest" run in phase 6; the Cora epoch of both
    models by both loops in both modes, and the 524k fast-loop epoch of
    both models in both modes over both orders, in turns; the phase fails
    past FASTEST_BUDGET_S seconds;
14. print the ``kernels`` JSON line, the card line, and last the ``ok`` line.

The script imports nothing of JAX or of the JAX package, needs no network
and starts no process other than ``nvidia-smi``, ``nvcc``, the host C++
compiler (the graph library of phase 11) and the one trainer subprocess,
and waits for each. Without the PPI files under
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
# the one-limb SpMM kernels also at an odd width, whose rows they read by
# scalars; and the phase's budget on the card (about 5 s without the
# one-limb path and kernels, about 15 s with them)
SPMM_ODD_L = 7
SPMM_BUDGET_S = 60.0
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
# the dense layers and the unfused branches: row 1 at the unfused sparse
# branches' widths on their own graphs (Cora's layers, H 8 F 8 and H 1 F 7:
# forward the receiver sum of [E, H F + H], 72 and 8; backward GATv1's
# [E, H] receiver sums, 8 and 1, GATv2's [E, H F] ones, 64 and 7, and the
# [E, H F] sender sums; PPI's H 4 F 256 and H 6 F 121: 1,028 and 732
# forward, 1,024 and 726 backward), and the phase's budget on the card
UNFUSED_WIDTHS = {"cora": {"recv": (72, 8, 64, 7, 1), "send": (64, 7)},
                  "ppi batch": {"recv": (1028, 732, 1024, 726),
                                "send": (1024, 726)}}
DENSE_BUDGET_S = 150.0
# the ring: the shards of its block shapes on one card, and the phase's
# budget on the card
RING_SHARDS = 4
RING_BUDGET_S = 150.0
# the RCM order and the stacked PPI loop: the epochs of each
# fit_inductive_fast run (and of the per-batch loop it is held to), and the
# phase's budget on the card
FAST_PPI_EPOCHS = 3
REORDER_BUDGET_S = 60.0
# the model axis on one card: the model-axis sizes of Cora and PPI (Pubmed
# at 2 only), the Adam steps of the split states, and the phase's budget
MODEL_AXIS_M = (2, 4)
MODEL_AXIS_STEPS = 3
MODEL_AXIS_BUDGET_S = 90.0
# the fastest precision mode (phase 13): a one-limb message rounded from an
# f32 value that differs in its last bit (another exp, another order of
# the logit's terms) may land on the neighbouring bf16 value, one bf16
# step away, at most 2^-7 of the message; so the fused forwards' out is
# held to FASTEST_RTOL of the same sum over |message|, the whole model
# card vs CPU to FASTEST_RTOL of its scale (den and the segment sums, whose
# inputs round alike on both sides, to KERNEL_RTOL). FASTEST_STEPS Adam
# steps without dropout under "fastest" against the same steps under
# "high": each loss within FASTEST_STEPS_RTOL, relative (bf16 operands and
# messages, about 2^-9 relative each, through two layers and a softmax).
FASTEST_RTOL = 2.0 ** -7
FASTEST_STEPS = 3
FASTEST_STEPS_RTOL = 2.0 ** -7
# PR 17's phase took 47.9 s; the band plan's and corner plans' kernels at
# 524k, four 524k training runs and sixteen captured 524k epochs bring it to
# about 155 s on the card
FASTEST_BUDGET_S = 240.0
REPLACES = {"stream_scatter": "pygat_tpu/ops/stream.py:153",
            "stream_scatter_bf16": "pygat_tpu/ops/stream.py:153",
            "fused_v1_bf16": "pygat_tpu/ops/fused_stream.py:134",
            "fused_v2_bf16": "pygat_tpu/ops/fused_stream.py:207",
            "fused_v1_parts_bf16": "pygat_tpu/ops/fused_stream.py:134",
            "fused_v2_parts_bf16": "pygat_tpu/ops/fused_stream.py:207",
            "banded_take_bf16": "pygat_tpu/ops/banded.py:314",
            "banded_sender_sum_bf16": "pygat_tpu/ops/banded.py:411",
            "fused_v1_banded_bf16": "pygat_tpu/ops/banded.py:978",
            "fused_v2_banded_bf16": "pygat_tpu/ops/banded.py:1046",
            "fused_v1_window_bf16": "pygat_tpu/ops/fused_stream.py:134",
            "fused_v2_window_bf16": "pygat_tpu/ops/fused_stream.py:207",
            "spmm_banded_bf16": "pygat_tpu/ops/banded.py:744",
            "panel_spmm_bf16": "pygat_tpu/ops/panel.py:141",
            "corner_permute": "pygat_tpu/ops/corner.py:216",
            "fused_v1_window": "pygat_tpu/ops/fused_stream.py:134",
            "fused_v2_window": "pygat_tpu/ops/fused_stream.py:207",
            "fused_v1": "pygat_tpu/ops/fused_stream.py:134",
            "fused_v2": "pygat_tpu/ops/fused_stream.py:207",
            "fused_v1_parts": "pygat_tpu/ops/fused_stream.py:134",
            "fused_v2_parts": "pygat_tpu/ops/fused_stream.py:207",
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


def _check_scatter(case, g, kernel_cases, precision="high"):
    """A segment-sum case of ``g`` (:func:`_scatter_cases`) at
    ``precision`` against its plain version in f64, to KERNEL_RTOL of the
    same sums over |data|, and called again, equal bit for bit; appended
    to ``kernel_cases`` (under ``stream_scatter_bf16`` for "fastest")."""
    import torch

    from pygat_tpu_torch.ops.stream import stream_scatter, stream_scatter_plain

    kw = dict(precision=precision)
    got = _scatter_call(case, g, stream_scatter, **kw)
    want = _scatter_call(case, g, stream_scatter_plain, f64=True, **kw)
    mag = _scatter_call(dict(case, data=case["data"].abs()), g,
                        stream_scatter_plain, **kw)
    again = _scatter_call(case, g, stream_scatter, **kw)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("kernel output is not finite")
    diff = (got - want).abs()
    err = float(diff.max())
    worst = float((diff / (KERNEL_RTOL * mag + 1e-30)).max())
    repeat = torch.equal(got, again)
    case.update(max_abs_err=err, bitwise_repeat=repeat, precision=precision)
    name = "stream_scatter" if precision == "high" else "stream_scatter_bf16"
    print(f"  {name} {case['dataset']} {case['path']} {case['side']} "
          f"L={case['L']}: max_abs_err {err:.3e}, worst element at "
          f"{worst:.3f} of its allowance; a second call "
          f"{'' if repeat else 'NOT '}equal bit for bit")
    if worst > 1.0 or not repeat:
        raise AssertionError(f"{name} disagrees with its plain version")
    kernel_cases[name].append(case)


def _fastest_out_err(out, plain, args):
    """(max |error|, the worst element's share of its allowance) of a
    one-limb forward's ``out`` against its plain version under "fastest"
    in f64 (:func:`_fastest_share`)."""
    want, _ = plain(*args, f64=True, precision="fastest")
    mag, _ = plain(*args, f64=True, precision="fastest", magnitude=True)
    return _fastest_share(out, want, mag)


def _fastest_share(out, want, mag):
    """(max |out - want|, the worst element's share of its allowance):
    FASTEST_RTOL of the same sum over |message| ``mag`` (however many of a
    row's messages land on their neighbouring bf16 values), and
    KERNEL_RTOL of it for the order of the f32 sum."""
    if not bool(out.isfinite().all()):
        raise AssertionError("kernel output is not finite")
    diff = (out - want).abs()
    allowed = (FASTEST_RTOL + KERNEL_RTOL) * mag + 1e-30
    return float(diff.max()), float((diff / allowed).max())


def _stream_kernel_cases(name, g, heads, feats, gen, fused, kernel_cases,
                         precision="high"):
    """The receiver stream's kernels at one graph's layer widths against
    their plain versions: the segment sums of :func:`_scatter_cases` over
    the graph's walks to KERNEL_RTOL of the same sums over |data| (their
    plain version in f64), the fused forwards over the graph's walk to
    KERNEL_RTOL of their largest output (their plain versions in f64; under
    "fastest" their out to FASTEST_RTOL of the same sum over |message|);
    each, called again, equal bit for bit. Appends each case to
    ``kernel_cases`` (the one-limb kernels' names under "fastest")."""
    import torch

    for case in _scatter_cases(name, g, heads, feats, gen):
        _check_scatter(case, g, kernel_cases, precision)
    kw = dict(precision=precision)
    for kname, (kernel, plain, make_inputs) in fused.items():
        kname += "" if precision == "high" else "_bf16"
        for h, f in zip(heads, feats):
            args = make_inputs(g, h, f, gen)
            out, den = kernel(*args, walk=g.stream_walk, **kw)
            out_p, den_p = plain(*args, f64=True, **kw)
            torch.cuda.synchronize()
            if precision == "high":
                e1, a1 = _max_err(out, out_p)
                held, note = e1 <= a1, f"allowed {a1:.3e}"
            else:
                e1, share = _fastest_out_err(out, plain, args)
                held = share <= 1.0
                note = f"worst element at {share:.3f} of its allowance"
            e2, a2 = _max_err(den, den_p)
            again = kernel(*args, walk=g.stream_walk, **kw)
            repeat = torch.equal(out, again[0]) and torch.equal(den, again[1])
            print(f"  {kname} {name} H={h} F={f}: max_abs_err out {e1:.3e} "
                  f"({note}), den {e2:.3e} (allowed {a2:.3e}); a "
                  f"second call {'' if repeat else 'NOT '}equal bit for bit")
            if not held or e2 > a2 or not repeat:
                raise AssertionError(f"{kname} disagrees with its plain version")
            kernel_cases[kname].append(dict(
                dataset=name, H=h, F=f, args=args, max_abs_err=max(e1, e2),
                bitwise_repeat=repeat, n_live=int((g.r_local < 128).sum()),
                precision=precision))


def _one_limb_kernel_ms(kname, args, walk, n_rows, **kw):
    """Device ms of a one-limb fused kernel alone: its entry point on the
    bf16 copies of the sender tables that its wrapper would make (made
    once here), ``args`` the wrapper's (``kname``: fused_v1, fused_v2,
    fused_v1_parts, fused_v2_parts)."""
    import torch

    from pygat_tpu_torch.ops import fused_stream as fs

    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    alpha = args[-1]
    if kname.startswith("fused_v1"):
        tables, a = (bf(args[0]), *args[1:6]), args[3]
    elif kname == "fused_v2":
        whi, whj, ub, a, keepq, senders = args[:6]
        tables = (whi, bf(whi), bf(whj), ub, a, keepq, senders)
    else:
        wi_local, ub, wi_buf, wj_buf, a, keepq, senders = args[:7]
        tables = (wi_local, bf(wi_buf), bf(wj_buf), ub, a, keepq, senders)
    wrapper = getattr(fs, kname + "_bf16")
    return _time_ms(lambda: fs.launch_tile_fused(wrapper, tables, a, n_rows,
                                                 walk, alpha), **kw)


def _time_scatter(case, g):
    """Time a segment-sum case of :func:`_scatter_cases` over ``g``'s
    walks: the kernel, its plain version, ``index_add_`` and the byte
    bound, into ``case``."""
    import torch

    from pygat_tpu_torch.ops.stream import stream_scatter, stream_scatter_plain

    kw = (dict(calls=BIG_CALLS, replays=BIG_REPLAYS)
          if case["dataset"] == "large" else {})
    n_pad, width = g.num_nodes_padded, case["L"]
    prec = case.get("precision", "high")
    one = prec == "fastest"
    case["ms"] = _time_ms(lambda: _scatter_call(case, g, stream_scatter,
                                                precision=prec), **kw)
    case["plain_ms"] = _time_ms(
        lambda: _scatter_call(case, g, stream_scatter_plain, precision=prec),
        **kw)
    if one:  # the f32 kernel at the same shape, the wrapper's bf16 cast,
        # and the one-limb kernel alone on a bf16 copy made once
        from pygat_tpu_torch.ops.stream import (
            launch_tile_sum,
            stream_scatter_bf16,
        )

        case["f32_ms"] = _time_ms(
            lambda: _scatter_call(case, g, stream_scatter), **kw)
        case["cast_ms"] = _time_ms(
            lambda: case["data"].to(torch.bfloat16), **kw)
        d16 = case["data"].to(torch.bfloat16)
        recv = case["side"] == "recv"
        walk = g.stream_walk if recv else g.sender_walk
        case["kernel_ms"] = _time_ms(lambda: launch_tile_sum(
            stream_scatter_bf16, d16, None if recv else g.c_slot, walk,
            n_pad), **kw)
        del d16
    # one PyTorch call computing the same sums: index_add_ into a zeroed
    # buffer with one scratch row taking the dead slots (of the data rounded
    # to bf16 under "fastest")
    if case["side"] == "recv":
        idx = torch.where(g.r_local < 128,
                          g.r_chunk.long().repeat_interleave(256) * 128
                          + g.r_local.long(), n_pad)
    else:
        idx = g.senders.long()
    lib_out = torch.zeros(n_pad + 1, width, device="cuda")
    src = case["data"].to(torch.bfloat16).float() if one else case["data"]
    case["library_ms"] = _time_ms(
        lambda: lib_out.index_add_(0, idx, src), **kw)
    del idx, lib_out, src
    idx_words = g.r_local.numel() + g.r_chunk.numel() + (
        g.c_slot.numel() if case["side"] == "send" else 0)
    # the live slots' data once (bf16 under "fastest"), the index words,
    # the f32 sums written
    n_bytes = ((2 if one else 4) * case["n_live"] * width
               + 4 * (idx_words + n_pad * width))
    case["bound_ms"], case["bound_by"] = _bound(n_bytes, case["n_live"] * width)
    f32 = (f" (the kernel alone {case['kernel_ms']:.4f} ms), f32 kernel "
           f"{case['f32_ms']:.4f} ms, bf16 cast {case['cast_ms']:.4f} ms"
           if one else "")
    print(f"  stream_scatter{'_bf16' if one else ''} {case['dataset']} "
          f"{case['path']} {case['side']} L={width}: "
          f"{case['ms']:.4f} ms{f32}, plain {case['plain_ms']:.4f} ms, "
          f"index_add_ {case['library_ms']:.4f} ms, bound "
          f"{case['bound_ms']:.5f} ms ({case['bound_by']})")


def _time_fused(kname, kernel, plain, case, g):
    """Time a fused-forward case of :func:`_stream_kernel_cases` over
    ``g``'s walk: the kernel, its plain version and the byte bound, into
    ``case`` (no one PyTorch call computes it)."""
    import torch

    args = case["args"]
    kw = (dict(calls=BIG_CALLS, replays=BIG_REPLAYS)
          if case["dataset"] == "large" else {})
    n_pad, h, f = g.num_nodes_padded, case["H"], case["F"]
    prec = case.get("precision", "high")
    one = prec == "fastest"
    case["ms"] = _time_ms(lambda: kernel(*args, walk=g.stream_walk,
                                         precision=prec), **kw)
    case["plain_ms"] = _time_ms(lambda: plain(*args, precision=prec), **kw)
    case["library_ms"] = None
    v1 = kname.startswith("fused_v1")
    if one:  # the f32 kernel at the same shape, the wrapper's bf16 casts,
        # and the one-limb kernel alone
        case["f32_ms"] = _time_ms(lambda: kernel(*args, walk=g.stream_walk),
                                  **kw)
        tables = args[:1] if v1 else args[:2]
        case["cast_ms"] = _time_ms(
            lambda: [t.to(torch.bfloat16) for t in tables], **kw)
        case["kernel_ms"] = _one_limb_kernel_ms(
            kname.replace("_bf16", ""), args, g.stream_walk, n_pad, **kw)
    n_live = case["n_live"]
    index_words = 2 * g.num_edges_padded + g.r_chunk.numel()
    # a sender table's value: 4 bytes, 2 in its one-limb bf16 copy
    tb = 2 if one else 4
    if v1:
        n_bytes = tb * n_pad * h * f + 4 * (
            2 * n_pad * h + h * f + n_live * h + index_words
            + n_pad * (h * f + h))
        n_flops = n_live * (4 * h * f + 6 * h)
    else:
        # each input once: the node tables whi and whj (their gathered rows
        # are re-read from L2, not from memory; under "fastest" whi in f32
        # for the receivers and both in bf16 for the senders), ub, a, a
        # live slot's keep factors, the index words; out and den written
        n_bytes = ((4 + 2 if one else 4) * n_pad * h * f
                   + tb * n_pad * h * f
                   + 4 * (n_pad * h + h * f + n_live * h + index_words
                          + n_pad * (h * f + h)))
        n_flops = n_live * (6 * h * f + 6 * h)
    case["bound_ms"], case["bound_by"] = _bound(n_bytes, n_flops)
    f32 = (f" (the kernel alone {case['kernel_ms']:.4f} ms), f32 kernel "
           f"{case['f32_ms']:.4f} ms, bf16 casts {case['cast_ms']:.4f} ms"
           if one else "")
    print(f"  {kname} {case['dataset']} H={h} F={f}: "
          f"{case['ms']:.4f} ms{f32}, plain {case['plain_ms']:.4f} ms, "
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


def _card_vs_cpu(label, cfg, x, graph, plan=None, rtol=MODEL_RTOL):
    """Forward and gradients of the model ``cfg`` on the card against the
    same model on the CPU (kernels against plain versions, end to end),
    the loss summing sin of the outputs of the graph's real rows, over the
    band plan or the corner plans ``plan`` when one is given; within
    ``rtol`` of the scale (:func:`_check_grads`)."""
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
          f"{err:.3e} (allowed {rtol * scale:.3e})")
    if err > rtol * scale:
        raise AssertionError("model forward on the card disagrees with the CPU")
    _check_grads(cfg, grads_c, grads_p, "card vs CPU", rtol)


def _zero_grads(cfg):
    """Per parameter leaf (:func:`parameters` order), whether its gradient
    is zero in exact arithmetic: the dense GATv2's ``a``, since its logit
    is per receiver (the reference's [N, 1] quirk) and so constant along
    its softmax row, which the softmax does not see."""
    if cfg.layer_type != "GATv2":
        return None
    return [False, True] + [False] * cfg.skip_connection


def _check_grads(cfg, got, want, what, rtol=MODEL_RTOL):
    """Raise unless each gradient in ``got`` is within ``rtol`` of the
    largest magnitude of its ``want``; a gradient that is zero in exact
    arithmetic (:func:`_zero_grads`), rounding noise on either side, is
    held on both to ``rtol`` of the model's largest gradient instead."""
    zero = _zero_grads(cfg)
    top = max(float(g.abs().max()) for g in want)
    for i, (gc, gp) in enumerate(zip(got, want)):
        if zero is not None and zero[i % len(zero)]:
            worst = max(float(gc.abs().max()), float(gp.abs().max()))
            print(f"  grad {i} {tuple(gp.shape)} (zero in exact arithmetic): "
                  f"largest {worst:.3e} (allowed {rtol * top:.3e})")
            if not worst <= rtol * top:
                raise AssertionError(f"model gradient {i} is not zero")
            continue
        gscale = max(1e-30, float(gp.abs().max()))
        gerr = float((gc - gp).abs().max())
        print(f"  grad {i} {tuple(gp.shape)}: max_abs_err {gerr:.3e} "
              f"(allowed {rtol * gscale:.3e})")
        if not (gerr <= rtol * gscale):
            raise AssertionError(f"model gradient disagrees, {what}")


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


def _preset_cfg(name, layer_type, ds):
    """The reference preset of dataset ``name`` for ``layer_type``, its
    input width that of ``ds``'s padded features."""
    from pygat_tpu_torch.models.gat import GATConfig
    from pygat_tpu_torch.models.presets import PRESETS

    cfg = GATConfig(layer_type=layer_type, **PRESETS[name])
    return cfg._replace(nfeats=(int(ds.features.shape[1]),) + cfg.nfeats[1:])


def _model_card_vs_cpu(layer_type, cora, plan=None):
    """:func:`_card_vs_cpu` of the Cora model over the receiver stream, or
    over the band plan or the corner plans ``plan``; returns its config."""
    from pygat_tpu_torch.ops.banded import BandPlan

    cfg = _preset_cfg("cora", layer_type, cora)
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


def _banded_cases(label, g, plan, heads, feats, gen, precision="high"):
    """The calls one train step of each model makes over ``plan``, per
    layer, with inputs of their shapes: the fused forward, and in the
    backward banded_take of the sender rows (GATv1: wh, L = HF; GATv2:
    [whj | whi], 2HF), one expand of the receiver operands (GATv1: [f_dst |
    bound | g_out | g_den], 3H + HF; GATv2: [whi | ub | g_out | g_den],
    2HF + 2H), stream_scatter per receiver (GATv1: H; GATv2: HF) and
    banded_sender_sum per sender (GATv1: HF; GATv2: 2HF). Under "fastest"
    the one-limb kernels of the fused forward, the take and the sender sum
    (their names with ``_bf16``), whose f32 moves and receiver sum the
    other phases hold."""
    import torch

    one = precision == "fastest"
    live = (plan.r_local < 128)[:, None]
    cases = []
    for path, make in (("v1", _fused_inputs), ("v2", _fused_v2_inputs)):
        for h, f in zip(heads, feats):
            hf = h * f
            base = dict(dataset=label, path=path, H=h, F=f,
                        n_live=int(live.sum()), precision=precision)
            cases.append(dict(base, kernel=f"fused_{path}_banded"
                              + ("_bf16" if one else ""),
                              args=make(g, h, f, gen, plan)))
            widths = (dict(banded_take=hf, expand=3 * h + hf,
                           stream_scatter=h, banded_sender_sum=hf)
                      if path == "v1" else
                      dict(banded_take=2 * hf, expand=2 * hf + 2 * h,
                           stream_scatter=hf, banded_sender_sum=2 * hf))
            for kname, width in widths.items():
                if one and kname in ("expand", "stream_scatter"):
                    continue
                rows = plan.n_pad if kname in ("banded_take", "expand") else (
                    plan.num_slots)
                data = torch.randn(rows, width, generator=gen, device="cuda")
                if kname == "stream_scatter":
                    data = data * live  # the backward's rows are 0 there
                cases.append(dict(base, kernel=kname + ("_bf16" if one
                                                        else ""),
                                  L=width, data=data))
    return cases


def _banded_call(case, plan, plain=False, f64=False, magnitude=False):
    """One call of ``case``'s kernel (or its plain version, for a fused
    forward or a segment sum evaluated in f64 with ``f64``; a fused
    forward's sum over |message| with ``magnitude``) over ``plan`` at the
    case's precision: ``stream_scatter`` over the plan's receiver walk, as
    the banded backward calls it."""
    from pygat_tpu_torch.ops import banded, large, stream

    k = case["kernel"]
    kw = {"f64": True} if f64 else {}
    if magnitude:
        kw["magnitude"] = True
    if k == "expand":
        fn = large.expand_plain if plain else large.expand
        return fn(case["data"], plan.r_local, plan.r_chunk)
    if k == "stream_scatter":
        if not plain:
            return banded._receiver_sum(case["data"], plan)
        return stream.stream_scatter_plain(case["data"], plan.r_local,
                                           plan.r_chunk, plan.n_pad, **kw)
    base = k.removesuffix("_bf16")
    prec = dict(precision=case.get("precision", "high"))
    fn = getattr(banded, base + ("_plain" if plain else ""))
    if base == "banded_take":
        return fn(case["data"], plan, **prec)
    if base == "banded_sender_sum":
        return fn(case["data"], plan, **kw, **prec)
    return fn(*case["args"], **kw, **prec)


def _check_banded(case, plan):
    """``case``'s kernel against its plain version: the gathers bit-exact,
    the segment sums to KERNEL_RTOL of the same sums over |data| (their
    plain versions in f64; the sender sum's data on dead slots too), the
    fused forward to KERNEL_RTOL of its largest output (its plain version
    in f64); the segment sums and the fused forward, called again, equal
    bit for bit."""
    import torch

    k = case["kernel"]
    base = k.removesuffix("_bf16")
    got = _banded_call(case, plan)
    want = _banded_call(case, plan, plain=True,
                        f64=base not in ("expand", "banded_take"))
    torch.cuda.synchronize()
    if k == "expand":
        err = float((got - want).abs().max())
        note = "bit-exact" if torch.equal(got, want) else "NOT bit-exact"
        ok = torch.equal(got, want)
    elif base == "banded_take":
        err = float((got.float() - want.float()).abs().max())
        case["bitwise_repeat"] = torch.equal(got, _banded_call(case, plan))
        ok = torch.equal(got, want) and case["bitwise_repeat"]
        note = (("bit-exact" if torch.equal(got, want) else "NOT bit-exact")
                + "; a second call " + ("equal bit for bit"
                                        if case["bitwise_repeat"]
                                        else "NOT equal bit for bit"))
    elif base in ("stream_scatter", "banded_sender_sum"):
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
        if base == k:
            e1, a1 = _max_err(out, out_p)
            held, out_note = e1 <= a1, f"allowed {a1:.3e}"
        else:  # one limb: FASTEST_RTOL of the same sum over |message|
            mag, _ = _banded_call(case, plan, plain=True, f64=True,
                                  magnitude=True)
            e1, share = _fastest_share(out, out_p, mag)
            held = share <= 1.0
            out_note = f"worst element at {share:.3f} of its allowance"
        e2, a2 = _max_err(den, den_p)
        err = max(e1, e2)
        again = _banded_call(case, plan)
        case["bitwise_repeat"] = (torch.equal(out, again[0])
                                  and torch.equal(den, again[1]))
        note = (f"out {e1:.3e} ({out_note}), den {e2:.3e} (allowed "
                f"{a2:.3e}); a second call "
                + ("equal bit for bit" if case["bitwise_repeat"]
                   else "NOT equal bit for bit"))
        ok = held and e2 <= a2 and case["bitwise_repeat"]
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
    only), each output written once, over the card's memory rate. A
    one-limb case is timed beside the f32 kernel at the same shape, its
    wrapper's bf16 cast, and the kernel alone on a bf16 copy made once;
    its bound counts the table or data and the sender tables in bf16."""
    import torch

    kw = dict(calls=BIG_CALLS, replays=BIG_REPLAYS) if big else {}
    k = case["kernel"]
    base = k.removesuffix("_bf16")
    one = base != k
    n, e, c = plan.n_pad, plan.num_slots, plan.num_chunks
    n_live = case["n_live"]
    case["ms"] = _time_ms(lambda: _banded_call(case, plan), **kw)
    case["plain_ms"] = _time_ms(lambda: _banded_call(case, plan, plain=True),
                                **kw)
    case["library_ms"] = None
    if one:
        case["f32_ms"] = _time_ms(lambda: _banded_call(
            dict(case, kernel=base, precision="high"), plan), **kw)
        case["cast_ms"], case["kernel_ms"] = _one_limb_banded_ms(case, plan,
                                                                 kw)
    vb = 2 if one else 4  # bytes of a table or data value the kernel reads
    if base in ("expand", "banded_take"):
        width = case["L"]
        # index_select of rows from the table with one zero row appended,
        # which the dead slots name (of the table rounded to bf16, as bf16,
        # under "fastest")
        idx = _slot_rows(plan, "recv" if k == "expand" else "send")
        padded = torch.cat([case["data"],
                            torch.zeros(1, width, device="cuda")])
        if one:
            padded = padded.to(torch.bfloat16)
        case["library_ms"] = _time_ms(
            lambda: torch.index_select(padded, 0, idx), **kw)
        n_bytes, n_flops = vb * (n * width + e * width) + 4 * (e + c), 0
    elif base in ("stream_scatter", "banded_sender_sum"):
        width = case["L"]
        # index_add_ into a zeroed buffer with one scratch row taking the
        # dead slots (of the data rounded to bf16 under "fastest")
        idx = _slot_rows(plan, "recv" if k == "stream_scatter" else "send")
        lib_out = torch.zeros(n + 1, width, device="cuda")
        src = case["data"].to(torch.bfloat16).float() if one else case["data"]
        case["library_ms"] = _time_ms(
            lambda: lib_out.index_add_(0, idx, src), **kw)
        n_bytes = vb * n_live * width + 4 * (e + c + n * width)
        n_flops = n_live * width
    else:
        h, f = case["H"], case["F"]
        index_words = 2 * e + 2 * c  # s_loc, r_local; band, r_chunk
        v1 = base == "fused_v1_banded"
        narrow = 2 if v1 else 1
        # the sender tables (v1: wh; v2: whj and whi) in the kernel's type,
        # v2's receiver whi in f32 once more under "fastest"
        tables = vb * (1 if v1 else 2) * n * h * f + (
            4 * n * h * f if one and not v1 else 0)
        n_bytes = tables + 4 * (narrow * n * h + h * f + n_live * h
                                + index_words + n * (h * f + h))
        n_flops = n_live * ((4 if v1 else 6) * h * f + 6 * h)
    case["bound_ms"], case["bound_by"] = _bound(n_bytes, n_flops)
    lib = "" if case["library_ms"] is None else (
        f", library {case['library_ms']:.4f} ms")
    f32 = (f" (the kernel alone {case['kernel_ms']:.4f} ms), f32 kernel "
           f"{case['f32_ms']:.4f} ms, bf16 cast {case['cast_ms']:.4f} ms"
           if one else "")
    shape = f"H={case['H']} F={case['F']}" + (
        f" L={case['L']}" if "L" in case else "")
    print(f"  {k} {case['dataset']} {case['path']} {shape}: "
          f"{case['ms']:.4f} ms{f32}, plain {case['plain_ms']:.4f} ms{lib}, "
          f"bound {case['bound_ms']:.5f} ms ({case['bound_by']})")


def _one_limb_banded_ms(case, plan, kw):
    """(ms of the wrapper's bf16 cast, ms of the one-limb kernel alone on a
    bf16 copy made once) of a one-limb banded case: the take and the sender
    sum cast their table or data, the fused forwards their sender tables
    (GATv2: whj and whi)."""
    import torch

    from pygat_tpu_torch.ops import banded, build
    from pygat_tpu_torch.ops.stream import launch_tile_sum

    bf = lambda t: t.to(torch.bfloat16)  # noqa: E731
    k = case["kernel"]
    if k in ("banded_take_bf16", "banded_sender_sum_bf16"):
        data = case["data"]
        cast_ms = _time_ms(lambda: bf(data), **kw)
        d16 = bf(data)
        if k == "banded_take_bf16":
            out = torch.empty(plan.num_slots, case["L"], dtype=torch.bfloat16,
                              device="cuda")
            kernel_ms = _time_ms(lambda: build.launch(
                banded.banded_take_bf16, d16, plan.band, plan.s_loc,
                plan.num_chunks, plan.w, case["L"], out), **kw)
        else:
            walk = plan.sender_walk
            kernel_ms = _time_ms(lambda: launch_tile_sum(
                banded.banded_sender_sum_bf16, d16, walk.order, walk,
                plan.n_pad), **kw)
        return cast_ms, kernel_ms
    args = case["args"]
    if k == "fused_v1_banded_bf16":
        wh, f_dst, bound, a_src, keepq = args[:5]
        cast_ms = _time_ms(lambda: bf(wh), **kw)
        tables, a = (bf(wh), f_dst, bound, a_src, keepq), a_src
    else:
        whi, whj, ub, a, keepq = args[:5]
        cast_ms = _time_ms(lambda: (bf(whi), bf(whj)), **kw)
        tables = (whi, bf(whi), bf(whj), ub, a, keepq)
    wrapper = getattr(banded, k)
    return cast_ms, _time_ms(lambda: banded._launch_banded(
        wrapper, tables, a, plan, args[-1]), **kw)



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


def _window_cases(label, g, plans, heads, feats, gen, precision="high"):
    """The window forwards of one forward of each model, per layer, over
    windows that ``gather_corner`` builds from node tables and bounds as
    the layers build them, checked against their plain versions (in f64)
    to KERNEL_RTOL of their largest output (under "fastest", the one-limb
    kernels, out to FASTEST_RTOL of the same sum over |message|) and,
    called again, to repeat bit for bit. Returns the cases."""
    import torch

    from pygat_tpu_torch.ops import fused_corner as fc

    cases = []
    one = precision == "fastest"
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
            kw = dict(precision=precision)
            out, den = kernel(*args, walk=g.stream_walk, **kw)
            out_p, den_p = plain(*args, f64=True, **kw)
            torch.cuda.synchronize()
            if one:
                e1, share = _fastest_out_err(out, plain, args)
                held, note = share <= 1.0, (f"worst element at {share:.3f} "
                                            "of its allowance")
            else:
                e1, a1 = _max_err(out, out_p)
                held, note = e1 <= a1, f"allowed {a1:.3e}"
            e2, a2_ = _max_err(den, den_p)
            again = kernel(*args, walk=g.stream_walk, **kw)
            repeat = torch.equal(out, again[0]) and torch.equal(den, again[1])
            name += "_bf16" if one else ""
            print(f"  {name} {label} H={h} F={f}: max_abs_err out {e1:.3e} "
                  f"({note}), den {e2:.3e} (allowed {a2_:.3e}); a second "
                  f"call {'' if repeat else 'NOT '}equal bit for bit")
            if not held or e2 > a2_ or not repeat:
                raise AssertionError(f"{name} disagrees with its plain version")
            cases.append(dict(dataset=label, kernel=name, H=h, F=f, args=args,
                              max_abs_err=max(e1, e2), bitwise_repeat=repeat,
                              n_live=n_live, n_pad=g.num_nodes_padded,
                              n_chunks=g.r_chunk.numel(),
                              walk=g.stream_walk, precision=precision))
            del out, den, out_p, den_p, again
    return cases


def _time_window(case, big):
    """Device ms of a window forward and its plain version, and the bound:
    each input read once (the window's live rows, the receiver-side node
    tables, a live slot's keep factors, the index words), out and den
    written once. A one-limb case is timed beside the f32 kernel at the
    same shape, its wrapper's bf16 cast of the window, and the kernel
    alone on a bf16 copy made once; its bound counts the window in
    bf16."""
    import torch

    from pygat_tpu_torch.ops import fused_corner as fc
    from pygat_tpu_torch.ops.fused_stream import launch_tile_fused

    kw = dict(calls=BIG_CALLS, replays=BIG_REPLAYS) if big else {}
    k, args = case["kernel"], case["args"]
    base = k.removesuffix("_bf16")
    one = base != k
    prec = dict(precision=case.get("precision", "high"))
    case["ms"] = _time_ms(lambda: getattr(fc, base)(*args, walk=case["walk"],
                                                    **prec), **kw)
    case["plain_ms"] = _time_ms(
        lambda: getattr(fc, base + "_plain")(*args, **prec), **kw)
    case["library_ms"] = None
    h, f, n, n_live = case["H"], case["F"], case["n_pad"], case["n_live"]
    v1 = base == "fused_v1_window"
    if one:  # the f32 kernel at the same shape, the wrapper's cast, and
        # the one-limb kernel alone on a bf16 copy of the window
        case["f32_ms"] = _time_ms(
            lambda: getattr(fc, base)(*args, walk=case["walk"]), **kw)
        win = args[0] if v1 else args[1]
        case["cast_ms"] = _time_ms(lambda: win.to(torch.bfloat16), **kw)
        w16 = win.to(torch.bfloat16)
        tables = ((w16, *args[1:5]) if v1
                  else (args[0], w16, *args[2:5]))
        a = args[3]
        case["kernel_ms"] = _time_ms(lambda: launch_tile_fused(
            getattr(fc, k), tables, a, n, case["walk"], args[-1]), **kw)
        del w16
    vb = 2 if one else 4  # bytes of a window value the kernel reads
    index_words = args[5].numel() + case["n_chunks"]
    if v1:
        n_bytes = vb * n_live * h * f + 4 * (
            2 * n * h + h * f + n_live * h + index_words + n * (h * f + h))
        n_flops = n_live * (4 * h * f + 6 * h)
    else:
        n_bytes = vb * n_live * 2 * h * f + 4 * (
            n * h * f + n * h + h * f + n_live * h + index_words
            + n * (h * f + h))
        n_flops = n_live * (6 * h * f + 6 * h)
    case["bound_ms"], case["bound_by"] = _bound(n_bytes, n_flops)
    f32 = (f" (the kernel alone {case['kernel_ms']:.4f} ms), f32 kernel "
           f"{case['f32_ms']:.4f} ms, bf16 cast {case['cast_ms']:.4f} ms"
           if one else "")
    print(f"  {k} {case['dataset']} H={h} F={f}: {case['ms']:.4f} ms{f32}, "
          f"plain {case['plain_ms']:.4f} ms, bound {case['bound_ms']:.5f} ms "
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


def _one_limb_names(counts, precision):
    """``counts`` with each kernel that has a one-limb twin renamed to it
    under "fastest" (expand and the corner passes, f32 moves in both modes,
    keep their names)."""
    from pygat_tpu_torch.ops import build

    if precision != "fastest":
        return counts
    return {(f"{k}_bf16" if f"{k}_bf16" in build.WRAPPERS else k): v
            for k, v in counts.items()}


def _want_corner(fused_name, epochs, fast, k_f, k_i, precision="high"):
    """The launches a corner run makes through the wrappers, and those one
    replay of the fast loop's captured epoch holds, for plans of ``k_f``
    forward and ``k_i`` inverse passes: per epoch 2 layers x (train + eval
    forward) of one expand, k_f passes and the window forward each, and per
    layer's backward the window again (expand, k_f passes), one expand of
    the receiver operands, k_i inverse passes and 2 stream_scatters; the
    test forward adds one forward per layer. The fast loop's wrappers see
    the eager warm-up epoch and the captured one. Under "fastest" the
    window forward and the sums are the one-limb kernels."""
    per_epoch = {fused_name: 4, "expand": 8, "stream_scatter": 4,
                 "corner_permute": 6 * k_f + 2 * k_i}
    calls = 2 if fast else epochs
    wrappers = {k: v * calls for k, v in per_epoch.items()}
    for k, v in ((fused_name, 2), ("expand", 2), ("corner_permute", 2 * k_f)):
        wrappers[k] += v
    return (_one_limb_names(wrappers, precision),
            _one_limb_names(per_epoch, precision) if fast else {})


BACKWARD_KERNELS = ("banded_take", "expand", "stream_scatter",
                    "banded_sender_sum")


def _want_banded(fused_name, epochs, fast, precision="high"):
    """The launches a banded run makes through the wrappers, and those one
    replay of the fast loop's captured epoch holds: per epoch 2 layers x
    (train forward + eval forward) fused and one call of each backward
    kernel per layer; the test forward adds 2 fused. The fast loop's
    wrappers see the eager warm-up epoch and the captured one. Under
    "fastest" the fused forward, the take and both sums are the one-limb
    kernels."""
    per_epoch = {fused_name: 4, **dict.fromkeys(BACKWARD_KERNELS, 2)}
    calls = 2 if fast else epochs
    wrappers = {k: v * calls for k, v in per_epoch.items()}
    wrappers[fused_name] += 2
    return (_one_limb_names(wrappers, precision),
            _one_limb_names(per_epoch, precision) if fast else {})


def _train_large(label, fit, cfg, data, counters, jsonl, corner=False,
                 precision="high", **kw):
    """One trainer run on the large graph at the module default
    ``precision``, every launch counter set to 0 just before and read just
    after. Checks that the trainer chose the band plan (or, with
    ``corner``, the corner plans) by itself, finite losses, a falling
    validation loss, and the launch counts (under "fastest" the one-limb
    kernels, and no f32 twin of theirs).
    Returns (launches, train losses, result, replayed launches)."""
    from pygat_tpu_torch.models.presets import TRAIN_PRESETS
    from pygat_tpu_torch.train.logging import TrainLogger

    if os.path.exists(jsonl):
        os.remove(jsonl)
    logger = TrainLogger(jsonl_path=jsonl, stream=io.StringIO())
    for fn in counters.values():
        fn.launches = 0
    with _precision(precision):
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
    print(f"phase {4 if precision == 'high' else 13}: {label}: train losses "
          f"{losses}; validation losses {val}", flush=True)
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
        want, want_captured = _want_corner(fused_name, epochs, fast, k_f, k_i,
                                           precision)
        chosen = (f"corner plans chosen by the trainer: {plans[0]['rows']} "
                  f"rows, spans {plans[0]['p']}, overflow rows "
                  f"{plans[0]['overflow']}")
    else:
        fused_name = "fused_v2_banded" if cfg.is_v2 else "fused_v1_banded"
        want, want_captured = _want_banded(fused_name, epochs, fast,
                                           precision)
        chosen = (f"band plan chosen by the trainer: w {plans[0]['w']}, "
                  f"{plans[0]['chunks']} chunks, {plans[0]['slots']} slots, "
                  f"fill {plans[0]['fill']:.4f}")
    captured = {k: v for k, v in result.captured_launches.items() if v}
    replays = result.graph_replays
    by_replay = {k: replays * v for k, v in captured.items()}
    print(f"phase {4 if precision == 'high' else 13}: {label}: {chosen}; "
          "wrapper launches "
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


def _large_epoch_ms(cfg, data, plans, precisions=None):
    """Host ms per epoch of the fast loop on the large graph over each of
    ``plans`` (name -> a band plan, corner plans, or None: the receiver
    stream), at the module default precision ``precisions[name]`` when
    given. One captured epoch lives on the card at a time (two captured
    GATv2_sparse epochs at 524k with their private pools can take most of
    the 80 GB): each visit captures its plan's epoch (one warm-up chunk),
    times LARGE_TIMED_CHUNKS chunks of LARGE_CHUNK epochs and frees it; the
    plans are visited in LARGE_ROUNDS rounds, the order reversed from round
    to round. Returns the sorted samples per plan and the most memory
    allocated on the card during a visit, in GiB."""
    import torch

    from pygat_tpu_torch.ops import segment
    from pygat_tpu_torch.tools.profile_epoch import epoch_runners

    samples = {k: [] for k in plans}
    peak = 0.0
    names = list(plans)
    for r in range(LARGE_ROUNDS):
        for k in names if r % 2 == 0 else names[::-1]:
            torch.cuda.reset_peak_memory_stats()
            prec = (precisions or {}).get(k, segment._STREAM_PRECISION)
            with _precision(prec):
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
                       lambda v, d, lay=lay: ops.panel_spmm_graph(
                           v, d, g, lay, precision="high"),
                       inp["w"], {"panel_spmm": 1}))
        if name == label:
            routes.append((f"panel_spmm_graph ({name} layout, plans=)",
                           lambda v, d, lay=lay: ops.panel_spmm_graph(
                               v, d, g, lay, plans=plans, precision="high"),
                           inp["w"],
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
             lambda v, d: ops.spmm_banded(v, d, plan, precision="high"),
             vals_b,
             {"spmm_banded": 1, "banded_take": 1, "expand": 1,
              "banded_sender_sum": 1}),
            ("spmm_banded (two-pass)",
             lambda v, d: ops.spmm_banded(v, d, plan, fused=False,
                                          precision="high"), vals_b,
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
                         inp["vals_b"], inp["x"], plan, precision="high"),
                     "two_pass": lambda plan=plan, inp=inp: ops.spmm_banded(
                         inp["vals_b"], inp["x"], plan, fused=False,
                         precision="high")},
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
                         inp["w"], inp["x"], g, lay, precision="high"),
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


def _spmm_fastest_routes(label, spec, inp):
    """(route, op of (values, x), values, launches one forward and backward
    make, how the route rounds) of every SpMM op under "fastest" on graph
    ``label``: the panel layouts with and without the corner backward, the
    corner plans, and the band plan's fused and two-pass forms (values in
    banded order, as :func:`_spmm_routes` leaves them in ``inp``). The
    rounding is :func:`_spmm_plain_rounded`'s keywords."""
    from pygat_tpu_torch import ops

    g, plans = spec["graph"], spec["corner"]
    k = len(plans.fwd.passes) + len(plans.inv.passes)
    routes = []
    for name, lay in spec["layouts"].items():
        routes.append((f"panel_spmm_graph ({name} layout)",
                       lambda v, d, lay=lay: ops.panel_spmm_graph(
                           v, d, g, lay, precision="fastest"),
                       inp["w"], {"panel_spmm_bf16": 1},
                       dict(layout=lay, one_limb_dx=False)))
        if name == label:
            routes.append((f"panel_spmm_graph ({name} layout, plans=)",
                           lambda v, d, lay=lay: ops.panel_spmm_graph(
                               v, d, g, lay, plans=plans,
                               precision="fastest"), inp["w"],
                           {"panel_spmm_bf16": 1, "expand": 2,
                            "corner_permute": k, "stream_scatter_bf16": 1},
                           dict(layout=lay)))
    routes.append(("spmm_corner_graph",
                   lambda v, d: ops.spmm_corner_graph(v, d, g, plans,
                                                      precision="fastest"),
                   inp["w"], {"expand": 2, "corner_permute": k,
                              "stream_scatter_bf16": 2},
                   dict(round_rows=False)))
    plan = spec["band"]
    if plan is not None:
        routes += [
            ("spmm_banded (fused)",
             lambda v, d: ops.spmm_banded(v, d, plan, precision="fastest"),
             inp["vals_b"], {"spmm_banded_bf16": 1, "banded_take_bf16": 1,
                             "expand": 1, "banded_sender_sum_bf16": 1},
             dict(round_values=True, banded=True)),
            ("spmm_banded (two-pass)",
             lambda v, d: ops.spmm_banded(v, d, plan, fused=False,
                                          precision="fastest"),
             inp["vals_b"], {"banded_take_bf16": 2, "stream_scatter_bf16": 1,
                             "expand": 1, "banded_sender_sum_bf16": 1},
             dict(banded=True))]
    return routes


def _spmm_plain_rounded(g, w, x, ct, *, round_rows=True, round_values=False,
                        banded=False, layout=None, one_limb_dx=True):
    """(out, d values, d x) of the SpMM for the cotangent ``ct`` in plain
    PyTorch on the card (row gathers, ``index_add_``), each message rounded
    to bf16 as a route under "fastest" forms it: ``v * bf16(x)``
    (``round_rows``; the corner route's ``v * x`` without), ``bf16(v)`` with
    ``round_values`` (the fused banded form); over a panel ``layout`` the
    overflow slots' messages stay f32 over the unrounded x. d values reads
    x's rows rounded to bf16 over a band plan (``banded``: the reference's
    rounded take), else unrounded; d x sums bf16-rounded ``v * ct[r]`` per
    sender (``one_limb_dx``), or f32 ones (the panel backward without
    plans, f32 as the reference's)."""
    import torch

    def bf(t):
        return t.to(torch.bfloat16).float()

    s, r = g.senders.long(), g.receivers.long()
    v = torch.where(g.edge_mask, w, 0.0)
    xs = x[s]
    msgs = bf((bf(v) if round_values else v)[:, None]
              * (bf(xs) if round_rows else xs))
    if layout is not None:
        fits = (layout.g_idx < layout.n_panels * 128) & (g.r_local < 128)
        msgs = torch.where(fits[:, None], msgs, v[:, None] * xs)
    out = torch.zeros_like(x).index_add_(0, r, msgs)
    del msgs
    g_r = ct[r]
    rows = bf(xs) if banded else xs
    dv = torch.where(g.edge_mask, (g_r * rows).sum(-1), 0.0)
    del rows, xs
    d_msgs = v[:, None] * g_r
    if one_limb_dx:
        d_msgs = bf(d_msgs)
    return out, dv, torch.zeros_like(x).index_add_(0, s, d_msgs)


def _spmm_fastest_path(specs, inputs, counters):
    """The SpMM path under "fastest" (one bf16 limb): every op of the
    family that takes a precision, forward and backward, at SPMM_L on each
    graph, through the entry points a user calls, each held to the plain
    SpMM under the route's own rounding (:func:`_spmm_plain_rounded`) to
    KERNEL_RTOL of max(1, max |want|): both sides round each message alike,
    so only the order of the f32 sums differs. Each call's launches
    (forward and backward) must be as the route states: the one-limb SpMM
    kernels and segment sums, never an f32 one. Returns the route errors."""
    import torch

    errors = {}
    for label, spec in specs.items():
        g, inp = spec["graph"], inputs[label]
        w, x, ct = inp["w"], inp["x"], inp["ct"]
        for route, fn, vals, want, rounding in _spmm_fastest_routes(
                label, spec, inp):
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
            plain = _spmm_plain_rounded(g, w, x, ct, **rounding)
            checks = [(what, _held(a, b)) for what, a, b in zip(
                ("out", "d values", "d x"), got, plain)]
            errors[f"{label} {route}"] = max(c[1][0] for c in checks)
            print(f"  {label} {route} under 'fastest': launches {made}; "
                  + "; ".join(f"{what} vs plain (same rounding) {e:.3e} "
                              f"(allowed {a:.3e})"
                              for what, (e, a, _) in checks), flush=True)
            if made != want:
                raise AssertionError(f"{label} {route} under 'fastest': "
                                     f"launches {made}, want {want}")
            if not all(ok for _, (_, _, ok) in checks):
                raise AssertionError(f"{label} {route} under 'fastest' "
                                     "disagrees")
            del got, plain
    return errors


def _sparse_mm_bf16(lib, x):
    """``torch.sparse.mm`` of the CSR ``lib`` and ``x`` in bf16 (values
    and x cast once), and None where PyTorch runs no bf16 sparse product
    on the card (it raises then)."""
    import torch

    lib16 = torch.sparse_csr_tensor(
        lib.crow_indices(), lib.col_indices(),
        lib.values().to(torch.bfloat16), size=lib.shape)
    x16 = x.to(torch.bfloat16)
    try:
        torch.sparse.mm(lib16, x16)
        torch.cuda.synchronize()
    except RuntimeError as exc:
        print(f"  torch.sparse.mm in bf16 does not run here: "
              f"{str(exc).splitlines()[0]}", flush=True)
        return None
    return lambda: torch.sparse.mm(lib16, x16)


def _spmm_fastest_kernel_cases(specs, inputs):
    """Rows 7 and 9 one-limb (``spmm_banded_bf16``, ``panel_spmm_bf16``)
    at the SpMM path's shapes at SPMM_L (the 524k band plan; the Pubmed
    layout and both 524k layouts; the hub's band plan and layout) and at
    SPMM_ODD_L, whose rows the kernels read by scalars (the Pubmed layout,
    the hub's band plan and layout), each held against its plain version
    under "fastest" in f64 to KERNEL_RTOL of the same sums over |message|
    (both sides round each message alike, so only the order of the sums
    differs), and called twice: the two results must agree bit for bit.
    Each case carries what ``_time_spmm_fastest`` times."""
    import torch

    from pygat_tpu_torch.ops import build
    from pygat_tpu_torch.ops.banded import (
        banded_weighted_sum,
        banded_weighted_sum_bf16,
        banded_weighted_sum_plain,
    )
    from pygat_tpu_torch.ops.panel import (
        panel_weighted_sum,
        panel_weighted_sum_bf16,
        panel_weighted_sum_plain,
    )
    from pygat_tpu_torch import ops

    cases = []
    for label, spec in specs.items():
        g, inp = spec["graph"], inputs[label]
        n_pad, e_s = g.num_nodes_padded, g.num_edges_padded
        widths = (SPMM_L,) if label == "large" else (SPMM_L, SPMM_ODD_L)
        for width in widths:
            x = inp["x"] if width == SPMM_L else inp["x"][:, :width].contiguous()
            lib = _library_csr(g, inp["w"])
            plan = spec["band"]
            if plan is not None:
                vb = inp["vals_b"]
                walk = plan.spmm_walk
                n_split = plan.split_at.numel()
                bargs = (vb, x, plan)
                cases.append(dict(
                    kernel="spmm_banded_bf16", dataset=label, L=width,
                    n_live=int((plan.s_loc < plan.w * 128).sum()),
                    run=lambda a=bargs: banded_weighted_sum(
                        *a, precision="fastest"),
                    twin=lambda a=bargs: banded_weighted_sum_bf16(*a),
                    f32=lambda a=bargs: banded_weighted_sum(*a),
                    plain=lambda a=bargs: banded_weighted_sum_plain(
                        *a, precision="fastest"),
                    oracle=lambda a=bargs: banded_weighted_sum_plain(
                        *a, precision="fastest", f64=True),
                    mag=lambda a=bargs: banded_weighted_sum_plain(
                        *a, precision="fastest", magnitude=True),
                    op=lambda a=bargs: ops.spmm_banded(*a),
                    entry=(banded_weighted_sum_bf16,
                           lambda x16, out, part, vb=vb, walk=walk,
                           plan=plan, n_split=n_split, width=width: (
                               vb, x16, walk.rows, walk.local, walk.order,
                               plan.tile_ptr, plan.split_at,
                               plan.n_pad // 128, n_split, width, out,
                               part)),
                    lib=lib, x=x, split_at=n_split,
                    n_bytes=(4 * (3 * plan.num_slots + 2 * plan.num_chunks
                                  + plan.n_pad * width)
                             + 2 * plan.n_pad * width)))
            for name, lay in spec["layouts"].items():
                if width != SPMM_L and name.startswith("large"):
                    continue
                largs = (inp["w"], x, lay.panel_tiles, lay.g_idx,
                         g.edge_mask, g.r_local, g.r_chunk, lay.tile_ptr,
                         lay.split_at)
                fits = ((lay.g_idx < lay.n_panels * 128) & (g.r_local < 128)
                        & g.edge_mask)
                n_split = lay.split_at.numel()
                cases.append(dict(
                    kernel="panel_spmm_bf16", dataset=name, L=width,
                    P=lay.n_panels, n_live=int(fits.sum()),
                    run=lambda a=largs: panel_weighted_sum(
                        *a, precision="fastest"),
                    twin=lambda a=largs: panel_weighted_sum_bf16(*a),
                    f32=lambda a=largs: panel_weighted_sum(*a),
                    plain=lambda a=largs: panel_weighted_sum_plain(
                        *a, precision="fastest"),
                    oracle=lambda a=largs: panel_weighted_sum_plain(
                        *a, precision="fastest", f64=True),
                    mag=lambda a=largs: panel_weighted_sum_plain(
                        *a, precision="fastest", magnitude=True),
                    op=lambda g=g, lay=lay, w=inp["w"], x=x:
                        ops.panel_spmm_graph(w, x, g, lay),
                    entry=(panel_weighted_sum_bf16,
                           lambda x16, out, part, a=largs, lay=lay,
                           n_split=n_split, width=width, n_pad=n_pad: (
                               a[0], a[4], x16, *a[2:4], *a[5:],
                               n_pad // 128, n_split, lay.n_panels, width,
                               out, part)),
                    lib=lib, x=x, split_at=n_split,
                    n_bytes=(4 * (3 * e_s + g.r_chunk.numel()
                                  + lay.panel_tiles.numel() + n_pad * width)
                             + e_s + 2 * n_pad * width)))
    for case in cases:
        counts = build.launch_counts()
        got, again = case["run"](), case["twin"]()
        torch.cuda.synchronize()
        made = {k: v - counts[k] for k, v in build.launch_counts().items()
                if v != counts[k]}
        if made != {case["kernel"]: 2}:
            raise AssertionError(f"{case['kernel']}: launched {made}")
        want, mag = case.pop("oracle")(), case.pop("mag")()
        err = float((got - want).abs().max())
        worst = float(((got - want).abs()
                       / (KERNEL_RTOL * mag + 1e-30)).max())
        case["max_abs_err"] = err
        case["bitwise_repeat"] = bool(torch.equal(got, again))
        case["precision"] = "fastest"
        shape = f"L={case['L']}" + (f" P={case['P']}" if "P" in case else "")
        print(f"  {case['kernel']} {case['dataset']} {shape} "
              f"({case['split_at']} extra pieces of split tiles): kernel vs "
              f"plain under 'fastest' in f64 max_abs_err {err:.3e}, worst "
              f"element at {worst:.3f} of KERNEL_RTOL of its sum over "
              f"|message|; two calls equal bit for bit: "
              f"{case['bitwise_repeat']}", flush=True)
        if not (bool(torch.isfinite(got).all()) and worst <= 1.0):
            raise AssertionError(f"{case['kernel']} disagrees with its plain "
                                 "version under 'fastest'")
        if not case["bitwise_repeat"]:
            raise AssertionError(f"{case['kernel']}: two calls on the same "
                                 "inputs differ")
        del got, again, want, mag
    return cases


def _time_spmm_fastest(case):
    """Device ms of a one-limb SpMM case: the wrapper with its bf16 cast of
    x (``ms``), the kernel alone on a bf16 copy made once (``kernel_ms``),
    the cast alone (``cast_ms``), the f32 kernel at the same shape
    (``f32_ms``), the plain version under "fastest" (``plain_ms``), the
    op's forward around it (``op_ms``), and ``torch.sparse.mm`` of the same
    weighted graph in f32 (``library_f32_ms``) and in bf16
    (``library_bf16_ms``, None where PyTorch runs none on the card);
    ``library_ms`` is the bf16 one where it runs, else the f32 one. The
    bound: the f32 kernel's bytes with x read in bf16 (2 bytes a value);
    two FLOPs per live slot and column."""
    import torch

    from pygat_tpu_torch.ops import build

    big = case["dataset"].startswith("large")
    kw = dict(calls=BIG_CALLS, replays=BIG_REPLAYS) if big else {}
    x = case["x"]
    case["ms"] = _time_ms(case["run"], **kw)
    case["f32_ms"] = _time_ms(case["f32"], **kw)
    case["cast_ms"] = _time_ms(lambda: x.to(torch.bfloat16), **kw)
    wrapper, args = case["entry"]
    n_split = case["split_at"]
    x16 = x.to(torch.bfloat16)
    out = torch.empty(x.shape, device="cuda")
    part = (torch.empty(n_split, 128, x.shape[1], device="cuda")
            if n_split else None)
    c_args = args(x16, out, part)
    case["kernel_ms"] = _time_ms(lambda: build.launch(wrapper, *c_args), **kw)
    case["plain_ms"] = _time_ms(case["plain"], **kw)
    case["op_ms"] = _time_ms(case["op"], **kw)
    lib = case["lib"]
    case["library_f32_ms"] = _time_ms(lambda: torch.sparse.mm(lib, x), **kw)
    lib16 = _sparse_mm_bf16(lib, x)
    case["library_bf16_ms"] = (None if lib16 is None
                               else _time_ms(lib16, **kw))
    case["library_ms"] = (case["library_f32_ms"] if lib16 is None
                          else case["library_bf16_ms"])
    case["bound_ms"], case["bound_by"] = _bound(
        case["n_bytes"], 2 * case["n_live"] * case["L"])
    shape = f"L={case['L']}" + (f" P={case['P']}" if "P" in case else "")
    bf16_lib = ("not run" if lib16 is None
                else f"{case['library_bf16_ms']:.4f} ms")
    print(f"  {case['kernel']} {case['dataset']} {shape}: wrapper with its "
          f"bf16 cast {case['ms']:.4f} ms (the kernel alone "
          f"{case['kernel_ms']:.4f} ms, the cast {case['cast_ms']:.4f} ms), "
          f"f32 kernel {case['f32_ms']:.4f} ms, plain {case['plain_ms']:.4f} "
          f"ms, op forward {case['op_ms']:.4f} ms, torch.sparse.mm f32 "
          f"{case['library_f32_ms']:.4f} ms, bf16 {bf16_lib}, bound (bf16 x) "
          f"{case['bound_ms']:.5f} ms ({case['bound_by']})", flush=True)
    for k in ("run", "twin", "f32", "plain", "op", "entry", "lib", "x"):
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
    Returns (the epoch seconds by model, the set-up seconds, the PPI data,
    the train batch's graph)."""
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
    ppi_batch = ppi_graphs["ppi batch"]
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
    return ppi_epoch_s, ppi_setup, ppi, ppi_batch


def _unfused_scatter_cases(name, g, gen):
    """The segment sums of the unfused sparse branches on ``g`` at
    UNFUSED_WIDTHS[name], each a contiguous copy of an [L, E] tensor's
    transpose, as the layer hands the [H, E] gradient over (zero on the
    receiver side's dead slots, whose rows the layers zero)."""
    import torch

    cases = []
    for side, widths in UNFUSED_WIDTHS[name].items():
        live = (g.r_local if side == "recv" else g.c_local) < 128
        for width in widths:
            data = torch.randn(width, g.num_edges_padded, generator=gen,
                               device="cuda").t().contiguous()
            if side == "recv":
                data = data * live[:, None]
            cases.append(dict(dataset=name, path="unfused", side=side,
                              L=width, data=data, n_live=int(live.sum())))
    return cases


def _dense_remat_vs_batched(layer_type, cora):
    """The Cora dense model in train mode (dropout 0.6) through the remat
    path, forced by a threshold of 0, against the batched heads fed the
    same masks: apply_gat's per-head draws (made before each checkpointed
    head) are recorded, then stacked per layer for the batched heads;
    output and gradients on the card within MODEL_RTOL."""
    import torch

    from pygat_tpu_torch.models import gat
    from pygat_tpu_torch.models.layers import DropoutMasks
    from pygat_tpu_torch.utils.platform import make_generator

    cfg = _preset_cfg("cora", layer_type, cora)
    params = gat.init_gat(cfg, make_generator("cpu", 72), device="cuda")
    leaves = gat.parameters(params)
    x, g = cora.features, cora.graph
    drawn, draw, thresh = [], gat.draw_masks, gat._DENSE_VMAP_BYTES

    def record(*a, **k):
        drawn.append(draw(*a, **k))
        return drawn[-1]

    gat.draw_masks, gat._DENSE_VMAP_BYTES = record, 0
    try:
        out_r = gat.apply_gat(params, cfg, x, g, make_generator("cuda", 73),
                              train=True)
    finally:
        gat.draw_masks, gat._DENSE_VMAP_BYTES = draw, thresh
    if len(drawn) != sum(cfg.nheads):
        raise AssertionError("the remat path did not draw per head")
    grads_r = torch.autograd.grad(torch.sin(out_r[g.node_mask]).sum(), leaves)
    neighborhood = g.to_dense(binary=True) > 0
    h, start = x, 0
    for i, p in enumerate(params):
        heads, concat = p.W.shape[0], i < cfg.nlayers - 1
        stacked = DropoutMasks(*(
            None if ms[0] is None else torch.stack(ms)
            for ms in zip(*drawn[start:start + heads])))
        start += heads
        outs = gat.dense_heads(cfg, p, h, neighborhood, stacked,
                               concat=concat, train=True, remat=False)
        h = (outs.permute(1, 0, 2).reshape(h.shape[0], -1) if concat
             else outs.mean(0))
    grads_b = torch.autograd.grad(torch.sin(h[g.node_mask]).sum(), leaves)
    print(f"phase 9: Cora {layer_type}, dropout 0.6, remat path (threshold "
          "0) vs batched heads with the same masks, on the card:")
    scale = max(1.0, float(h.detach().abs().max()))
    err = float((out_r - h).detach().abs().max())
    print(f"  forward: max_abs_err {err:.3e} (allowed "
          f"{MODEL_RTOL * scale:.3e})")
    if not err <= MODEL_RTOL * scale:
        raise AssertionError("the remat path's forward disagrees")
    _check_grads(cfg, grads_r, grads_b, "remat vs batched")


def _dense_clis(ppi, counters, jsonl, path_launches, path_replayed):
    """The dense models, ``--backend xla`` and the fused attention off
    through the CLIs on CUDA, the counters set to 0 just before each run
    and read just after (through :func:`_train_cli`): finite, falling
    training and validation losses; the launches the CLI printed; no
    kernel but ``stream_scatter`` of the PPI GATv2_sparse run with the
    fused attention off (per train batch 3 layers of one forward receiver
    sum and three backward sums, per eval batch 3 forward sums); the fast
    loop's replays; each run's peak device memory."""
    import torch

    from pygat_tpu_torch.ops.fused_stream import set_fused_attention

    n_train = -(-len(ppi.train) // 2)
    n_eval = PPI_EPOCHS * -(-len(ppi.valid) // 2) + -(-len(ppi.test) // 2)
    runs = [
        ("cora GAT, fast loop", ["--dataset", "cora", "--model", "GAT",
                                 "--epoch-chunk", str(EPOCH_CHUNK)],
         TRAIN_EPOCHS, False, {}),
        ("cora GATv2, per-epoch loop", ["--dataset", "cora", "--model",
                                        "GATv2"], V1_EPOCHS, False, {}),
        ("cora GAT_sparse, --backend xla", ["--dataset", "cora", "--model",
                                            "GAT_sparse", "--backend", "xla"],
         V1_EPOCHS, False, {}),
        ("ppi GAT (the default), per-batch loop", [], PPI_EPOCHS, True, {}),
        ("ppi GATv2, banked loop", ["--model", "GATv2", "--epoch-scan"],
         PPI_EPOCHS, True, {}),
        ("ppi GATv2_sparse, fused attention off",
         ["--model", "GATv2_sparse"], PPI_EPOCHS, True,
         {"stream_scatter": 4 * 3 * PPI_EPOCHS * n_train + 3 * n_eval}),
    ]
    peaks = {}
    for label, argv, epochs, is_ppi, want in runs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        set_fused_attention("off" if "fused attention off" in label
                            else "auto")
        try:
            got, losses, replays, captured, text = _train_cli(
                argv, epochs, counters, jsonl, ppi=is_ppi)
        finally:
            set_fused_attention("auto")
        peaks[label] = torch.cuda.max_memory_allocated() / 2 ** 30
        with open(jsonl) as fh:
            val = [r["loss_val"] for r in map(json.loads, fh)
                   if r["kind"] == ("ppi_epoch" if is_ppi else "epoch")]
        counts = re.search(r"Kernel launches: (\{.*\})", text)
        print(f"phase 9: {label}: wrapper launches "
              f"{ {k: v for k, v in got.items() if v} }; {replays} CUDA "
              f"graph replays, each launching "
              f"{ {k: v for k, v in captured.items() if v} }; train losses "
              f"{losses}; validation losses {val}; peak allocated "
              f"{peaks[label]:.2f} GiB", flush=True)
        if counts is None or json.loads(counts.group(1)) != got:
            raise AssertionError(f"{label}: the CLI printed no or other counts")
        if {k: v for k, v in got.items() if v} != want or any(
                captured.values()):
            raise AssertionError(f"{label}: launches {got}, want {want}")
        if replays != (epochs if "fast loop" in label else 0):
            raise AssertionError(f"{label}: {replays} CUDA graph replays")
        if not all(math.isfinite(v) for v in val) or not val[-1] < val[0]:
            raise AssertionError(f"{label}: the validation loss did not fall")
        path_launches[label] = got
        path_replayed[label] = dict.fromkeys(counters, 0)
    return peaks


def _pubmed_dense_epochs(pubmed, counters):
    """Two Pubmed dense GAT training epochs (train step and eval forward, as
    the per-epoch loop runs them) through the remat path, which the
    [8, N, N] attention's bytes take by themselves: host seconds of each
    after a synchronize, and the peak device memory; finite losses, and
    no kernel of the port launched."""
    import torch

    from pygat_tpu_torch.models import gat
    from pygat_tpu_torch.models.presets import TRAIN_PRESETS
    from pygat_tpu_torch.train.loop import make_transductive_steps
    from pygat_tpu_torch.train.state import init_state, make_optimizer
    from pygat_tpu_torch.utils.platform import make_generator

    cfg = _preset_cfg("pubmed", "GAT", pubmed)
    x, g, y = pubmed.features, pubmed.graph, pubmed.labels
    n = g.num_nodes_padded
    att_gb = max(cfg.nheads) * n * n * 4 / 1e9
    if not att_gb * 1e9 > gat._DENSE_VMAP_BYTES:
        raise AssertionError("Pubmed's dense attention is under the remat "
                             "threshold")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    params = gat.init_gat(cfg, make_generator("cpu", 72), device="cuda")
    state = init_state(params, make_optimizer(params,
                                              **TRAIN_PRESETS["pubmed"]),
                       make_generator("cuda", 73))
    train_step, eval_step = make_transductive_steps(cfg)
    epoch_s, losses = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        _, loss, _, _ = train_step(state, x, g, y, pubmed.idx_train)
        loss_val = eval_step(state.params, x, g, y, pubmed.idx_val)[0]
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t1)
        losses.append((float(loss), float(loss_val)))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launched = {k: fn.launches for k, fn in counters.items() if fn.launches}
    print(f"phase 9: Pubmed GAT (dense), N_pad {n}: [8, N, N] attention of "
          f"{att_gb:.2f} GB a layer, so heads one after another under "
          f"checkpoint; 2 epochs of {[round(t, 4) for t in epoch_s]} s, "
          f"(train, validation) losses {losses}; peak allocated {peak:.2f} "
          f"GiB; wrapper launches {launched}", flush=True)
    if not all(math.isfinite(v) for pair in losses for v in pair):
        raise AssertionError("the Pubmed dense losses are not finite")
    if launched:
        raise AssertionError("a kernel ran on the dense path")
    del state, params
    torch.cuda.empty_cache()
    return {"epoch_s": epoch_s, "peak_allocated_gib": peak}


def _dense_phase(datasets, ppi, ppi_batch, gen, kernel_cases, counters,
                 jsonl, path_launches, path_replayed):
    """Phase 9, the dense layers and the unfused branches: row 1 at the
    unfused widths (:func:`_unfused_scatter_cases`) against its f64 plain
    version, twice, and timed beside index_add_; the Cora dense models
    card vs CPU and their remat path against the batched heads; the Cora
    sparse models through the unfused branch card vs CPU under the stream
    and the scatter impls; the CLIs (:func:`_dense_clis`); the dense
    epochs of Cora (both loops) and PPI (both loops) timed; the Pubmed
    dense epoch (:func:`_pubmed_dense_epochs`). Returns its numbers."""
    from pygat_tpu_torch.data.ppi import ppi_config
    from pygat_tpu_torch.ops.fused_stream import set_fused_attention
    from pygat_tpu_torch.ops.segment import use_impl

    cora = datasets["cora"]
    for name, g in (("cora", cora.graph), ("ppi batch", ppi_batch)):
        for case in _unfused_scatter_cases(name, g, gen):
            _check_scatter(case, g, kernel_cases)
            _time_scatter(case, g)
            del case["data"]
    for lt in ("GAT", "GATv2"):
        _card_vs_cpu(f"phase 9: Cora {lt} (dense)",
                     _preset_cfg("cora", lt, cora), cora.features,
                     cora.graph)
        _dense_remat_vs_batched(lt, cora)
    set_fused_attention("off")
    try:
        for lt in ("GAT_sparse", "GATv2_sparse"):
            for impl in ("stream", "scatter"):
                with use_impl(impl):
                    _card_vs_cpu(f"phase 9: Cora {lt}, unfused branch, "
                                 f"{impl} impl", _preset_cfg("cora", lt, cora),
                                 cora.features, cora.graph)
    finally:
        set_fused_attention("auto")
    peaks = _dense_clis(ppi, counters, jsonl, path_launches, path_replayed)
    out = {"cli_peak_allocated_gib": peaks}
    for lt in ("GAT", "GATv2"):
        samples, fast = _epoch_ms(_preset_cfg("cora", lt, cora), cora)
        out[f"cora {lt}"] = {"per_epoch_loop_ms": samples[len(samples) // 2],
                             "fast_loop_ms": fast[len(fast) // 2]}
        out[f"ppi {lt}"] = _ppi_epoch_s(ppi_config(lt), ppi)
        print(f"phase 9: Cora {lt} (dense) epoch, host clock: per-epoch "
              f"loop median {samples[len(samples) // 2]:.4f} ms; fast loop "
              f"median {fast[len(fast) // 2]:.4f} ms; PPI {lt} epoch: "
              + "; ".join(f"{k} {[round(v, 4) for v in vs]}"
                          for k, vs in out[f"ppi {lt}"].items()), flush=True)
    out["pubmed GAT"] = _pubmed_dense_epochs(datasets["pubmed"], counters)
    return out



# -- phase 10: the ring (pygat_tpu_torch.parallel) ---------------------------


def _ring_partition(name, ds, phase=10):
    """Dataset ``ds`` interleaved and repadded for RING_SHARDS shards, its
    ``partition_edges`` and every shard's blocks and walks on the card,
    with the host seconds of each step and the blocks' sizes (printed
    under ``phase``)."""
    import torch

    from pygat_tpu_torch.data.citation import interleave_citation
    from pygat_tpu_torch.parallel.partition import partition_edges, shard_blocks

    d = RING_SHARDS
    unit = 128 * d
    n_pad = ds.graph.num_nodes_padded
    want = -(-max(n_pad, int(ds.graph.n_node) + 1) // unit) * unit
    t0 = time.perf_counter()
    il = interleave_citation(ds, d, n_pad=want)
    t1 = time.perf_counter()
    part = partition_edges(il.graph, d)
    t2 = time.perf_counter()
    blocks = [shard_blocks(part, k, "cuda") for k in range(d)]
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    live = part.edge_mask.sum(axis=-1)
    sizes = dict(n_local=part.n_local, block_edges=part.block_edges,
                 live_mean=float(live.mean()), live_max=int(live.max()),
                 live_min=int(live.min()), h_rows=part.h_rows,
                 interleave_s=t1 - t0, partition_s=t2 - t1, walks_s=t3 - t2)
    print(f"phase {phase}: {name}, {d} shards: N_pad {want}, n_local "
          f"{part.n_local}, E_blk {part.block_edges} (live per block: mean "
          f"{sizes['live_mean']:.1f}, {sizes['live_min']}-{sizes['live_max']}"
          f"), h_rows {part.h_rows}; interleave {t1 - t0:.2f} s, "
          f"partition_edges {t2 - t1:.2f} s, block walks {t3 - t2:.2f} s",
          flush=True)
    return dict(il=il, part=part, blocks=blocks, sizes=sizes)


def _ring_tables(il, h, f, v2, gen):
    """Full node tables of one layer width on the card, with the bound
    the ring forms from them: GATv1 wh, f_dst, bound, a_src; GATv2 whi,
    whj, ub, a."""
    import torch

    from pygat_tpu_torch.ops.fused_stream import leaky_relu

    n = il.graph.num_nodes_padded
    nm = il.graph.node_mask[:, None]
    if not v2:
        wh = torch.randn(n, h * f, generator=gen, device="cuda") * 0.5
        a = torch.randn(h, 2 * f, generator=gen, device="cuda") * 0.5
        wh3 = wh.view(n, h, f)
        f_dst = torch.einsum("nho,ho->nh", wh3, a[:, :f]).contiguous()
        a_src = a[:, f:].contiguous()
        f_src = torch.einsum("nho,ho->nh", wh3, a_src)
        m = torch.where(nm, f_src, float("-inf")).amax(0)
        return dict(wh=wh, f_dst=f_dst, a_src=a_src,
                    bound=leaky_relu(f_dst + m, 0.2).contiguous())
    whi = torch.randn(n, h * f, generator=gen, device="cuda") * 0.5
    whj = torch.randn(n, h * f, generator=gen, device="cuda") * 0.5
    a = torch.randn(h, f, generator=gen, device="cuda") * 0.5
    mq_max = torch.where(nm, whj, float("-inf")).amax(0).view(h, f)
    mq_min = torch.where(nm, whj, float("inf")).amin(0).view(h, f)
    wi3 = whi.view(n, h, f)
    ub = ((leaky_relu(wi3 + mq_max, 0.2) * a.clamp(min=0)).sum(-1)
          + (leaky_relu(wi3 + mq_min, 0.2) * a.clamp(max=0)).sum(-1))
    return dict(whi=whi, whj=whj, a=a, ub=ub.contiguous())


def _hop_rows(blocks, dst, src, halo):
    """The rows of the full tables a hop's sender buffer holds: shard
    ``src``'s range, or (``halo``) the rows of it that shard ``dst``
    references."""
    n_local = blocks[dst].n_local
    if halo and src != dst:
        return src * n_local + blocks[src].halo_idx[dst].long()
    return slice(src * n_local, (src + 1) * n_local)


def _hop_args(blocks, dst, k, halo, t, keep):
    """(kernel, plain, args, walk, block) of hop ``k`` into shard ``dst``
    over the tables ``t`` (GATv1 or GATv2), as a rank would call it."""
    from pygat_tpu_torch.ops.fused_stream import (
        fused_v1_parts,
        fused_v1_parts_plain,
        fused_v2_parts,
        fused_v2_parts_plain,
    )

    d = len(blocks)
    src = (dst - k) % d
    b = blocks[dst].block(src, halo and src != dst)
    n_local = blocks[dst].n_local
    mine = slice(dst * n_local, (dst + 1) * n_local)
    rows = _hop_rows(blocks, dst, src, halo)
    keep_k = keep[:b.recv.shape[0]]
    if "wh" in t:
        args = (t["wh"][rows].contiguous(), t["f_dst"][mine],
                t["bound"][mine], t["a_src"], keep_k, b.senders, b.local,
                b.chunk, 0.2)
        return fused_v1_parts, fused_v1_parts_plain, args, b.walk, b
    args = (t["whi"][mine], t["ub"][mine], t["whi"][rows].contiguous(),
            t["whj"][rows].contiguous(), t["a"], keep_k, b.senders, b.local,
            b.chunk, 0.2)
    return fused_v2_parts, fused_v2_parts_plain, args, b.walk, b


def _hop_check(kernel, plain, args, walk, precision="high"):
    """One hop's launch at ``precision`` against its f64 plain version, and
    a second launch: (worst error over its allowance, KERNEL_RTOL; under
    "fastest" out's as :func:`_fastest_out_err`; max |error|, whether the
    second call is equal bit for bit)."""
    import torch

    out, den = kernel(*args, walk=walk, precision=precision)
    out_p, den_p = plain(*args, f64=True, precision=precision)
    again = kernel(*args, walk=walk, precision=precision)
    torch.cuda.synchronize()
    if precision == "high":
        e1, a1 = _max_err(out, out_p)
        w1 = e1 / a1
    else:
        e1, w1 = _fastest_out_err(out, plain, args)
    e2, a2 = _max_err(den, den_p)
    repeat = torch.equal(out, again[0]) and torch.equal(den, again[1])
    return max(w1, e2 / a2), max(e1, e2), repeat


def _check_ring_hops(name, rp, h, f, v2, gen, kernel_cases):
    """Every hop (each destination shard, each hop, rotation and halo) of
    the GATv1 or GATv2 parts kernel at width (h, f) against its f64 plain
    version, to KERNEL_RTOL of its largest output, and again, equal bit for
    bit; one case a (dataset, width, exchange) with the worst hop."""
    import torch

    blocks = rp["blocks"]
    d = len(blocks)
    t = _ring_tables(rp["il"], h, f, v2, gen)
    e_blk = rp["part"].block_edges
    keep = torch.where(torch.rand(e_blk, h, generator=gen, device="cuda")
                       < 0.4, 1.0 / 0.4, 0.0)
    kname = "fused_v2_parts" if v2 else "fused_v1_parts"
    for exchange in ("rotation", "halo"):
        worst, worst_err, repeat, n_hops = 0.0, 0.0, True, 0
        for dst in range(d):
            for k in range(d):
                if exchange == "halo" and k == 0:
                    continue  # hop 0 is the shard's own block either way
                kernel, plain, args, walk, _ = _hop_args(
                    blocks, dst, k, exchange == "halo", t, keep)
                w, err, same = _hop_check(kernel, plain, args, walk)
                worst, worst_err = max(worst, w), max(worst_err, err)
                repeat &= same
                n_hops += 1
        print(f"  {kname} {name} H={h} F={f} {exchange}: {n_hops} hops, "
              f"worst at {worst:.3f} of its allowance; a second call "
              f"{'' if repeat else 'NOT '}equal bit for bit")
        if worst > 1.0 or not repeat:
            raise AssertionError(f"{kname} disagrees with its plain version")
        kernel_cases[kname].append(dict(
            dataset=name, H=h, F=f, path=exchange, max_abs_err=worst_err,
            bitwise_repeat=repeat, hops=n_hops))
    return t


def _ring_vs_single(name, rp, h, f, v2, gen, halo):
    """Each shard's summed hops (ring_hop_v1 / _v2 over the parts kernel,
    no dropout), after softmax_div, against the single-device fused
    attention on the same interleaved graph, and the gradients of wh,
    f_dst, a (GATv1) or whi, whj, a (GATv2) of a random cotangent, within
    MODEL_RTOL."""
    import torch

    from pygat_tpu_torch.models.layers import softmax_div
    from pygat_tpu_torch.ops.fused_stream import (
        fused_v1_attention,
        fused_v2_attention,
    )
    from pygat_tpu_torch.parallel.partition import ring_hop_v1, ring_hop_v2

    blocks, g = rp["blocks"], rp["il"].graph
    d, n_local, hf = len(blocks), blocks[0].n_local, h * f
    t = _ring_tables(rp["il"], h, f, v2, gen)
    names = ("whi", "whj", "a") if v2 else ("wh", "f_dst", "a_src")
    cot = torch.randn(g.num_nodes_padded, hf, generator=gen, device="cuda")
    results = []
    for route in ("ring", "single"):
        leaves = [t[k].clone().requires_grad_() for k in names]
        if route == "single":
            ones = torch.ones(g.num_edges_padded, h, device="cuda")
            fields = (g.senders, g.receivers, g.r_local, g.r_chunk, g.c_slot,
                      g.c_local, g.c_chunk, 0.2, g.stream_walk,
                      g.sender_walk)
            if v2:
                agg, den = fused_v2_attention(leaves[0], leaves[1], t["ub"],
                                              leaves[2], ones, *fields)
            else:
                agg, den = fused_v1_attention(leaves[0], leaves[1],
                                              t["bound"], leaves[2], ones,
                                              *fields)
            out = softmax_div(agg.view(-1, h, f), den).view(-1, hf)
        else:
            outs = []
            for dst in range(d):
                mine = slice(dst * n_local, (dst + 1) * n_local)
                acc = torch.zeros(n_local, hf + h, device="cuda")
                for k in range(d):
                    rows = _hop_rows(blocks, dst, (dst - k) % d, halo)
                    if v2:
                        acc = ring_hop_v2(acc, leaves[0][rows],
                                          leaves[1][rows], k, blocks[dst],
                                          leaves[0][mine], t["ub"][mine],
                                          leaves[2], alpha=0.2, halo=halo)
                    else:
                        acc = ring_hop_v1(acc, leaves[0][rows], k,
                                          blocks[dst], leaves[1][mine],
                                          t["bound"][mine], leaves[2],
                                          alpha=0.2, halo=halo)
                outs.append(softmax_div(acc[:, :hf].view(-1, h, f),
                                        acc[:, hf:]).view(-1, hf))
            out = torch.cat(outs)
        grads = torch.autograd.grad((out * cot).sum(), leaves)
        results.append((out.detach(), grads))
    (out_r, grads_r), (out_s, grads_s) = results
    worst = 0.0
    for what, got, want in (("out", out_r, out_s),
                            *zip(names, grads_r, grads_s)):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"ring {what} is not finite")
        scale = MODEL_RTOL * max(1.0, float(want.abs().max()))
        worst = max(worst, float((got - want).abs().max()) / scale)
    label = ("v2" if v2 else "v1") + (" halo" if halo else " rotation")
    print(f"  ring {label} {name} H={h} F={f}: summed hops vs the "
          f"single-device fused attention, output and gradients of "
          f"{', '.join(names)}: worst at {worst:.3f} of MODEL_RTOL")
    if worst > 1.0:
        raise AssertionError("the ring disagrees with the single device")


def _block_view(b, side):
    """(local, chunk, n_rows, slot, walk) of row 1 over block ``b``'s
    receiver stream (``side`` 'recv', n_local rows) or its sender or halo
    view (by the slot map, over the view's rows)."""
    if side == "recv":
        return b.local, b.chunk, b.n_local, None, b.walk
    return b.s_local, b.s_chunk, b.n_rows, b.s_slot, b.sender_walk


def _block_scatter_check(data, view):
    """Row 1 over a block view against its f64 plain version and again:
    (worst error over its allowance of KERNEL_RTOL of the same sums over
    |data|, max |error|, whether the second call is equal bit for bit)."""
    import torch

    from pygat_tpu_torch.ops.stream import stream_scatter, stream_scatter_plain

    local, chunk, n_rows, slot, walk = view
    got = stream_scatter(data, local, chunk, n_rows, slot=slot, walk=walk)
    want = stream_scatter_plain(data, local, chunk, n_rows, slot=slot,
                                f64=True)
    mag = stream_scatter_plain(data.abs(), local, chunk, n_rows, slot=slot)
    again = stream_scatter(data, local, chunk, n_rows, slot=slot, walk=walk)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    return (float((diff / (KERNEL_RTOL * mag + 1e-30)).max()),
            float(diff.max()), torch.equal(got, again))


def _block_scatter_cases(name, rp, widths, gen, kernel_cases):
    """Row 1 over the ring's block views at ``widths``: every block's
    receiver stream (n_local rows), sender view (n_local rows) and halo view
    (h_rows rows), against its f64 plain version to KERNEL_RTOL of the same
    sums over |data|, and again, equal bit for bit; one case a (view,
    width) with the worst block."""
    import torch

    blocks = rp["blocks"]
    d = len(blocks)
    for width in widths:
        for side in ("recv", "send", "halo"):
            worst, worst_err, repeat = 0.0, 0.0, True
            for dst in range(d):
                for src in range(d):
                    if side == "halo" and src == dst:
                        continue
                    b = blocks[dst].block(src, side == "halo")
                    data = torch.randn(b.recv.shape[0], width, generator=gen,
                                       device="cuda")
                    if side == "recv":
                        data = data * b.mask[:, None]
                    w, err, same = _block_scatter_check(
                        data, _block_view(b, side))
                    worst, worst_err = max(worst, w), max(worst_err, err)
                    repeat &= same
            print(f"  stream_scatter {name} ring {side} view L={width}: "
                  f"worst block at {worst:.3f} of its allowance; a second "
                  f"call {'' if repeat else 'NOT '}equal bit for bit")
            if worst > 1.0 or not repeat:
                raise AssertionError("stream_scatter disagrees with its plain "
                                     "version over a ring block")
            kernel_cases["stream_scatter"].append(dict(
                dataset=name, path="ring", side=side, L=width,
                max_abs_err=worst_err, bitwise_repeat=repeat))


def _time_ring_hop(name, rp, t, h, f, exchange, kernel_cases, single_ms,
                   big=False, precision="high"):
    """Hop 1 into shard 0 (the rotation's full shard, or the halo buffer)
    of the parts kernel of tables ``t`` at ``precision``: held to its f64
    plain version and called again (equal bit for bit), then its time, its
    plain version's, its bound, and row 2 or 3's single-device time on the
    same graph; under "fastest" (the one-limb kernel) also the f32
    kernel's time, the bf16 casts' and the kernel's alone, and the bound
    with bf16 sender rows."""
    import torch

    blocks = rp["blocks"]
    keep = torch.ones(rp["part"].block_edges, h, device="cuda")
    kernel, plain, args, walk, b = _hop_args(blocks, 0, 1,
                                             exchange == "halo", t, keep)
    v2 = "whi" in t
    one = precision == "fastest"
    kname = ("fused_v2_parts" if v2 else "fused_v1_parts") + (
        "_bf16" if one else "")
    worst, err, repeat = _hop_check(kernel, plain, args, walk, precision)
    if worst > 1.0 or not repeat:
        raise AssertionError(f"{kname} {name} {exchange} hop disagrees with "
                             f"its plain version (worst at {worst:.3f} of "
                             f"its allowance, repeat {repeat})")
    kw = dict(calls=BIG_CALLS, replays=BIG_REPLAYS) if big else {}
    ms = _time_ms(lambda: kernel(*args, walk=walk, precision=precision),
                  **kw)
    plain_ms = _time_ms(lambda: plain(*args, precision=precision), **kw)
    n_local, n_buf, hf = blocks[0].n_local, b.n_rows, h * f
    live = int(b.mask.sum())
    # the rows the hop reads: its live slots' senders in the sender
    # table(s), and the receivers with a live slot on the receiver side
    n_snd = int(torch.unique(b.senders[b.mask]).numel())
    n_rcv = int(torch.unique(b.recv[b.mask]).numel())
    index_words = 2 * b.recv.shape[0] + b.chunk.shape[0]
    # each input once: those rows of the sender table(s) (bf16 under
    # "fastest") and of the receiver tables, a, a live slot's keep factors,
    # the index words; out and den written, all n_local rows
    n_bytes = ((2 if one else 4) * (2 if v2 else 1) * n_snd * hf
               + 4 * ((n_rcv * (hf + h) if v2 else 2 * n_rcv * h)
                      + hf + live * h + index_words + n_local * (hf + h)))
    n_flops = live * ((6 if v2 else 4) * hf + 6 * h)
    bound_ms, bound_by = _bound(n_bytes, n_flops)
    case = dict(dataset=name, H=h, F=f, path=f"{exchange} hop", n_buf=n_buf,
                live=live, senders_read=n_snd, receivers_read=n_rcv, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, single_device_ms=single_ms, max_abs_err=err,
                bitwise_repeat=repeat, precision=precision)
    extra = ""
    if one:
        tables = args[2:4] if v2 else args[:1]
        case.update(
            f32_ms=_time_ms(lambda: kernel(*args, walk=walk), **kw),
            cast_ms=_time_ms(lambda: [x.to(torch.bfloat16) for x in tables],
                             **kw),
            kernel_ms=_one_limb_kernel_ms(kname.replace("_bf16", ""), args,
                                          walk, n_local, **kw))
        extra = (f" (the kernel alone {case['kernel_ms']:.4f} ms), f32 "
                 f"kernel {case['f32_ms']:.4f} ms, bf16 casts "
                 f"{case['cast_ms']:.4f} ms")
    kernel_cases[kname].append(case)
    print(f"  {kname} {name} H={h} F={f} {exchange} hop (n_buf {n_buf}, "
          f"{live} live slots, {n_snd} senders and {n_rcv} receivers read; "
          f"worst at {worst:.3f} of its allowance, a second call equal bit "
          f"for bit): {ms:.4f} ms{extra}, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.5f} ms ({bound_by}); one device's row "
          f"{'3' if v2 else '2'} on the whole graph "
          f"{'not measured' if single_ms is None else f'{single_ms:.4f} ms'}")
    return case


def _time_block_scatter(name, rp, width, kernel_cases):
    """Row 1 over shard 0's block from shard 1, each view, at ``width``:
    held to its f64 plain version and called again (equal bit for bit),
    then the kernel, the plain version, ``index_add_`` and the byte
    bound."""
    import torch

    from pygat_tpu_torch.ops.stream import stream_scatter, stream_scatter_plain

    blocks = rp["blocks"]
    for side in ("recv", "send", "halo"):
        b = blocks[0].block(1, side == "halo")
        data = torch.randn(b.recv.shape[0], width, device="cuda") * b.mask[
            :, None]
        view = _block_view(b, side)
        local, chunk, n_rows, slot, walk = view
        worst, err, repeat = _block_scatter_check(data, view)
        if worst > 1.0 or not repeat:
            raise AssertionError(f"stream_scatter {name} ring {side} view "
                                 f"disagrees with its plain version (worst "
                                 f"at {worst:.3f} of its allowance, repeat "
                                 f"{repeat})")
        if side == "recv":
            idx = torch.where(b.mask, b.recv.long(), b.n_local)
        else:
            idx = torch.where(b.mask, b.senders.long(), b.n_rows)
        ms = _time_ms(lambda: stream_scatter(data, local, chunk, n_rows,
                                             slot=slot, walk=walk))
        plain_ms = _time_ms(lambda: stream_scatter_plain(
            data, local, chunk, n_rows, slot=slot))
        lib = torch.zeros(n_rows + 1, width, device="cuda")
        library_ms = _time_ms(lambda: lib.index_add_(0, idx, data))
        live = int(b.mask.sum())
        n_bytes = 4 * (live * width + local.numel() + chunk.numel()
                       + (slot.numel() if slot is not None else 0)
                       + n_rows * width)
        bound_ms, bound_by = _bound(n_bytes, live * width)
        kernel_cases["stream_scatter"].append(dict(
            dataset=name, path="ring", side=f"{side} timed", L=width, ms=ms,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
            bound_by=bound_by, max_abs_err=err, bitwise_repeat=repeat))
        print(f"  stream_scatter {name} ring {side} view (shard 0 from 1) "
              f"L={width} (worst at {worst:.3f} of its allowance, a second "
              f"call equal bit for bit): {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, index_add_ {library_ms:.4f} ms, bound {bound_ms:.5f} ms "
              f"({bound_by})")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def _one_rank():
    """The launcher's environment of a group of one on this card (a free
    port on this host), taken away again on exit."""
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()))
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _ring_clis(counters, jsonl, path_launches, path_replayed):
    """Both CLIs at world size 1 (an NCCL group of one, brought up by the
    CLI from the launcher's environment): Cora GAT_sparse and GATv2_sparse
    by both loops with ``--mesh 1,1 --partition ring --distributed``, and
    PPI GATv2_sparse by the banked loop with ``--epoch-scan --mesh 1,1
    --distributed``; each with the counters set to 0 just before and read
    just after, its losses finite and falling (training and validation);
    on Cora the parts kernels and row 1 launched, the single-device stream
    forwards not; on PPI (one batch a rank, no ring) rows 1 and 3, the
    parts kernels not. Returns the runs' capture records (the fast
    loop's)."""
    captures = {}
    runs = []
    for lt in ("GAT_sparse", "GATv2_sparse"):
        base = ["--dataset", "cora", "--model", lt, "--mesh", "1,1",
                "--partition", "ring", "--distributed"]
        runs.append((f"ring {lt}", base, TRAIN_EPOCHS, False))
        runs.append((f"ring {lt} fast loop",
                     base + ["--epoch-chunk", str(EPOCH_CHUNK)],
                     TRAIN_EPOCHS, False))
    runs.append(("ring PPI GATv2_sparse banked",
                 ["--model", "GATv2_sparse", "--epoch-scan", "--mesh", "1,1",
                  "--distributed"], PPI_EPOCHS, True))
    for label, argv, epochs, ppi in runs:
        with _one_rank():
            launches, losses, replays, captured, text = _train_cli(
                argv, epochs, counters, jsonl, ppi=ppi)
        with open(jsonl) as fh:
            recs = [json.loads(line) for line in fh]
        kind = "ppi_epoch" if ppi else "epoch"
        val = [r["loss_val"] for r in recs if r["kind"] == kind]
        if not (all(math.isfinite(v) for v in val) and val[-1] < val[0]):
            raise AssertionError(f"{label}: the validation loss did not fall")
        if "mesh: data=1 model=1" not in text:
            raise AssertionError(f"{label}: the CLI did not run on a mesh")
        if ppi:
            # data parallelism: each rank's batches through rows 1-3 on
            # its own device, no ring
            want, never = ("fused_v2", "stream_scatter"), ("fused_v1_parts",
                                                           "fused_v2_parts")
        else:
            want = ("fused_v2_parts" if "v2" in label else "fused_v1_parts",
                    "stream_scatter")
            never = ("fused_v1", "fused_v2")
        if not all(launches[k] for k in want):
            raise AssertionError(f"{label}: {want} did not all run")
        if any(launches[k] for k in never):
            raise AssertionError(f"{label}: {never} ran")
        captures[label] = [r for r in recs if r["kind"] == "capture"]
        path_launches[label] = launches
        path_replayed[label] = {k: replays * captured.get(k, 0)
                                for k in counters}
        print(f"phase 10: {label}: train losses "
              f"{[round(v, 4) for v in losses]}; validation "
              f"{[round(v, 4) for v in val]}; wrapper launches "
              f"{ {k: v for k, v in launches.items() if v} }; CUDA graph "
              f"replays {replays}"
              + (f"; eager chunks: {captures[label][0]['error']}"
                 if captures[label] else ""), flush=True)
    return captures


def _ring_model_card_vs_cpu(cora):
    """The ring model at one shard (no group: one rank's ring) on the card
    against the single-device model on the CPU on the same graph, loss and
    gradients of both sparse models, within MODEL_RTOL."""
    import torch
    import torch.nn.functional as F

    from pygat_tpu_torch.data.citation import interleave_citation
    from pygat_tpu_torch.models.gat import apply_gat, init_gat, parameters
    from pygat_tpu_torch.parallel.partition import partition_edges, shard_blocks
    from pygat_tpu_torch.parallel.ring_model import ring_apply_gat
    from pygat_tpu_torch.utils.platform import make_generator

    il = interleave_citation(cora, 1)
    blocks = shard_blocks(partition_edges(il.graph, 1), 0, "cuda")
    idx = il.idx_train.long()
    for lt in ("GAT_sparse", "GATv2_sparse"):
        cfg = _preset_cfg("cora", lt, cora)._replace(dropout=0.0)
        res = {}
        for side, dev in (("card", "cuda"), ("host", "cpu")):
            params = init_gat(cfg, make_generator("cpu", 72), device=dev)
            x = il.features.to(dev)
            if side == "card":
                out = ring_apply_gat(params, cfg, x, blocks, None, train=True)
            else:
                out = apply_gat(params, cfg, x, il.graph.to(dev), None,
                                train=True)
            lp = F.log_softmax(F.elu(out), dim=1)
            loss = F.nll_loss(lp[idx.to(dev)], il.labels.to(dev)[
                idx.to(dev)].long())
            loss.backward()
            res[side] = (out.detach().cpu(), float(loss.detach()),
                         [p.grad.cpu() for p in parameters(params)])
        worst = 0.0
        for got, want in zip([res["card"][0], *res["card"][2]],
                             [res["host"][0], *res["host"][2]]):
            scale = MODEL_RTOL * max(1.0, float(want.abs().max()))
            worst = max(worst, float((got - want).abs().max()) / scale)
        print(f"phase 10: Cora {lt}, the ring model on the card vs the "
              f"single-device model on the CPU: loss {res['card'][1]:.6f} / "
              f"{res['host'][1]:.6f}, output and gradients worst at "
              f"{worst:.3f} of MODEL_RTOL")
        if worst > 1.0 or abs(res["card"][1] - res["host"][1]) > MODEL_RTOL:
            raise AssertionError("the ring model disagrees with the single "
                                 "device")


def _ring_epoch_ms(cora):
    """Cora GAT_sparse epochs in a group of one: the ring's (one shard) and
    the single device's, by the per-epoch loop (median of 20 synchronized
    epochs) and the fast loop (median of TIMED_CHUNKS chunks of 10), host
    clock; the fast loop's capture holds the NCCL all-reduces."""
    import torch
    import torch.distributed as dist

    from pygat_tpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from pygat_tpu_torch.tools.profile_epoch import epoch_runners
    from pygat_tpu_torch.train.logging import TrainLogger
    from pygat_tpu_torch.train.loop import _ring_setup

    cfg = _preset_cfg("cora", "GAT_sparse", cora)
    out = {}
    with _one_rank():
        initialize_distributed()
        try:
            mesh = make_mesh(1, 1)
            with open(os.devnull, "w") as quiet:
                local, ring = _ring_setup(cfg, cora, mesh,
                                          TrainLogger(stream=quiet))
            for label, data, kw in (("single device", cora, {}),
                                    ("ring, 1 shard", local, {"ring": ring})):
                epoch, chunk = epoch_runners(cfg, data, 10, **kw)
                for _ in range(5):
                    epoch()
                torch.cuda.synchronize()
                samples = []
                for _ in range(20):
                    t0 = time.perf_counter()
                    epoch()
                    torch.cuda.synchronize()
                    samples.append((time.perf_counter() - t0) * 1e3)
                chunk.run()
                fast = []
                for _ in range(TIMED_CHUNKS):
                    t0 = time.perf_counter()
                    chunk.run()
                    fast.append((time.perf_counter() - t0) * 1e3 / 10)
                out[label] = dict(per_epoch_ms=sorted(samples)[10],
                                  fast_ms=sorted(fast)[TIMED_CHUNKS // 2],
                                  captured=chunk.graph_replays > 0,
                                  capture_error=chunk.capture_error)
                print(f"phase 10: Cora GAT_sparse epoch, {label}: per-epoch "
                      f"loop {out[label]['per_epoch_ms']:.4f} ms, fast loop "
                      f"{out[label]['fast_ms']:.4f} ms ("
                      + ("captured" if chunk.graph_replays else
                         f"eager: {chunk.capture_error}") + ")", flush=True)
        finally:
            dist.destroy_process_group()
    return out


def _ring_phase(datasets, large, gen, kernel_cases, counters, jsonl,
                path_launches, path_replayed):
    """Phase 10, the ring: the per-hop kernels at the 4-shard block shapes
    of Cora and Pubmed (both models at the presets' widths, every hop,
    rotation and halo) against their f64 plain versions and summed against
    the single-device attention; row 1 over the block views; the CLIs at
    world size 1; the ring model card vs CPU; the timings (hops at Cora,
    Pubmed and the 524k graph, the host's partition seconds, the Cora
    epochs). Returns its numbers."""
    from pygat_tpu_torch.models.presets import PRESETS

    single = {}
    for kname in ("fused_v1", "fused_v2"):
        for c in kernel_cases[kname]:
            single[(kname, c["dataset"], c["H"], c["F"])] = c.get("ms")
    out = {"blocks": {}, "hops": []}
    for name in ("cora", "pubmed"):
        rp = _ring_partition(name, datasets[name])
        out["blocks"][name] = rp["sizes"]
        widths = list(zip(PRESETS[name]["nheads"], PRESETS[name]["nfeats"][1:]))
        for v2 in (False, True):
            for h, f in widths:
                t = _check_ring_hops(name, rp, h, f, v2, gen, kernel_cases)
                if (h, f) == widths[0]:
                    for exchange in ("rotation", "halo"):
                        out["hops"].append(_time_ring_hop(
                            name, rp, t, h, f, exchange, kernel_cases,
                            single.get(("fused_v2" if v2 else "fused_v1",
                                        name, h, f))))
            h, f = widths[0]
            for halo in (False, True):
                _ring_vs_single(name, rp, h, f, v2, gen, halo)
        h, f = widths[0]
        _block_scatter_cases(name, rp, (h, h * f), gen, kernel_cases)
        if name == "cora":
            _time_block_scatter(name, rp, h * f, kernel_cases)
        del rp
    t0 = time.perf_counter()
    rp = _ring_partition("large", large)
    out["blocks"]["large"] = rp["sizes"]
    if time.perf_counter() - t0 > 60:
        print("phase 10: partitioning the 524k graph took more than 60 s; "
              "its hops are not timed")
    else:
        for v2 in (False, True):
            t = _ring_tables(rp["il"], 8, 8, v2, gen)
            for exchange in ("rotation", "halo"):
                out["hops"].append(_time_ring_hop(
                    "large", rp, t, 8, 8, exchange, kernel_cases,
                    single.get(("fused_v2" if v2 else "fused_v1", "large",
                                8, 8)), big=True))
            del t
    del rp
    _ring_model_card_vs_cpu(datasets["cora"])
    out["captures"] = _ring_clis(counters, jsonl, path_launches,
                                 path_replayed)
    out["epoch_ms"] = _ring_epoch_ms(datasets["cora"])
    return out


# -- phase 11: the RCM order and the stacked PPI loop -------------------------


def _locality(g):
    """The stream layout and locality of ``g``: E_s, the receiver walk's
    chunks and split pieces, the mean |sender - receiver| of the live
    edges, and the distinct (receiver tile, sender tile) pairs they
    touch."""
    import numpy as np

    from pygat_tpu_torch.graph import host_edges

    send, recv, _, mask = host_edges(g)
    send, recv = send[mask].astype(np.int64), recv[mask].astype(np.int64)
    walk = g.stream_walk
    return {"E_s": g.num_edges_padded,
            "walk_chunks": int(walk.tile_ptr[-1]),
            "split_pieces": int(walk.split_at.numel()),
            "max_run": int(walk.max_run),
            "mean_distance": float(np.abs(send - recv).mean()),
            "tile_pairs": int(np.unique(recv // 128 * (
                g.num_nodes_padded // 128) + send // 128).size)}


def _rcm_seconds(g):
    """Host seconds of RCM over ``g``'s real edges as the loader runs it
    (the CSR by receiver, then the order), the order itself, and the
    build's."""
    from pygat_tpu_torch import native
    from pygat_tpu_torch.graph import host_edges

    send, recv, _, mask = host_edges(g)
    n = int(g.n_node)
    t0 = time.perf_counter()
    rowptr, col, _ = native.build_csr(send[mask], recv[mask], n)
    t1 = time.perf_counter()
    native.rcm_order(rowptr, col, n)
    t2 = time.perf_counter()
    return {"csr_s": t1 - t0, "rcm_s": t2 - t1}


def _reorder_loads(datasets):
    """The graph library's build, and Cora and Pubmed loaded in RCM order:
    their load seconds, RCM's host seconds, and the layout and locality
    before and after. Returns (the reordered datasets by name, the
    numbers)."""
    from pygat_tpu_torch import native
    from pygat_tpu_torch.data.citation import load_citation

    t0 = time.perf_counter()
    native.build()
    native.load()
    out = {"graphops_build_s": time.perf_counter() - t0, "graphs": {}}
    print(f"phase 11: graphops library built and loaded in "
          f"{out['graphops_build_s']:.2f} s ({native.lib_path()})",
          flush=True)
    rcm = {}
    for name in ("cora", "pubmed"):
        t0 = time.perf_counter()
        rcm[name] = load_citation(name, reorder=True, device="cuda")
        load_s = time.perf_counter() - t0
        secs = _rcm_seconds(datasets[name].graph)
        before = _locality(datasets[name].graph)
        after = _locality(rcm[name].graph)
        out["graphs"][name] = dict(load_s=load_s, **secs, before=before,
                                   after=after)
        print(f"phase 11: {name} in RCM order loaded in {load_s:.2f} s "
              f"(its CSR {secs['csr_s']:.4f} s, RCM {secs['rcm_s']:.4f} s "
              f"on the host); before -> after: "
              + ", ".join(f"{k} {before[k]} -> {after[k]}" for k in before),
              flush=True)
        if after["mean_distance"] >= before["mean_distance"]:
            raise AssertionError(f"RCM did not pack {name}'s edges")
    return rcm, out


def _reorder_cli(counters, jsonl, path_launches, path_replayed):
    """Cora GAT_sparse ``--reorder`` by the per-epoch loop and Pubmed
    GATv2_sparse ``--reorder --epoch-chunk`` by the fast loop through the
    CLI, the counters set to 0 just before each run and read just after:
    finite, falling training losses, and only the stream path's kernels
    launched, as many as phase 4 states."""
    runs = [("cora GAT_sparse --reorder, per-epoch loop", "fused_v1",
             V1_EPOCHS, ["--dataset", "cora", "--model", "GAT_sparse",
                         "--reorder"]),
            ("pubmed GATv2_sparse --reorder, fast loop", "fused_v2",
             TRAIN_EPOCHS, ["--dataset", "pubmed", "--model", "GATv2_sparse",
                            "--reorder", "--epoch-chunk", str(EPOCH_CHUNK)])]
    for label, fused_name, epochs, argv in runs:
        got, losses, replays, captured, _ = _train_cli(argv, epochs, counters,
                                                       jsonl)
        by_replay = {name: replays * n for name, n in captured.items()}
        path_launches[label], path_replayed[label] = got, by_replay
        print(f"phase 11: {label}: wrapper launches "
              f"{ {k: v for k, v in got.items() if v} }; {replays} CUDA graph "
              f"replays, each launching "
              f"{ {k: v for k, v in captured.items() if v} }; train losses "
              f"{losses}", flush=True)
        if "fast loop" in label:
            want = {fused_name: 2 * 4 + 2, "stream_scatter": 2 * 4}
            want_captured = {fused_name: 4, "stream_scatter": 4}
            if replays != epochs or {k: v for k, v in captured.items()
                                     if v} != want_captured:
                raise AssertionError(f"{label}: {replays} replays of "
                                     f"{captured}")
        else:
            want = {fused_name: 2 * 2 * epochs + 2,
                    "stream_scatter": 2 * 2 * epochs}
            if replays:
                raise AssertionError(f"{label}: CUDA graph replays")
        if {k: v for k, v in got.items() if v} != want:
            raise AssertionError(f"{label}: launches {got}, want {want} and "
                                 "no other kernel")


def _reorder_timings(datasets, rcm, gen, fused, kernel_cases):
    """Rows 1-3 at the presets' widths on Cora and Pubmed in RCM order (the
    cases phase 11 checked) and unreordered (fresh inputs of the same
    shapes), timed by phase 5's timers (kernel, plain version, bound,
    ``index_add_`` for row 1) in turns, unreordered, RCM, RCM, unreordered;
    each case keeps the better of its two kernel times. Returns the
    pairs."""
    import torch

    from pygat_tpu_torch.models.presets import PRESETS

    pairs = []
    for name in ("cora", "pubmed"):
        heads = PRESETS[name]["nheads"]
        feats = PRESETS[name]["nfeats"][1:]
        graphs = {"plain": datasets[name].graph, "rcm": rcm[name].graph}
        g_p = graphs["plain"]
        # (kernel name, its kernel and plain version or None for row 1,
        # the unreordered case, the RCM case)
        rows = [c for c in kernel_cases["stream_scatter"]
                if c["dataset"] == f"{name} rcm"]
        trip = [("stream_scatter", None, a, b) for a, b in zip(
            _scatter_cases(f"{name} unreordered", g_p, heads, feats, gen),
            rows)]
        for kname, (kernel, plain, make_inputs) in fused.items():
            rows = [c for c in kernel_cases[kname]
                    if c["dataset"] == f"{name} rcm"]
            for h, f, b in zip(heads, feats, rows):
                a = dict(dataset=f"{name} unreordered", H=h, F=f,
                         args=make_inputs(g_p, h, f, gen),
                         n_live=int((g_p.r_local < 128).sum()))
                trip.append((kname, (kernel, plain), a, b))
        runs = {}
        for order in ("plain", "rcm", "rcm", "plain"):
            for i, (kname, fk, a, b) in enumerate(trip):
                case = a if order == "plain" else b
                if fk is None:
                    _time_scatter(case, graphs[order])
                else:
                    _time_fused(kname, *fk, case, graphs[order])
                runs.setdefault((i, order), []).append(case["ms"])
        for i, (kname, _, a, b) in enumerate(trip):
            a["ms"], b["ms"] = min(runs[i, "plain"]), min(runs[i, "rcm"])
            what = (f"{b['path']} {b['side']} L={b['L']}" if "side" in b
                    else f"H={b['H']} F={b['F']}")
            pairs.append(dict(kernel=kname, dataset=name, case=what,
                              unreordered_ms=a["ms"], rcm_ms=b["ms"],
                              unreordered_bound_ms=a["bound_ms"],
                              rcm_bound_ms=b["bound_ms"],
                              rcm_library_ms=b["library_ms"]))
            print(f"phase 11: {kname} {name} {what}: RCM order "
                  f"{b['ms']:.4f} ms against {a['ms']:.4f} ms unreordered "
                  f"(bounds {b['bound_ms']:.5f} / {a['bound_ms']:.5f} ms; "
                  f"the better of two runs each, in turns)", flush=True)
            for case in (a, b):
                case.pop("args", None)
                case.pop("data", None)
        del trip, runs
        torch.cuda.empty_cache()
    return pairs


def _reorder_epochs(datasets, rcm):
    """The Cora epoch of both sparse models by both loops (phase 5's
    :func:`_epoch_ms`), unreordered and in RCM order, in turns (plain,
    RCM, RCM, plain); medians of each order's two runs."""
    out = {}
    for lt in ("GAT_sparse", "GATv2_sparse"):
        cfg = _preset_cfg("cora", lt, datasets["cora"])
        res = {"plain": [], "rcm": []}
        for order in ("plain", "rcm", "rcm", "plain"):
            ds = datasets["cora"] if order == "plain" else rcm["cora"]
            samples, fast = _epoch_ms(cfg, ds)
            res[order].append((samples[len(samples) // 2],
                               fast[len(fast) // 2]))
        out[lt] = {f"{order}_{loop}_ms": [r[i] for r in runs]
                   for order, runs in res.items()
                   for i, loop in enumerate(("per_epoch_loop", "fast_loop"))}
        print(f"phase 11: Cora {lt} epoch, host clock (medians of 30 "
              f"per-epoch-loop epochs and of {TIMED_CHUNKS} chunks of 10 "
              f"replays, two runs an order): "
              + "; ".join(f"{k} {[round(v, 4) for v in vs]}"
                          for k, vs in out[lt].items()), flush=True)
    return out


def _fast_ppi(ppi, counters, jsonl, path_launches, path_replayed):
    """``fit_inductive_fast`` on the PPI stand-in at the preset's full
    width (dropout off, as the preset has it), both sparse models, for
    FAST_PPI_EPOCHS epochs, the counters set to 0 just before and
    read just after: the launches :func:`_want_ppi` states and no other
    kernel; its validation and training losses against
    ``fit_inductive``'s on the same seeds within LOOPS_RTOL; each loop's
    epoch seconds (host clock, from its records, the first epoch left
    out)."""
    from pygat_tpu_torch.data.ppi import ppi_config
    from pygat_tpu_torch.models.presets import TRAIN_PRESETS
    from pygat_tpu_torch.train.inductive import fit_inductive, fit_inductive_fast
    from pygat_tpu_torch.train.logging import TrainLogger

    epochs = FAST_PPI_EPOCHS
    kw = dict(batch_size=2, **TRAIN_PRESETS["ppi"], epochs=epochs,
              patience=100, device="cuda")
    n_train = -(-len(ppi.train) // 2)
    n_eval = epochs * -(-len(ppi.valid) // 2) + -(-len(ppi.test) // 2)
    out = {}
    for lt in ("GAT_sparse", "GATv2_sparse"):
        cfg = ppi_config(lt)
        if cfg.dropout:
            raise AssertionError("the PPI preset has dropout on")
        recs = {}
        for loop, fit, extra in (("fast", fit_inductive_fast, {}),
                                 ("per_batch", fit_inductive,
                                  dict(log_batches=False))):
            if os.path.exists(jsonl):
                os.remove(jsonl)
            for fn in counters.values():
                fn.launches = 0
            logger = TrainLogger(stream=io.StringIO(), jsonl_path=jsonl)
            res = fit(cfg, ppi, logger=logger, **kw, **extra)
            got = {name: fn.launches for name, fn in counters.items()}
            logger.close()
            with open(jsonl) as fh:
                recs[loop] = [r for r in map(json.loads, fh)
                              if r["kind"] == "ppi_epoch"]
            if loop == "fast":
                label = f"ppi {lt}, stacked loop (fit_inductive_fast)"
                path_launches[label] = got
                path_replayed[label] = dict.fromkeys(counters, 0)
                want = _want_ppi("fused_v2" if lt == "GATv2_sparse"
                                 else "fused_v1", epochs, n_train, n_eval)
                print(f"phase 11: {label}: wrapper launches "
                      f"{ {k: v for k, v in got.items() if v} }; train "
                      f"losses {[r['loss_train'] for r in recs[loop]]}; "
                      f"validation losses {res.history}", flush=True)
                if {k: v for k, v in got.items() if v} != want:
                    raise AssertionError(f"{label}: launches {got}, want "
                                         f"{want} and no other kernel")
                if not all(math.isfinite(v) for v in res.history):
                    raise AssertionError(f"{label}: losses not finite")
        worst = max(abs(a[k] - b[k]) / abs(b[k])
                    for a, b in zip(recs["fast"], recs["per_batch"])
                    for k in ("loss_train", "loss_val"))
        times = {f"{loop}_epoch_s": [r["time"] for r in rs[1:]]
                 for loop, rs in recs.items()}
        out[lt] = dict(times, worst_rel_diff=worst)
        print(f"phase 11: PPI {lt}, stacked loop vs per-batch loop, "
              f"{epochs} epochs' train and validation losses: worst relative "
              f"difference {worst:.3e} (allowed {LOOPS_RTOL:.0e}); epoch "
              f"seconds, host clock, after the first: "
              + "; ".join(f"{k} {[round(v, 4) for v in vs]}"
                          for k, vs in times.items()), flush=True)
        if not worst <= LOOPS_RTOL:
            raise AssertionError("the stacked loop's losses differ from the "
                                 "per-batch loop's")
    return out


def _reorder_phase(datasets, ppi, gen, fused, kernel_cases, counters, jsonl,
                   path_launches, path_replayed):
    """Phase 11: the graph library and the reordered loads
    (:func:`_reorder_loads`); rows 1-3 on the reordered Cora and Pubmed
    at the presets' widths against their f64 plain versions (twice, equal
    bit for bit; :func:`_stream_kernel_cases`); both Cora sparse models in
    RCM order card vs CPU; the CLI with ``--reorder``
    (:func:`_reorder_cli`); the stacked PPI loop (:func:`_fast_ppi`); the
    kernels timed in both orders (:func:`_reorder_timings`) and the Cora
    epochs in both (:func:`_reorder_epochs`). Returns its numbers."""
    from pygat_tpu_torch.models.presets import PRESETS

    rcm, out = _reorder_loads(datasets)
    for name, ds in rcm.items():
        _stream_kernel_cases(f"{name} rcm", ds.graph, PRESETS[name]["nheads"],
                             PRESETS[name]["nfeats"][1:], gen, fused,
                             kernel_cases)
    for lt in ("GAT_sparse", "GATv2_sparse"):
        _card_vs_cpu(f"phase 11: Cora {lt} in RCM order",
                     _preset_cfg("cora", lt, rcm["cora"]),
                     rcm["cora"].features, rcm["cora"].graph)
    _reorder_cli(counters, jsonl, path_launches, path_replayed)
    out["ppi_fast"] = _fast_ppi(ppi, counters, jsonl, path_launches,
                                path_replayed)
    out["kernels"] = _reorder_timings(datasets, rcm, gen, fused,
                                      kernel_cases)
    out["cora_epoch_ms"] = _reorder_epochs(datasets, rcm)
    return out


# -- phase 12: the model axis on one card ---------------------------------------


def _model_axis_specs(datasets, ppi_x, ppi_g):
    """The configurations of phase 12: (label, features, graph, preset
    config by layer type, M), Cora at M = 2 and 4, Pubmed (8, 8) at M = 2,
    PPI at M = 2 and 4 (whose 6-head output layer stays whole at 4)."""
    from pygat_tpu_torch.data.ppi import ppi_config

    cora, pubmed = datasets["cora"], datasets["pubmed"]
    specs = []
    for m in MODEL_AXIS_M:
        specs.append((f"cora M{m}", cora.features, cora.graph,
                      lambda lt, ds=cora: _preset_cfg("cora", lt, ds), m))
    specs.append(("pubmed M2", pubmed.features, pubmed.graph,
                  lambda lt: _preset_cfg("pubmed", lt, pubmed), 2))
    for m in MODEL_AXIS_M:
        specs.append((f"ppi batch M{m}", ppi_x, ppi_g, ppi_config, m))
    return specs


def _split_widths(cfg, m):
    """The distinct (H/M, F) of ``cfg``'s layers that split at ``m``."""
    from pygat_tpu_torch.parallel.sharding import split_leaf

    out = []
    for h, f in zip(cfg.nheads, cfg.nfeats[1:]):
        if split_leaf((h,), m) and (h // m, f) not in out:
            out.append((h // m, f))
    return out


def _model_axis_kernels(specs, datasets, gen, fused, kernel_cases):
    """Rows 1-3 at every H/M width of the configurations (a split layer's
    per-rank heads) against their f64 plain versions, called twice, equal
    bit for bit (:func:`_stream_kernel_cases`; PPI's GATv2 with exact
    bounds), and the ring's per-hop kernels at Cora's H/M widths, every
    hop of 4 shards, rotation and halo (:func:`_check_ring_hops`). Returns
    the new cases by (kernel, label, H, F)."""
    from pygat_tpu_torch.ops.fused_stream import fused_v2, fused_v2_plain

    ppi_fused = dict(fused, fused_v2=(fused_v2, fused_v2_plain,
                                      _fused_v2_exact_inputs))
    for label, _, g, cfg_of, m in specs:
        widths = _split_widths(cfg_of("GAT_sparse"), m)
        print(f"phase 12: {label}: split widths (H/M, F) {widths}",
              flush=True)
        _stream_kernel_cases(label, g, *zip(*widths), gen,
                             ppi_fused if label.startswith("ppi") else fused,
                             kernel_cases)
    rp = _ring_partition("cora", datasets["cora"], phase=12)
    for m in MODEL_AXIS_M:
        for v2 in (False, True):
            _check_ring_hops(f"cora M{m}", rp, 8 // m, 8, v2, gen,
                             kernel_cases)
    del rp


def _model_axis_vs_whole(specs, cora, counters, path_launches,
                         path_replayed):
    """The main path of phase 12: for each configuration and both sparse
    models (dropout off), the per-rank code of the model axis,
    ``apply_gat_pieces`` over every model rank's heads on the card, forward
    and backward, with the counters set to 0 just before the pieces run and
    read just after (the single-device references run before); the joined
    output and every rank's gradients put together against the
    single-device model on the card within MODEL_RTOL. Then, on Cora at M =
    2, MODEL_AXIS_STEPS Adam steps of the split states (each rank its own
    optimizer) against the same steps on one device, the losses within
    LOOPS_RTOL, and a step with the preset's dropout from each rank's
    generators (finite). Returns the launches and the split-state bytes."""
    import torch

    from pygat_tpu_torch.models.gat import (
        HeadGenerators,
        apply_gat,
        apply_gat_pieces,
        init_gat,
        parameters,
    )
    from pygat_tpu_torch.parallel.distributed import slice_state
    from pygat_tpu_torch.train.state import (
        init_state,
        leaf_split,
        make_optimizer,
        tensor_leaves,
    )
    from pygat_tpu_torch.utils.platform import make_generator

    def whole_state(cfg, dropout_gen=None):
        params = init_gat(cfg, make_generator("cpu", 72), device="cuda")
        return init_state(params, make_optimizer(params, 0.005, 5e-4),
                          dropout_gen)

    runs, refs = [], {}
    for label, x, g, cfg_of, m in specs:
        for lt in ("GAT_sparse", "GATv2_sparse"):
            cfg = cfg_of(lt)._replace(dropout=0.0)
            state = whole_state(cfg)
            out = apply_gat(state.params, cfg, x, g, None, train=False)
            torch.sin(out[g.node_mask]).sum().backward()
            refs[label, lt] = (out.detach(), [p.grad.detach().clone()
                                              for p in parameters(
                                                  state.params)])
            runs.append((label, lt, cfg, x, g, m, state))
    steps_ref = {}
    for lt in ("GAT_sparse", "GATv2_sparse"):
        cfg = _preset_cfg("cora", lt, cora)._replace(dropout=0.0)
        steps_ref[lt] = _steps_losses([whole_state(cfg)], cfg, cora, [None])
    for fn in counters.values():
        fn.launches = 0
    got = {}
    for label, lt, cfg, x, g, m, state in runs:
        shares = [slice_state(state, k, m) for k in range(m)]
        out = apply_gat_pieces([s.params for s in shares], cfg, x, g,
                               [None] * m, train=False)
        torch.sin(out[g.node_mask]).sum().backward()
        grads = []
        for i, flag in enumerate(shares[0].split or
                                 [False] * len(parameters(state.params))):
            mine = [parameters(s.params)[i].grad for s in shares]
            grads.append(torch.cat(mine) if flag else mine[0])
        got[label, lt] = (out.detach(), grads, shares)
    steps = {}
    for lt in ("GAT_sparse", "GATv2_sparse"):
        cfg = _preset_cfg("cora", lt, cora)._replace(dropout=0.0)
        shares = [slice_state(whole_state(cfg), k, 2) for k in range(2)]
        steps[lt] = _steps_losses(shares, cfg, cora, [None] * 2)
        cfg = _preset_cfg("cora", lt, cora)
        gens = [HeadGenerators(make_generator("cuda", 7),
                               make_generator("cuda", 8 + k))
                for k in range(2)]
        drop = _steps_losses([slice_state(whole_state(cfg), k, 2)
                              for k in range(2)], cfg, cora, gens,
                             train=True)
        if not all(math.isfinite(v) for v in drop):
            raise AssertionError(f"model axis {lt} under dropout: losses "
                                 f"{drop}")
    torch.cuda.synchronize()
    launches = {name: fn.launches for name, fn in counters.items()}
    label = "model axis, per-rank pieces on one card"
    path_launches[label] = launches
    path_replayed[label] = dict.fromkeys(counters, 0)
    print(f"phase 12: {label}: wrapper launches "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    for name in ("fused_v1", "fused_v2", "stream_scatter"):
        if not launches[name]:
            raise AssertionError(f"the model axis path launched no {name}")

    out_bytes = {}
    for label, lt, cfg, x, g, m, _ in runs:
        out_w, grads_w = refs[label, lt]
        out_p, grads_p, shares = got[label, lt]
        mask = g.node_mask
        scale = max(1.0, float(out_w[mask].abs().max()))
        err = float((out_p[mask] - out_w[mask]).abs().max())
        print(f"phase 12: {label} {lt}: joined forward vs one device, "
              f"max_abs_err {err:.3e} (allowed {MODEL_RTOL * scale:.3e})")
        if not err <= MODEL_RTOL * scale:
            raise AssertionError("the model axis's forward disagrees")
        _check_grads(cfg, grads_p, grads_w, "model axis vs one device")
        if lt == "GAT_sparse":
            split = sum(t.numel() * t.element_size()
                        for t, f in zip(tensor_leaves(shares[0]),
                                        leaf_split(shares[0])) if f)
            whole = split * m
            out_bytes[label] = dict(
                split_leaves=[i for i, f in enumerate(shares[0].split) if f],
                rank_split_state_bytes=split, whole_split_state_bytes=whole)
            print(f"phase 12: {label}: split leaves (parameters() order) "
                  f"{out_bytes[label]['split_leaves']}; split state "
                  f"(parameters and Adam moments) {split} bytes a rank of "
                  f"{whole} whole (1/{m})", flush=True)
    for lt in steps:
        worst = max(abs(a - b) / abs(b) for a, b in zip(steps[lt],
                                                        steps_ref[lt]))
        print(f"phase 12: Cora {lt} M2, {MODEL_AXIS_STEPS} Adam steps of "
              f"the split states: losses {steps[lt]} vs one device "
              f"{steps_ref[lt]}: worst relative difference {worst:.3e} "
              f"(allowed {LOOPS_RTOL:.0e})", flush=True)
        if not worst <= LOOPS_RTOL:
            raise AssertionError("the split states' steps differ from one "
                                 "device's")
    return dict(launches=launches, split_state=out_bytes,
                steps_losses={lt: [steps[lt], steps_ref[lt]] for lt in steps})


def _steps_losses(shares, cfg, cora, gens, train=False):
    """MODEL_AXIS_STEPS Adam steps of the NLL over Cora's train split
    through ``apply_gat_pieces`` over the model ranks' states ``shares``
    (each rank its own optimizer; one whole state runs the model on one
    device); returns each step's loss."""
    import torch
    import torch.nn.functional as F

    from pygat_tpu_torch.models.gat import apply_gat_pieces

    x, g = cora.features, cora.graph
    ds_idx, labels = cora.idx_train.long(), cora.labels.long()
    losses = []
    for _ in range(MODEL_AXIS_STEPS):
        for s in shares:
            s.optimizer.zero_grad(set_to_none=True)
        out = apply_gat_pieces([s.params for s in shares], cfg, x, g, gens,
                               train=train)
        lp = F.log_softmax(F.elu(out), dim=1)
        loss = F.nll_loss(lp[ds_idx], labels[ds_idx])
        loss.backward()
        for s in shares:
            s.optimizer.step()
        losses.append(float(loss.detach()))
    torch.cuda.synchronize()
    return losses


def _dense_rows_vs_whole(cora):
    """Cora's dense GAT and GATv2 at (D, M) = (2, 2) as four row x head
    pieces (``dense_rows_grid``: the trainer's per-rank layer, the sender
    tables joined by ``torch.cat``) on the card against the single-device
    dense model on the card, eval: the output and every model rank's
    gradients put together, within MODEL_RTOL."""
    import torch

    from pygat_tpu_torch.models.gat import apply_gat, init_gat, parameters
    from pygat_tpu_torch.parallel.ring_model import dense_rows_grid
    from pygat_tpu_torch.parallel.sharding import head_slice, split_leaf
    from pygat_tpu_torch.train.loop import rows_neighborhood
    from pygat_tpu_torch.utils.platform import make_generator

    g = cora.graph
    n, mask = g.num_nodes_padded, g.node_mask
    for lt in ("GAT", "GATv2"):
        cfg = _preset_cfg("cora", lt, cora)
        params = init_gat(cfg, make_generator("cpu", 72), device="cuda")
        want = apply_gat(params, cfg, cora.features, g, None, train=False)
        grads_w = torch.autograd.grad(torch.sin(want[mask]).sum(),
                                      parameters(params))
        ranks = [[type(lp)(*(None if t is None else
                             t.detach().clone().requires_grad_()
                             for t in lp))
                  for lp in head_slice(params, k, 2)] for k in range(2)]
        got = dense_rows_grid(
            ranks, cfg,
            [cora.features[k * n // 2:(k + 1) * n // 2] for k in range(2)],
            [rows_neighborhood(g, k * n // 2, (k + 1) * n // 2)
             for k in range(2)])
        torch.sin(got[mask]).sum().backward()
        grads_p = []
        for i, t in enumerate(parameters(params)):
            mine = [parameters(r)[i].grad for r in ranks]
            grads_p.append(torch.cat(mine) if split_leaf(
                tuple(t.shape), 2) else mine[0])
        scale = max(1.0, float(want[mask].abs().max()))
        err = float((got[mask] - want[mask]).abs().max())
        print(f"phase 12: Cora {lt} (dense) at (D, M) = (2, 2), four row x "
              f"head pieces vs one device: max_abs_err {err:.3e} (allowed "
              f"{MODEL_RTOL * scale:.3e})", flush=True)
        if not err <= MODEL_RTOL * scale:
            raise AssertionError("the dense rows disagree with one device")
        _check_grads(cfg, grads_p, grads_w, "dense rows vs one device")
        del want, got, grads_w, grads_p, ranks
    torch.cuda.empty_cache()


def _model_axis_timings(specs, kernel_cases, fused):
    """Rows 1-3 timed at every H/M width of phase 12 (kernel, plain
    version, bound, ``index_add_`` for row 1) beside the same kernel's
    full-H time at that layer (phases 5 and 8). Returns one record a
    case."""
    import torch

    graphs = {label: g for label, _, g, _, _ in specs}
    full = {}
    for kname in ("fused_v1", "fused_v2"):
        for c in kernel_cases[kname]:
            full[kname, c["dataset"], c["F"]] = (c["H"], c.get("ms"),
                                                 c.get("bound_ms"))
    out = []
    for kname, (kernel, plain, _) in fused.items():
        for case in kernel_cases[kname]:
            if case["dataset"] not in graphs or "path" in case:
                continue
            _time_fused(kname, kernel, plain, case, graphs[case["dataset"]])
            base = case["dataset"].rsplit(" M", 1)[0]
            h_full, ms_full, bound_full = full.get(
                (kname, base, case["F"]), (None, None, None))
            out.append(dict(kernel=kname, dataset=case["dataset"],
                            H=case["H"], F=case["F"], ms=case["ms"],
                            bound_ms=case["bound_ms"],
                            plain_ms=case["plain_ms"], full_H=h_full,
                            full_ms=ms_full, full_bound_ms=bound_full))
            print(f"phase 12: {kname} {case['dataset']} H={case['H']} "
                  f"F={case['F']}: {case['ms']:.4f} ms (bound "
                  f"{case['bound_ms']:.5f}) against {ms_full} ms at H="
                  f"{h_full} (bound {bound_full})", flush=True)
    for case in kernel_cases["stream_scatter"]:
        if case["dataset"] in graphs:
            _time_scatter(case, graphs[case["dataset"]])
            out.append({k: case[k] for k in (
                "dataset", "path", "side", "L", "ms", "plain_ms",
                "library_ms", "bound_ms")} | {"kernel": "stream_scatter"})
    for cases in kernel_cases.values():
        for case in cases:
            case.pop("args", None)
            case.pop("data", None)
    torch.cuda.empty_cache()
    return out


def _model_axis_phase(datasets, ppi, gen, fused, kernel_cases, counters,
                      path_launches, path_replayed):
    """Phase 12, the model axis on one card (one card holds one NCCL rank,
    so the per-rank code runs every model rank in turn on this device):
    the kernels at the H/M widths (:func:`_model_axis_kernels`), the main
    path of per-rank pieces against one device
    (:func:`_model_axis_vs_whole`), the dense rows
    (:func:`_dense_rows_vs_whole`), the timings
    (:func:`_model_axis_timings`). Returns its numbers."""
    import torch

    from pygat_tpu_torch.data.ppi import batch_bounds, make_batches

    cora = datasets["cora"]
    bounds = [batch_bounds(s, 2) for s in (ppi.train, ppi.valid, ppi.test)]
    pb = next(make_batches(ppi.train, 2, n_pad=max(b[0] for b in bounds),
                           e_pad=max(b[1] for b in bounds), shuffle=True,
                           seed=72, device="cuda"))
    specs = _model_axis_specs(datasets, pb.features, pb.batch.graph)
    _model_axis_kernels(specs, datasets, gen, fused, kernel_cases)
    out = _model_axis_vs_whole(specs, cora, counters, path_launches,
                               path_replayed)
    _dense_rows_vs_whole(cora)
    out["kernels"] = _model_axis_timings(specs, kernel_cases, fused)
    del pb, specs
    torch.cuda.empty_cache()
    return out


# -- phase 13: the fastest precision mode -------------------------------------


@contextlib.contextmanager
def _precision(name):
    """The stream sums' module default (``PYGAT_STREAM_PRECISION``) set to
    ``name`` in the body, and restored after it."""
    from pygat_tpu_torch.ops import segment

    old = segment._STREAM_PRECISION
    segment._STREAM_PRECISION = name
    try:
        yield
    finally:
        segment._STREAM_PRECISION = old


def _want_fastest(fused_name, epochs, fast):
    """The wrapper launches of a Cora run of the CLI under "fastest": as
    phase 4 states for the f32 kernels, on the one-limb ones."""
    if fast:  # warm-up epoch + captured epoch, and the test forward
        return {fused_name: 2 * 4 + 2, "stream_scatter_bf16": 2 * 4}
    return {fused_name: 2 * 2 * epochs + 2,
            "stream_scatter_bf16": 2 * 2 * epochs}


def _fastest_clis(counters, jsonl, path_launches, path_replayed):
    """Cora GAT_sparse and GATv2_sparse through the CLI under "fastest" by
    both loops, and through the ring CLI at world size 1 (GAT_sparse by
    the per-epoch loop, GATv2_sparse by the fast loop), each with the
    counters set to 0 just before and read just after: finite, falling
    training losses, the one-limb kernels launched as many times as the
    f32 ones are under "high", the f32 kernels not at all. The GATv2_sparse
    fast loop runs as a subprocess given ``PYGAT_STREAM_PRECISION=fastest``
    (the environment variable reaches the main path), and its printed
    counts are read."""
    runs = []
    for lt, fused_name in (("GAT_sparse", "fused_v1_bf16"),
                           ("GATv2_sparse", "fused_v2_bf16")):
        base = ["--dataset", "cora", "--model", lt]
        runs.append((f"cora {lt}, per-epoch loop, fastest", fused_name,
                     V1_EPOCHS, base, False))
        runs.append((f"cora {lt}, fast loop, fastest", fused_name,
                     TRAIN_EPOCHS, base + ["--epoch-chunk", str(EPOCH_CHUNK)],
                     lt == "GATv2_sparse"))
    for label, fused_name, epochs, argv, subprocess_run in runs:
        fast = "fast loop" in label
        if subprocess_run:
            got, losses, replays, captured = _cli_fastest(argv, epochs, jsonl)
        else:
            with _precision("fastest"):
                got, losses, replays, captured, _ = _train_cli(
                    argv, epochs, counters, jsonl)
        want = _want_fastest(fused_name, epochs, fast)
        on = {k: v for k, v in got.items() if v}
        print(f"phase 13: {label}{' (subprocess)' if subprocess_run else ''}:"
              f" wrapper launches {on}; {replays} CUDA graph replays, each "
              f"launching { {k: v for k, v in captured.items() if v} }; "
              f"train losses {[round(v, 4) for v in losses]}", flush=True)
        if on != want:
            raise AssertionError(f"{label}: launches {on}, want {want}")
        one_replay = {k: v for k, v in captured.items() if v}
        if fast and (replays != epochs or one_replay != {
                fused_name: 4, "stream_scatter_bf16": 4}):
            raise AssertionError(f"{label}: {replays} replays of {captured}")
        if not fast and replays:
            raise AssertionError(f"{label}: CUDA graph replays in the "
                                 "per-epoch loop")
        path_launches[label] = {k: got.get(k, 0) for k in counters}
        path_replayed[label] = {k: replays * captured.get(k, 0)
                                for k in counters}
    for lt, parts in (("GAT_sparse", "fused_v1_parts_bf16"),
                      ("GATv2_sparse", "fused_v2_parts_bf16")):
        fast = lt == "GATv2_sparse"
        label = (f"ring {lt} at world size 1, "
                 f"{'fast' if fast else 'per-epoch'} loop, fastest")
        argv = ["--dataset", "cora", "--model", lt, "--mesh", "1,1",
                "--partition", "ring", "--distributed"]
        if fast:
            argv += ["--epoch-chunk", str(EPOCH_CHUNK)]
        with _one_rank(), _precision("fastest"):
            got, losses, replays, captured, text = _train_cli(
                argv, TRAIN_EPOCHS, counters, jsonl)
        on = {k: v for k, v in got.items() if v}
        print(f"phase 13: {label}: wrapper launches {on}; {replays} CUDA "
              f"graph replays, each launching "
              f"{ {k: v for k, v in captured.items() if v} }; train losses "
              f"{[round(v, 4) for v in losses]}", flush=True)
        if "mesh: data=1 model=1" not in text:
            raise AssertionError(f"{label}: the CLI did not run on a mesh")
        if set(on) != {parts, "stream_scatter_bf16"}:
            raise AssertionError(f"{label}: launches {on}")
        path_launches[label] = got
        path_replayed[label] = {k: replays * captured.get(k, 0)
                                for k in counters}


def _cli_fastest(argv, epochs, jsonl):
    """``PYGAT_STREAM_PRECISION=fastest python -m pygat_tpu_torch.cli.train
    argv`` as a subprocess. Returns (the launch counts the CLI printed,
    train losses, its CUDA graph replays, the launches one replay holds)."""
    if os.path.exists(jsonl):
        os.remove(jsonl)
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "pygat_tpu_torch.cli.train", *argv, "--epochs",
         str(epochs), "--no-checkpoint", "--log-every", "1", "--jsonl",
         jsonl],
        cwd=root, env=dict(os.environ, PYGAT_STREAM_PRECISION="fastest"),
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the fastest CLI returned {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    counts = re.search(r"Kernel launches: (\{.*\})", proc.stdout)
    replay = re.search(r"CUDA graph replays: (\d+), each launching (\{.*\})",
                       proc.stdout)
    if counts is None or "start training on cuda" not in proc.stdout:
        raise AssertionError("the fastest CLI did not run on CUDA or print "
                             "its launches:\n" + proc.stdout[-3000:])
    with open(jsonl) as fh:
        recs = [json.loads(line) for line in fh]
    losses = [r["loss_train"] for r in recs if r["kind"] == "epoch"]
    if len(losses) != epochs or not all(math.isfinite(v) for v in losses):
        raise AssertionError("train losses missing or not finite")
    if not losses[-1] < losses[0]:
        raise AssertionError("training loss did not fall")
    if replay is None:
        return json.loads(counts.group(1)), losses, 0, {}
    return (json.loads(counts.group(1)), losses, int(replay.group(1)),
            json.loads(replay.group(2)))


def _fastest_hops(cora, gen, kernel_cases):
    """One ring hop of each model under "fastest" (:func:`_time_ring_hop`:
    hop 1 into shard 0 of Cora's RING_SHARDS-shard blocks, rotation, the
    preset's layer-1 width; out held to FASTEST_RTOL of the same sum over
    |message|)."""
    from pygat_tpu_torch.models.presets import PRESETS

    rp = _ring_partition("cora", cora, phase=13)
    h, f = PRESETS["cora"]["nheads"][0], PRESETS["cora"]["nfeats"][1]
    for v2 in (False, True):
        _time_ring_hop("cora", rp, _ring_tables(rp["il"], h, f, v2, gen), h,
                       f, "rotation", kernel_cases, None,
                       precision="fastest")
    del rp


def _fastest_steps(cfg, cora, plan=None):
    """FASTEST_STEPS Adam steps of Cora's model ``cfg`` without dropout
    from the same parameters under "high" and under "fastest", over the
    receiver stream or the band plan or corner plans ``plan``: each step's
    loss, by precision."""
    import torch

    from pygat_tpu_torch.models.gat import init_gat
    from pygat_tpu_torch.train.loop import make_transductive_steps
    from pygat_tpu_torch.train.state import init_state, make_optimizer
    from pygat_tpu_torch.utils.platform import make_generator

    cfg = cfg._replace(dropout=0.0)
    out = {}
    for prec in ("high", "fastest"):
        with _precision(prec):
            params = init_gat(cfg, make_generator("cpu", 72), device="cuda")
            state = init_state(params, make_optimizer(params, 0.005, 5e-4),
                               make_generator("cuda", 73))
            train_step, _ = make_transductive_steps(cfg, plan)
            losses = []
            for _ in range(FASTEST_STEPS):
                state, loss, _, _ = train_step(state, cora.features,
                                               cora.graph, cora.labels,
                                               cora.idx_train)
                losses.append(float(loss))
        out[prec] = losses
    torch.cuda.synchronize()
    return out


def _fastest_plan_kernels(datasets, large, gen, plans, kernel_cases):
    """The one-limb kernels of the band plan and the corner plans at the
    main path's shapes, held to their plain versions under "fastest" in f64
    and called twice (:func:`_check_banded`, :func:`_window_cases`), then
    timed (:func:`_time_banded`, :func:`_time_window`): the fused banded
    forwards, the take and the sender sum on the 524k graph's automatic
    band plan, on Cora's (``set_band("on")``) and on the hub graph's (a
    tile cut into pieces, at the preset's layer-1 width); the window
    forwards at the Cora and 524k corner shapes. Each case's inputs are
    freed once it is timed."""
    import torch

    from pygat_tpu_torch.models.presets import PRESETS

    cora = datasets["cora"]
    heads, feats = PRESETS["cora"]["nheads"], PRESETS["cora"]["nfeats"]
    hub = _hub_graph()
    hub_plan = plans["hub"]
    band_orders = (
        ("large", large.graph, plans["large"], heads,
         (feats[1], large.num_classes)),
        ("cora, band plan", cora.graph, plans["cora, band plan"], heads,
         (feats[1], cora.num_classes)),
        ("hub", hub, hub_plan, heads[:1], feats[1:2]))
    for label, g, plan, hs, fs_ in band_orders:
        for case in _banded_cases(label, g, plan, hs, fs_, gen, "fastest"):
            _check_banded(case, plan)
            _time_banded(case, plan, label == "large")
            case.pop("args", None)
            case.pop("data", None)
            kernel_cases[case["kernel"]].append(case)
        torch.cuda.empty_cache()
    for label, g, cp, fs_ in (
            ("cora", cora.graph, plans["cora, corner plans"],
             (feats[1], cora.num_classes)),
            ("large", large.graph, plans["large, corner plans"],
             (feats[1], large.num_classes))):
        for case in _window_cases(label, g, cp, heads, fs_, gen, "fastest"):
            _time_window(case, label == "large")
            case.pop("args")
            case.pop("walk")
            kernel_cases[case["kernel"]].append(case)
        torch.cuda.empty_cache()


def _fastest_trainers(large, counters, jsonl, path_launches, path_replayed):
    """The 524k graph, both models, by ``fit_transductive_fast`` under
    "fastest" (:func:`_train_large`: counters set to 0 just before and read
    just after, finite losses, a falling validation loss, the one-limb
    kernels launched as many times as the f32 ones under "high" and no f32
    twin of theirs): over the band plan the trainer picks with no switch,
    and over the corner plans (``set_band("off")``, ``set_corner("on")``)."""
    from pygat_tpu_torch.ops.banded import set_band
    from pygat_tpu_torch.ops.large import set_corner
    from pygat_tpu_torch.tools.profile_epoch import large_config
    from pygat_tpu_torch.train.loop import fit_transductive_fast

    for corner in (False, True):
        if corner:
            set_band("off")
            set_corner("on")
        try:
            for lt in ("GAT_sparse", "GATv2_sparse"):
                order = "corner plans" if corner else "band plan"
                label = f"large {lt}, {order}, fast loop, fastest"
                t1 = time.perf_counter()
                got, _, _, by_replay = _train_large(
                    label, fit_transductive_fast, large_config(lt, large),
                    large, counters, jsonl, corner=corner,
                    precision="fastest", epochs=2 * LARGE_CHUNK,
                    epoch_chunk=LARGE_CHUNK)
                print(f"  ({time.perf_counter() - t1:.1f} s)", flush=True)
                path_launches[label] = got
                path_replayed[label] = {k: by_replay.get(k, 0)
                                        for k in counters}
        finally:
            set_band("auto")
            set_corner("auto")


def _fastest_corner_cli(plans, counters, jsonl, path_launches,
                        path_replayed):
    """Cora GAT_sparse through the CLI with ``--corner on`` under
    "fastest", in process, the counters set to 0 just before and read just
    after: the launches it prints equal the counters, and are those
    ``_want_corner`` states for the one-limb kernels."""
    from pygat_tpu_torch.ops.large import set_corner

    label = "cora GAT_sparse, --corner on CLI, fastest"
    try:
        with _precision("fastest"):
            got, losses, _, _, text = _train_cli(
                ["--dataset", "cora", "--model", "GAT_sparse", "--corner",
                 "on"], V1_EPOCHS, counters, jsonl)
    finally:
        set_corner("auto")
    counts = re.search(r"Kernel launches: (\{.*\})", text)
    if counts is None or "corner_plan" not in text:
        raise AssertionError(f"{label}: no corner plan or no launch counts "
                             f"printed:\n{text[-3000:]}")
    corner = plans["cora, corner plans"]
    want, _ = _want_corner("fused_v1_window_bf16", V1_EPOCHS, False,
                           len(corner.fwd.passes), len(corner.inv.passes),
                           "fastest")
    on = {k: v for k, v in got.items() if v}
    print(f"phase 13: {label}: launches it printed {counts.group(1)}; train "
          f"losses {[round(v, 4) for v in losses]}", flush=True)
    if json.loads(counts.group(1)) != got or on != want:
        raise AssertionError(f"{label}: launches {on}, want {want}")
    path_launches[label] = got
    path_replayed[label] = dict.fromkeys(counters, 0)


def _fastest_large_epochs(large, plans):
    """Host ms per 524k fast-loop epoch of both models in both modes over
    the band plan and the corner plans, in turns (:func:`_large_epoch_ms`:
    one captured epoch on the card at a time, LARGE_ROUNDS rounds, the
    order reversed from round to round). Returns the medians and the peak
    memory by model."""
    from pygat_tpu_torch.tools.profile_epoch import large_config

    visits = {f"{order} {prec}": (plans[key], prec)
              for order, key in (("band", "large"),
                                 ("corner", "large, corner plans"))
              for prec in ("high", "fastest")}
    out = {}
    for lt in ("GAT_sparse", "GATv2_sparse"):
        res, peak_gib = _large_epoch_ms(
            large_config(lt, large), large,
            {k: v[0] for k, v in visits.items()},
            {k: v[1] for k, v in visits.items()})
        out[lt] = {f"fast_loop_{k.replace(' ', '_')}_ms": v[len(v) // 2]
                   for k, v in res.items()}
        out[lt]["peak_allocated_gib"] = peak_gib
        print(f"phase 13: large {lt} epoch by the fast loop, host clock, in "
              f"turns (peak allocated {peak_gib:.2f} GiB): "
              + "; ".join(f"{k}: median {v[len(v) // 2]:.4f} ms (all "
                          f"{[round(x, 4) for x in v]})"
                          for k, v in res.items()), flush=True)
    return out


def _fastest_phase(datasets, large, ppi, gen, plans, kernel_cases, counters,
                   jsonl, path_launches, path_replayed):
    """Phase 13, the fastest precision mode (module docstring); ``plans``
    by name: the band plans ``large`` (maybe_plan_large's at 524k), ``cora,
    band plan`` and ``hub``, and the corner plans ``cora, corner plans``
    and ``large, corner plans``. Returns its numbers."""
    import torch

    from pygat_tpu_torch.data.ppi import batch_bounds, make_batches
    from pygat_tpu_torch.models.presets import PRESETS
    from pygat_tpu_torch.ops.fused_stream import (
        fused_v1,
        fused_v1_plain,
        fused_v2,
        fused_v2_plain,
    )

    cora = datasets["cora"]
    fused = {"fused_v1": (fused_v1, fused_v1_plain, _fused_inputs),
             "fused_v2": (fused_v2, fused_v2_plain, _fused_v2_inputs)}
    ppi_fused = dict(fused, fused_v2=(fused_v2, fused_v2_plain,
                                      _fused_v2_exact_inputs))
    bounds = [batch_bounds(s, 2) for s in (ppi.train, ppi.valid, ppi.test)]
    pb = next(make_batches(ppi.train, 2, n_pad=max(b[0] for b in bounds),
                           e_pad=max(b[1] for b in bounds), shuffle=True,
                           seed=72, device="cuda"))
    heads, feats = PRESETS["cora"]["nheads"], PRESETS["cora"]["nfeats"]
    graphs = {
        "cora": (cora.graph, heads, feats[1:], fused),
        "pubmed": (datasets["pubmed"].graph, PRESETS["pubmed"]["nheads"],
                   PRESETS["pubmed"]["nfeats"][1:], fused),
        "large": (large.graph, heads, (feats[1], large.num_classes), fused),
        "ppi batch": (pb.batch.graph, *zip(*PPI_WIDTHS), ppi_fused),
    }
    names = ("stream_scatter_bf16", "fused_v1_bf16", "fused_v2_bf16")
    for name, (g, hs, fs_, fz) in graphs.items():
        _stream_kernel_cases(name, g, hs, fs_, gen, fz, kernel_cases,
                             precision="fastest")
        for case in kernel_cases["stream_scatter_bf16"]:
            if case["dataset"] == name:
                _time_scatter(case, g)
                del case["data"]
        for kname in names[1:]:
            kernel, plain, _ = fz[kname[:-len("_bf16")]]
            for case in kernel_cases[kname]:
                if case["dataset"] == name:
                    _time_fused(kname, kernel, plain, case, g)
                    del case["args"]
        torch.cuda.empty_cache()
    del pb, graphs
    _fastest_hops(cora, gen, kernel_cases)
    torch.cuda.empty_cache()
    # the band plan's and the corner plans' one-limb kernels
    _fastest_plan_kernels(datasets, large, gen, plans, kernel_cases)

    _fastest_clis(counters, jsonl, path_launches, path_replayed)
    _fastest_trainers(large, counters, jsonl, path_launches, path_replayed)
    _fastest_corner_cli(plans, counters, jsonl, path_launches, path_replayed)
    orders = {"receiver stream": None,
              "band plan": plans["cora, band plan"],
              "corner plans": plans["cora, corner plans"]}
    out = {"steps": {}, "epoch_ms": {}}
    for lt in ("GAT_sparse", "GATv2_sparse"):
        cfg = _preset_cfg("cora", lt, cora)
        for over, plan in orders.items():
            steps = _fastest_steps(cfg, cora, plan)
            worst = max(abs(a - b) / abs(b)
                        for a, b in zip(steps["fastest"], steps["high"]))
            out["steps"][f"{lt}, {over}"] = dict(steps, worst_relative=worst)
            print(f"phase 13: Cora {lt} over the {over}, {FASTEST_STEPS} Adam "
                  f"steps without dropout: losses under 'fastest' "
                  f"{steps['fastest']}, under 'high' {steps['high']}; worst "
                  f"relative difference {worst:.3e} (allowed "
                  f"{FASTEST_STEPS_RTOL:.3e})", flush=True)
            if not worst <= FASTEST_STEPS_RTOL:
                raise AssertionError("the 'fastest' steps stray from 'high'")
            with _precision("fastest"):
                _card_vs_cpu(f"phase 13: Cora {lt} over the {over} under "
                             "'fastest'", cfg, cora.features, cora.graph,
                             plan, rtol=FASTEST_RTOL)
        # the Cora epoch in both modes, in turns
        runs = {}
        for prec in ("high", "fastest", "fastest", "high"):
            with _precision(prec):
                samples, fast = _epoch_ms(cfg, cora)
            runs.setdefault(prec, []).append(
                (samples[len(samples) // 2], fast[len(fast) // 2]))
        out["epoch_ms"][lt] = {
            prec: {"per_epoch_loop_ms": [r[0] for r in rs],
                   "fast_loop_ms": [r[1] for r in rs]}
            for prec, rs in runs.items()}
        print(f"phase 13: Cora {lt} epoch, host clock (medians, in turns "
              "high, fastest, fastest, high): "
              + "; ".join(f"{prec}: per-epoch loop "
                          f"{[round(r[0], 4) for r in rs]} ms, fast loop "
                          f"{[round(r[1], 4) for r in rs]} ms"
                          for prec, rs in runs.items()), flush=True)
    # the 524k epoch in both modes over both orders, the kernels' inputs
    # freed first
    for cases in kernel_cases.values():
        for case in cases:
            case.pop("args", None)
            case.pop("data", None)
            case.pop("walk", None)
    torch.cuda.empty_cache()
    out["large_epoch_ms"] = _fastest_large_epochs(large, plans)
    return out


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

    kernel_cases = {name: [] for name in build.WRAPPERS}
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
    # the same ops under "fastest" (one bf16 limb), the counters set to 0
    # just before and read just after
    for fn in counters.values():
        fn.launches = 0
    fastest_route_errors = _spmm_fastest_path(spmm_specs, spmm_inputs,
                                              counters)
    path_launches["spmm fastest"] = {name: fn.launches
                                     for name, fn in counters.items()}
    path_replayed["spmm fastest"] = dict.fromkeys(counters, 0)
    print(f"phase 6: SpMM path under 'fastest': wrapper launches "
          f"{ {k: v for k, v in path_launches['spmm fastest'].items() if v} }",
          flush=True)
    spmm_specs["hub"] = _hub_spec()
    spmm_inputs["hub"] = _spmm_inputs(spmm_specs["hub"]["graph"], 19)
    spmm_inputs["hub"]["vals_b"], _ = _banded_values(
        spmm_specs["hub"]["band"], spmm_inputs["hub"]["w"])
    spmm_cases = _spmm_kernel_cases(spmm_specs, spmm_inputs)
    for case in spmm_cases:
        _time_spmm(case)
        kernel_cases[case["kernel"]].append(case)
    for case in _spmm_fastest_kernel_cases(spmm_specs, spmm_inputs):
        _time_spmm_fastest(case)
        kernel_cases[case["kernel"]].append(case)
    spmm_peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"phase 6: SpMM phase peak allocated {spmm_peak_gib:.2f} GiB",
          flush=True)
    del spmm_specs, spmm_inputs
    torch.cuda.empty_cache()
    spmm_s = time.perf_counter() - t0
    print(f"phase 6: SpMM phase {spmm_s:.1f} s (budget {SPMM_BUDGET_S:.0f} "
          "s)", flush=True)
    if spmm_s > SPMM_BUDGET_S:
        raise AssertionError("the SpMM phase took longer than its budget")
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
    ppi_epoch_s, ppi_setup, ppi, ppi_batch = _ppi_phase(
        gen, fused, kernel_cases, counters, jsonl, path_launches,
        path_replayed)
    ppi_s = time.perf_counter() - t0
    print(f"phase 8: PPI phase {ppi_s:.1f} s (budget {PPI_BUDGET_S:.0f} s)",
          flush=True)
    if ppi_s > PPI_BUDGET_S:
        raise AssertionError("the PPI phase took longer than its budget")
    phase_done(8, t0)

    # -- phase 9: the dense layers and the unfused branches ---------------------
    t0 = time.perf_counter()
    dense = _dense_phase(datasets, ppi, ppi_batch, gen, kernel_cases,
                         counters, jsonl, path_launches, path_replayed)
    del ppi_batch
    dense_s = time.perf_counter() - t0
    print(f"phase 9: dense and unfused phase {dense_s:.1f} s (budget "
          f"{DENSE_BUDGET_S:.0f} s)", flush=True)
    if dense_s > DENSE_BUDGET_S:
        raise AssertionError("the dense phase took longer than its budget")
    phase_done(9, t0)

    # -- phase 10: the ring --------------------------------------------------
    # the per-hop kernels at the 4-shard block shapes of Cora, Pubmed and
    # the 524k graph on this card, the CLIs at world size 1 (an NCCL group
    # of one) with the counters set to 0 just before each run and read just
    # after, the ring model card vs CPU, the timings
    t0 = time.perf_counter()
    ring = _ring_phase(datasets, large, gen, kernel_cases, counters, jsonl,
                       path_launches, path_replayed)
    ring_s = time.perf_counter() - t0
    print(f"phase 10: ring phase {ring_s:.1f} s (budget "
          f"{RING_BUDGET_S:.0f} s)", flush=True)
    if ring_s > RING_BUDGET_S:
        raise AssertionError("the ring phase took longer than its budget")
    phase_done(10, t0)

    # -- phase 11: the RCM order and the stacked PPI loop ---------------------
    # the graph library, Cora and Pubmed in RCM order: rows 1-3 there
    # against their plain versions, both Cora models card vs CPU, the CLI
    # with --reorder and fit_inductive_fast on PPI with the counters set to
    # 0 just before each run and read just after, then the timings
    t0 = time.perf_counter()
    reorder = _reorder_phase(datasets, ppi, gen, fused, kernel_cases,
                             counters, jsonl, path_launches, path_replayed)
    reorder_s = time.perf_counter() - t0
    print(f"phase 11: RCM and stacked-loop phase {reorder_s:.1f} s (budget "
          f"{REORDER_BUDGET_S:.0f} s)", flush=True)
    if reorder_s > REORDER_BUDGET_S:
        raise AssertionError("the RCM phase took longer than its budget")
    phase_done(11, t0)

    # -- phase 12: the model axis on one card -----------------------------------
    # rows 1-3 at every H/M width against their plain versions, the
    # per-rank pieces against one device with the counters set to 0 just
    # before and read just after, the dense rows, the timings
    t0 = time.perf_counter()
    model_axis = _model_axis_phase(datasets, ppi, gen, fused, kernel_cases,
                                   counters, path_launches, path_replayed)
    model_axis_s = time.perf_counter() - t0
    print(f"phase 12: model-axis phase {model_axis_s:.1f} s (budget "
          f"{MODEL_AXIS_BUDGET_S:.0f} s)", flush=True)
    if model_axis_s > MODEL_AXIS_BUDGET_S:
        raise AssertionError("the model-axis phase took longer than its "
                             "budget")
    phase_done(12, t0)

    # -- phase 13: the fastest precision mode ---------------------------------
    # the one-limb kernels at the main path's shapes (the receiver stream,
    # the band plans, the corner windows) against their plain versions and
    # timed, the CLIs and the 524k trainers under "fastest" with the
    # counters set to 0 just before each run and read just after, the steps
    # against "high" and card vs CPU in every order, the Cora and 524k
    # epochs (the SpMM ops under "fastest" are phase 6's)
    t0 = time.perf_counter()
    fastest = _fastest_phase(
        datasets, large, ppi, gen,
        {"large": large_plan, "cora, band plan": cora_plan,
         "hub": plans["hub"], "cora, corner plans": cora_corner,
         "large, corner plans": large_corner}, kernel_cases,
        counters, jsonl, path_launches, path_replayed)
    fastest_s = time.perf_counter() - t0
    print(f"phase 13: fastest-mode phase {fastest_s:.1f} s (budget "
          f"{FASTEST_BUDGET_S:.0f} s)", flush=True)
    if fastest_s > FASTEST_BUDGET_S:
        raise AssertionError("the fastest-mode phase took longer than its "
                             "budget")
    phase_done(13, t0)

    # -- phase 14: the kernels line -------------------------------------------
    launches = {name: sum(v[name] for v in path_launches.values())
                for name in counters}
    replayed = {name: sum(v[name] for v in path_replayed.values())
                for name in counters}
    entries = []
    for name, cases in kernel_cases.items():
        # the summary numbers sum the shapes one train step gives the kernel
        # on its path's graph: Cora for the stream kernels (stream_scatter:
        # the 4 backward launches of each model's step, not the unfused
        # branches' widths of phase 9; the fused kernels: one forward's 2
        # launches), the large graph for the banded ones
        # (each of the 4 backward kernels: one launch per layer of each
        # model's step; the fused kernels: one forward's 2 launches), and the
        # large graph for the corner ones (corner_permute: every pass of
        # both plans at each of the 4 widths the two models turn, once; the
        # window forwards: one forward's 2 launches), and the large graph
        # for the SpMM ones (one forward at L = 128: spmm_banded over the
        # band plan, panel_spmm over the uncapped layout), and the large
        # graph for bcsr_attention (one forward at H = 8, F = 8, no
        # dropout mask); a one-limb kernel's as its f32 twin's (the
        # banded and window ones at 524k, phase 13); every shape is
        # listed under "cases". "launches" sums the wrapper's count over the
        # main-path runs of phases 4, 6 to 13 (one by one under
        # "launches_by_path"); "replayed_launches" are those of the fast
        # loop's CUDA graph replays, replays x launches captured.
        main_set = "cora" if name.replace("_bf16", "") in (
            "stream_scatter", "fused_v1", "fused_v2", "fused_v1_parts",
            "fused_v2_parts") else "large"
        main_cases = [c for c in cases if c["dataset"] == main_set
                      and not c.get("dropout")
                      and c.get("path") not in ("unfused", "ring")]
        if "_parts" in name:  # one rotation hop, timed
            main_cases = [c for c in main_cases
                          if c.get("path") == "rotation hop"]
        lib = [c["library_ms"] for c in main_cases]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"pygat_tpu_torch/csrc/{build.WRAPPERS[name].source}.cu",
            "replaces": REPLACES[name],
            "precision": "fastest" if name.endswith("_bf16") else "high",
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
                                         "bitwise_repeat", "hops", "n_buf",
                                         "live", "senders_read",
                                         "receivers_read", "single_device_ms",
                                         "precision", "kernel_ms", "f32_ms",
                                         "cast_ms", "library_f32_ms",
                                         "library_bf16_ms")
                       if k in c}
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
                               "fastest_route_max_abs_err":
                                   fastest_route_errors,
                               "seconds": spmm_s,
                               "peak_allocated_gib": spmm_peak_gib},
                      "bcsr": {"route_max_abs_err": bcsr_errors},
                      "ppi": {"epoch_s": ppi_epoch_s, "setup_s": ppi_setup},
                      "dense": dense,
                      "ring": ring,
                      "reorder": reorder,
                      "model_axis": model_axis,
                      "fastest": fastest,
                      "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
