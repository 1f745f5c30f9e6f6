"""Banded edge order for graphs past 300k nodes (port of
``pygat_tpu/ops/banded.py``).

The band plan re-sorts each 128-row receiver tile's edges by sender and
cuts them into 256-slot chunks whose senders all lie in a window of ``w``
128-row tiles starting at ``band[c]``: slot ``k`` of chunk ``c`` has the
sender ``band[c] * 128 + s_loc[k]`` and the receiver ``r_chunk[c] * 128 +
r_local[k]``, and ``s_loc == w * 128`` (with ``r_local == 128``) marks a
dead slot. The JAX package built it so that its TPU kernels could fetch
each chunk's sender rows as ``w`` VMEM tiles; on the GPU it keeps each
chunk's sender rows within ``w * 128`` rows of the node table, which stays
in L2 where the whole table (134 MB at 524k nodes and 64 columns) does not.

Three parts:

* the host half, in numpy and identical to the reference's:
  :class:`BandPlan`, :func:`build_band_plan`, and the selection
  :func:`set_band` / :func:`maybe_plan_band` / :func:`maybe_plan_large`,
  which read the JAX package's knobs ``PYGAT_BAND`` (auto/on/off),
  ``PYGAT_BAND_N``, ``PYGAT_BAND_W`` and ``PYGAT_BAND_MIN_FILL`` at import;
* the kernels, each a wrapper that on a CUDA tensor launches its
  hand-written kernel and on a CPU tensor runs its plain PyTorch version
  (the kernel's oracle): :func:`banded_take` (``csrc/banded_take.cu``,
  replaces ``_make_banded_kernel``), :func:`banded_sender_sum`
  (``csrc/banded_sender_sum.cu`` on the tile-owner body
  ``csrc/tile_sum.cuh``, replaces ``_make_sender_sum_kernel``),
  :func:`fused_v1_banded`, :func:`fused_v2_banded`
  (``csrc/fused_v1_banded.cu``, ``csrc/fused_v2_banded.cu`` on the
  tile-owner body ``csrc/tile_fused.cuh``, replace
  ``_make_v1_banded_kernel`` and ``_make_v2_banded_kernel``),
  and :func:`banded_weighted_sum` (``csrc/spmm_banded.cu``, replaces
  ``_make_spmm_banded_kernel``, on the tile-owner body
  ``csrc/tile_spmm.cuh``);
* the differentiable ops :func:`fused_v1_attention_banded`,
  :func:`fused_v2_attention_banded` and :func:`spmm_banded`, whose backward
  is the math of the reference's custom VJPs: :func:`banded_take`
  recomputes the sender rows, :func:`~pygat_tpu_torch.ops.large.expand`
  reads the receiver-side operands,
  :func:`~pygat_tpu_torch.ops.stream.stream_scatter` sums per receiver and
  :func:`banded_sender_sum` per sender.

The kernels and the three ops take the reference's ``precision``.
Under ``'fastest'`` (one bf16 limb) the fused forwards round as the
receiver stream's do (:mod:`~pygat_tpu_torch.ops.fused_stream`), and the
wrappers launch the one-limb kernels: ``csrc/banded_take_bf16.cu`` on the
f32 table (the rows it moves rounded in registers, as bf16), and the
others on bf16 copies they make once a call:
``csrc/banded_sender_sum_bf16.cu`` (the data rounded, summed in f32),
``csrc/fused_v1_banded_bf16.cu``, ``csrc/fused_v2_banded_bf16.cu`` and
``csrc/spmm_banded_bf16.cu`` (each message ``bf16(v) * bf16(x)`` rounded
to bf16, summed in f32), counted by :func:`banded_take_bf16`,
:func:`banded_sender_sum_bf16`, :func:`fused_v1_banded_bf16`,
:func:`fused_v2_banded_bf16` and :func:`banded_weighted_sum_bf16`. The
attention and SpMM backwards then recompute their sender rows rounded to
bf16 (the reference's ``exact=False`` take; the receiver stream's and the
corner path's backwards take them unrounded) and run their sums in one
limb. :func:`spmm_banded` defaults to ``'fastest'``, as the reference's.

The plan's fields that the kernels and plain versions read (``band``,
``s_loc``, ``r_local``, ``r_chunk``, and the port's own ``tile_ptr`` and
``split_at``: each tile's chunk range and the cuts of a hub's tile) are
tensors on the graph's device; the others stay numpy arrays on the host.
The walk of each tile's slots, receivers ascending, that the SpMM kernel,
the fused forward kernels and the receiver-side segment sum read
(:attr:`BandPlan.spmm_walk`), is built on the plan's device at the first
kernel call that reads it and kept on the plan; that call must not be
inside a CUDA-graph capture. The sender-side sum reads
:attr:`BandPlan.sender_walk`, a stream of the live slots by sender, built
on the host with the plan. The reference's band-sorted schedule ``bs_*``
exists for the TPU's VMEM accumulators and is kept for parity only. The
plan's
``edge_weight`` is a host array: a caller that weighs the SpMM by it moves
it to the device.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import sys
from typing import NamedTuple

import numpy as np
import torch

from pygat_tpu_torch.ops import build
from pygat_tpu_torch.ops.fused_stream import (
    _block_diag_a,
    _check_args as _check_fused_args,
    _expand_bd,
    fused_v1_plain,
    fused_v2_plain,
    launch_tile_fused,
    leaky_relu,
)
from pygat_tpu_torch.ops.large import CscCsrPlans, expand, maybe_plan_corner
from pygat_tpu_torch.ops.stream import (
    DEAD,
    EC,
    TILE,
    StreamWalk,
    build_stream_layout,
    build_stream_walk,
    check_precision,
    launch_tile_sum,
    stream_scatter,
    stream_scatter_plain,
    stream_walk_arg,
    tile_ranges,
    weighted_messages,
)

# the fields of a BandPlan that live on the device
_DEVICE_FIELDS = ("band", "s_loc", "r_local", "r_chunk", "tile_ptr",
                  "split_at")


class SpmmWalk(NamedTuple):
    """The walk of each tile's slots, receivers ascending (stable), that
    the banded SpMM and fused forward kernels read in order: a receiver's
    slots are one run of positions."""

    order: torch.Tensor  # [E_b] int32 the slot at each position
    rows: torch.Tensor  # [E_b] int32 its sender row (-1 dead)
    local: torch.Tensor  # [E_b] int32 its local row (DEAD dead)
    # [n_tiles * (TILE + 1) + 1] int32: the first position of each key
    # t * (TILE + 1) + l, so row l of tile t runs over positions
    # row_ptr[key] .. row_ptr[key + 1] - 1; key t * (TILE + 1) + TILE
    # starts the tile's dead slots
    row_ptr: torch.Tensor


@dataclasses.dataclass(frozen=True)
class BandPlan:
    """Banded edge order and per-chunk window bases (host-built, static).

    The banded order is receiver-tile-major, sender-sorted within each
    tile; every chunk writes one 128-row output tile (``r_chunk``) and
    reads sender rows only from tiles ``band[c] .. band[c] + w - 1``.
    """

    w: int  # window width in 128-row tiles
    band: torch.Tensor  # [C] int32 window base tile per chunk
    s_loc: torch.Tensor  # [E_b] int32 sender row within window (w*128 dead)
    r_local: torch.Tensor  # [E_b] int32 receiver row within tile (DEAD dead)
    r_chunk: torch.Tensor  # [C] int32 output tile per chunk (non-decreasing)
    senders: np.ndarray  # [E_b] int32 (dummy N_pad - 1 on dead slots)
    receivers: np.ndarray  # [E_b] int32 (tile-local dummy row on dead slots)
    edge_weight: np.ndarray  # [E_b] f32 (0 on dead slots)
    # CSC stream over the banded order (c_slot maps a stream position to a
    # banded slot): the reference's fallback sender reduction
    c_slot: np.ndarray  # [E_s2] int32
    c_local: np.ndarray  # [E_s2] int32
    c_chunk: np.ndarray  # [E_s2 / EC] int32
    # band-sorted chunk schedule of the reference's sender-sum kernel
    bs_band: np.ndarray  # [C2] int32, non-decreasing window base
    bs_chunk: np.ndarray  # [C2] int32 source banded chunk (0 on dead)
    bs_sloc: np.ndarray  # [C2/8, 8, EC] int32 s_loc in bs order (dead w*128)
    fill: float  # real edges / (C * EC): chunk-packing efficiency
    perm: np.ndarray  # [E_b] int64 original edge index (-1 dead)
    n_pad: int  # node rows of the graph the plan was built for
    # the port's own, for the tile-owner kernels: tile_ranges of r_chunk
    # and r_local (tile t owns chunks [tile_ptr[t], tile_ptr[t + 1])), and
    # the most live slots of one receiver (its in-degree), past which the
    # fused forwards cut a receiver's run into segments
    tile_ptr: torch.Tensor  # [n_tiles + 1] int32
    split_at: torch.Tensor  # [n_split] int32 chunks where pieces start
    max_run: int
    # the sender-side segment sum's walk: a stream of the live slots only,
    # sorted by sender (its order: the banded slot at each position), on
    # the device; the dead slots, which c_slot / c_local count as the dummy
    # sender's, are in no run
    sender_walk: StreamWalk | None

    @property
    def num_slots(self) -> int:
        return self.s_loc.shape[0]

    @property
    def num_chunks(self) -> int:
        return self.band.shape[0]

    @functools.cached_property
    def spmm_walk(self) -> SpmmWalk:
        """The kernels' walk, built on the plan's device at first use (a
        stable sort of the slots by tile and local row) and kept."""
        tile = self.r_chunk.long().repeat_interleave(EC)
        key, order = torch.sort(tile * (TILE + 1) + self.r_local.long(),
                                stable=True)
        n_keys = self.n_pad // TILE * (TILE + 1)
        row_ptr = torch.searchsorted(
            key, torch.arange(n_keys + 1, device=key.device))
        return SpmmWalk(order=order.int(),
                        rows=banded_senders(self, -1)[order].int(),
                        local=self.r_local[order], row_ptr=row_ptr.int())

    def to(self, device) -> "BandPlan":
        """The same plan with its device fields and sender walk on
        ``device`` (its SpMM walk is built anew there at first use)."""
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in _DEVICE_FIELDS},
            sender_walk=(None if self.sender_walk is None
                         else self.sender_walk.to(device)))


def _host_edges(graph):
    """(senders, receivers, edge_weight, edge_mask) of ``graph`` as numpy:
    the host copy kept by ``build_graph``, else one batched device read."""
    from pygat_tpu_torch.graph import host_edges

    host = host_edges(graph)
    if host is not None:
        return host
    packed = torch.stack([graph.senders, graph.receivers,
                          graph.edge_weight.view(torch.int32),
                          graph.edge_mask.to(torch.int32)]).cpu().numpy()
    return packed[0], packed[1], packed[2].view(np.float32), packed[3] != 0


def _cut_chunks(s, rt, tile_lo, tile_hi, n_pad, w):
    """The reference's greedy chunk cuts, all tiles at once: from its first
    uncut edge ``i``, a tile's next chunk takes the window base
    ``min(s[i] >> 7, n_tiles - w)`` and runs to the first edge whose sender
    leaves the window, or EC edges. Returns (tile, base, lo, hi) per chunk
    in (tile, cut) order; an empty tile gets one empty chunk."""
    n_tiles = n_pad // TILE
    base_cap = n_tiles - w
    key = rt * (n_pad + 1) + s  # non-decreasing: edges sort by (tile, s)
    tiles = np.arange(n_tiles, dtype=np.int64)
    empty = tile_lo == tile_hi
    parts = [(tiles[empty], np.zeros(int(empty.sum()), np.int64),
              np.minimum(tiles[empty], base_cap), tile_lo[empty],
              tile_lo[empty])]
    t_act, cur, hi = tiles[~empty], tile_lo[~empty], tile_hi[~empty]
    cut = 0
    while t_act.size:
        base = np.minimum(s[cur] >> 7, base_cap)
        limit = (base + w) * TILE
        nxt = np.minimum(cur + EC,
                         np.searchsorted(key, t_act * (n_pad + 1) + limit))
        parts.append((t_act, np.full(t_act.size, cut, np.int64), base, cur,
                      nxt))
        more = nxt < hi
        t_act, cur, hi = t_act[more], nxt[more], hi[more]
        cut += 1
    tile, cut_no, base, lo, hi = (np.concatenate(c) for c in zip(*parts))
    order = np.lexsort((cut_no, tile))
    return tile[order], base[order], lo[order], hi[order]


def build_band_plan(graph, w: int = 4) -> BandPlan:
    """Host-side plan: re-sort each receiver tile's edges by sender and cut
    window-bounded chunks. ``w`` is the window in 128-row tiles (clipped to
    the table). The device fields go to the graph's device."""
    senders, receivers, weights, mask = _host_edges(graph)
    senders = np.asarray(senders, dtype=np.int64)
    receivers = np.asarray(receivers, dtype=np.int64)
    weights = np.asarray(weights, dtype=np.float32)
    mask = np.asarray(mask)
    n_pad = graph.num_nodes_padded
    if n_pad % TILE:
        raise ValueError(f"n_pad={n_pad} must be 128-aligned")
    n_tiles = n_pad // TILE
    w = min(int(w), n_tiles)
    if w < 1:
        raise ValueError("window must be >= 1 tile")

    eidx = np.nonzero(mask)[0]
    s, r = senders[eidx], receivers[eidx]
    rt = r // TILE
    order = np.lexsort((r, s, rt))
    s, r, rt, eidx = s[order], r[order], rt[order], eidx[order]
    tile_lo = np.searchsorted(rt, np.arange(n_tiles))
    tile_hi = np.searchsorted(rt, np.arange(n_tiles), side="right")
    tile_a, base_a, lo_a, hi_a = _cut_chunks(s, rt, tile_lo, tile_hi, n_pad,
                                             w)

    # pad the chunk count to a multiple of 8 with trailing all-dead chunks
    # on the last tile (keeps r_chunk sorted)
    base_cap = n_tiles - w
    c_real = tile_a.shape[0]
    c = -(-c_real // 8) * 8
    pad = c - c_real
    tile_a = np.concatenate([tile_a, np.full(pad, n_tiles - 1, np.int64)])
    base_a = np.concatenate([base_a, np.full(pad, base_cap, np.int64)])
    lo_a = np.concatenate([lo_a, np.full(pad, len(eidx), np.int64)])
    hi_a = np.concatenate([hi_a, np.full(pad, len(eidx), np.int64)])
    lens = hi_a - lo_a
    e_b = c * EC

    # scatter the sorted real edges into their banded slots
    pos_in_chunk = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(
        np.concatenate([[0], np.cumsum(lens)[:-1]]), lens)
    slot_pos = np.repeat(np.arange(c, dtype=np.int64) * EC, lens) + pos_in_chunk

    dummy = n_pad - 1
    s_loc = np.full(e_b, w * TILE, np.int32)
    r_local = np.full(e_b, DEAD, np.int32)
    senders_b = np.full(e_b, dummy, np.int32)
    receivers_b = (np.repeat(tile_a, EC) * TILE + TILE - 1).astype(np.int32)
    weight_b = np.zeros(e_b, np.float32)
    perm = np.full(e_b, -1, np.int64)

    s_loc[slot_pos] = (s - np.repeat(base_a, lens) * TILE).astype(np.int32)
    r_local[slot_pos] = (r - np.repeat(tile_a, lens) * TILE).astype(np.int32)
    senders_b[slot_pos] = s.astype(np.int32)
    receivers_b[slot_pos] = r.astype(np.int32)
    weight_b[slot_pos] = weights[eidx]
    perm[slot_pos] = eidx
    if not ((s_loc[slot_pos] >= 0).all() and (s_loc[slot_pos] < w * TILE).all()):
        raise AssertionError("a sender fell outside its chunk's window")

    # CSC stream over the banded order
    ptr = np.zeros(n_pad + 1, np.int64)
    np.cumsum(np.bincount(senders_b, minlength=n_pad), out=ptr[1:])
    c_lay = build_stream_layout(ptr, order=np.lexsort((receivers_b, senders_b)))

    # band-sorted chunk schedule: a dead filler chunk for every uncovered
    # base, sorted stably by base, padded to a multiple of 8
    covered = np.zeros(base_cap + 1, bool)
    covered[base_a] = True
    missing = np.nonzero(~covered)[0]
    ent_band = np.concatenate([base_a, missing])
    ent_chunk = np.concatenate(
        [np.arange(c, dtype=np.int64), np.zeros(len(missing), np.int64)])
    ent_dead = np.concatenate([np.zeros(c, bool), np.ones(len(missing), bool)])
    o2 = np.argsort(ent_band, kind="stable")
    ent_band, ent_chunk, ent_dead = ent_band[o2], ent_chunk[o2], ent_dead[o2]
    pad2 = (-len(ent_band)) % 8
    ent_band = np.concatenate([ent_band, np.full(pad2, base_cap, np.int64)])
    ent_chunk = np.concatenate([ent_chunk, np.zeros(pad2, np.int64)])
    ent_dead = np.concatenate([ent_dead, np.ones(pad2, bool)])
    c2 = len(ent_band)
    sloc2 = s_loc.reshape(c, EC)[ent_chunk].copy()
    sloc2[ent_dead] = w * TILE

    tile_ptr, split_at = tile_ranges(tile_a, r_local, n_tiles)
    device = graph.senders.device

    # the sender walk: the live slots laid out as a stream by sender
    # (stably, so banded order within a sender's run)
    by_sender = slot_pos[np.argsort(s, kind="stable")]
    live_ptr = np.zeros(n_pad + 1, np.int64)
    np.cumsum(np.bincount(s, minlength=n_pad), out=live_ptr[1:])
    s_lay = build_stream_layout(live_ptr, order=by_sender)
    sender_walk = build_stream_walk(s_lay.local, s_lay.chunk_tile, n_tiles,
                                    device, order=np.maximum(s_lay.slot, 0))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return BandPlan(
        w=w,
        band=dev(base_a),
        s_loc=dev(s_loc),
        r_local=dev(r_local),
        r_chunk=dev(tile_a),
        senders=senders_b,
        receivers=receivers_b,
        edge_weight=weight_b,
        c_slot=np.maximum(c_lay.slot, 0).astype(np.int32),
        c_local=c_lay.local,
        c_chunk=c_lay.chunk_tile,
        bs_band=ent_band.astype(np.int32),
        bs_chunk=ent_chunk.astype(np.int32),
        bs_sloc=sloc2.reshape(c2 // 8, 8, EC),
        fill=float(len(eidx)) / float(e_b),
        perm=perm,
        n_pad=n_pad,
        tile_ptr=dev(tile_ptr),
        split_at=dev(split_at),
        max_run=int(np.bincount(r, minlength=1).max()),
        sender_walk=sender_walk,
    )


# ---------------------------------------------------------------------------
# Selection (the reference's knobs, read at import)
# ---------------------------------------------------------------------------

_BAND_MODE = os.environ.get("PYGAT_BAND", "auto")
# the reference's node count past which 'auto' plans (its measured TPU
# crossover; the port keeps the same switch so both packages take the same
# path on the same graph)
_BAND_N = int(os.environ.get("PYGAT_BAND_N", str(300_000)))
_BAND_W = int(os.environ.get("PYGAT_BAND_W", "4"))
# below this fill 'auto' keeps the stream path (poor locality)
_BAND_MIN_FILL = float(os.environ.get("PYGAT_BAND_MIN_FILL", "0.2"))


def set_band(mode: str, *, n: int | None = None, w: int | None = None) -> None:
    """'auto' (a plan for stream graphs of at least PYGAT_BAND_N padded
    nodes with adequate locality), 'on', 'off'; ``n`` and ``w`` set the
    threshold and the window."""
    global _BAND_MODE, _BAND_N, _BAND_W
    if mode not in ("auto", "on", "off"):
        raise ValueError(f"unknown band mode {mode!r}")
    _BAND_MODE = mode
    if n is not None:
        _BAND_N = int(n)
    if w is not None:
        _BAND_W = int(w)


def maybe_plan_band(graph) -> BandPlan | None:
    """A BandPlan when the fused layers should run over the banded order;
    None keeps the receiver stream."""
    if graph.r_local is None or _BAND_MODE == "off":
        return None
    if _BAND_MODE == "auto" and graph.num_nodes_padded < _BAND_N:
        return None
    plan = build_band_plan(graph, w=_BAND_W)
    if _BAND_MODE == "auto" and plan.fill < _BAND_MIN_FILL:
        print(f"[pygat_tpu_torch.banded] fill {plan.fill:.2f} < "
              f"{_BAND_MIN_FILL} (poor locality); keeping the stream path",
              file=sys.stderr)
        return None
    return plan


def maybe_plan_large(graph) -> BandPlan | CscCsrPlans | None:
    """The large-N plan for the fused layers, as the reference picks it:
    the band plan (auto past PYGAT_BAND_N), else the corner plans (opt-in:
    ``PYGAT_CORNER=on`` / ``set_corner("on")``, or N_pad at or above
    ``PYGAT_CORNER_N``), else None (the receiver stream)."""
    plan = maybe_plan_band(graph)
    if plan is not None:
        return plan
    return maybe_plan_corner(graph)


# ---------------------------------------------------------------------------
# Kernels and their plain versions
# ---------------------------------------------------------------------------


def banded_senders(plan: BandPlan, dead_row: int) -> torch.Tensor:
    """[E_b] int64 sender row of every slot, ``band[k // EC] * 128 +
    s_loc[k]``, and ``dead_row`` at dead slots (tested before the row is
    formed: a dead slot on the last band would name row N_pad)."""
    live = plan.s_loc < plan.w * TILE
    rows = plan.band.long().repeat_interleave(EC) * TILE + plan.s_loc.long()
    return torch.where(live, rows, dead_row)


def _check_table(what: str, table: torch.Tensor, plan: BandPlan) -> None:
    if (table.dim() != 2 or table.dtype != torch.float32
            or table.shape[0] != plan.n_pad):
        raise ValueError(f"{what}: the table must be [{plan.n_pad}, L] "
                         f"float32, got {table.dtype} {tuple(table.shape)}")


def banded_take_plain(table: torch.Tensor, plan: BandPlan, *,
                      precision: str = "high") -> torch.Tensor:
    """Plain PyTorch version of :func:`banded_take` (a row gather; under
    ``precision='fastest'`` of the table rounded to bf16, in bf16)."""
    check_precision("banded_take", precision)
    _check_table("banded_take", table, plan)
    if precision == "fastest":
        table = table.to(torch.bfloat16)
    live = (plan.s_loc < plan.w * TILE)[:, None]
    return torch.where(live, table[banded_senders(plan, 0)], 0.0)


@build.counted
def banded_take(table: torch.Tensor, plan: BandPlan, *,
                precision: str = "high") -> torch.Tensor:
    """``table`` [N_pad, L] f32 rows at every slot's sender in banded order,
    [E_b, L], zeros at dead slots, bit-exact; under
    ``precision='fastest'`` (the reference's ``exact=False``) the rows of
    the table rounded to bf16 (to nearest, ties to even), as bf16. On a
    CUDA tensor this launches ``csrc/banded_take.cu`` (counted in
    ``banded_take.launches``), or under ``'fastest'``
    ``csrc/banded_take_bf16.cu``, which reads the f32 table and rounds the
    rows it moves (counted in ``banded_take_bf16.launches``); on a CPU
    tensor it runs :func:`banded_take_plain`. Not differentiable."""
    check_precision("banded_take", precision)
    if table.device.type == "cpu":
        return banded_take_plain(table, plan, precision=precision)
    if table.device.type != "cuda":
        raise ValueError(f"banded_take: unsupported device {table.device}")
    _check_table("banded_take", table, plan)
    one = precision == "fastest"
    out = torch.empty(plan.num_slots, table.shape[1],
                      dtype=torch.bfloat16 if one else torch.float32,
                      device=table.device)
    wrapper = banded_take_bf16 if one else banded_take
    build.launch(wrapper, table, plan.band, plan.s_loc, plan.num_chunks,
                 plan.w, table.shape[1], out)
    return out


@build.counted
def banded_take_bf16(table: torch.Tensor, plan: BandPlan) -> torch.Tensor:
    """:func:`banded_take` under ``precision='fastest'``, whose launches of
    the one-limb kernel ``csrc/banded_take_bf16.cu`` (the TPU kernel's
    ``exact=False`` instantiation) this wrapper counts."""
    return banded_take(table, plan, precision="fastest")


def _check_data(what: str, data: torch.Tensor, plan: BandPlan) -> None:
    if (data.dim() != 2 or data.dtype != torch.float32
            or data.shape[0] != plan.num_slots):
        raise ValueError(f"{what}: data must be [{plan.num_slots}, L] "
                         f"float32 in banded order, got {data.dtype} "
                         f"{tuple(data.shape)}")


def banded_sender_sum_plain(data: torch.Tensor, plan: BandPlan, *,
                            f64: bool = False,
                            precision: str = "high") -> torch.Tensor:
    """Plain PyTorch version of :func:`banded_sender_sum` (``index_add_``;
    dead slots add into a scratch row past the output). ``f64=True`` sums
    in float64 and returns float32 (the kernel's oracle, as
    :func:`~pygat_tpu_torch.ops.stream.stream_scatter_plain`'s). Under
    ``precision='fastest'`` the data are rounded to bf16 first, then summed
    in f32 (or f64)."""
    check_precision("banded_sender_sum", precision)
    _check_data("banded_sender_sum", data, plan)
    if precision == "fastest":
        data = data.to(torch.bfloat16)
    dtype = torch.float64 if f64 else torch.float32
    out = torch.zeros(plan.n_pad + 1, data.shape[1], dtype=dtype,
                      device=data.device)
    return out.index_add_(0, banded_senders(plan, plan.n_pad),
                          data.to(dtype))[:-1].float()


@build.counted
def banded_sender_sum(data: torch.Tensor, plan: BandPlan, *,
                      precision: str = "high") -> torch.Tensor:
    """Per-sender segment sum of banded-order ``data`` [E_b, L] f32 into
    [N_pad, L]: row n sums the live slots whose sender is n; under
    ``precision='fastest'`` the data rounded to bf16, summed in f32. On a
    CUDA tensor this launches ``csrc/banded_sender_sum.cu`` over the plan's
    sender walk (:attr:`BandPlan.sender_walk`; counted in
    ``banded_sender_sum.launches``), or under ``'fastest'``
    ``csrc/banded_sender_sum_bf16.cu`` on a bf16 copy of the data (counted
    in ``banded_sender_sum_bf16.launches``), whose result is the same bit
    for bit from call to call, and raises without the walk; on a CPU tensor
    it runs :func:`banded_sender_sum_plain`. Not differentiable."""
    check_precision("banded_sender_sum", precision)
    if data.device.type == "cpu":
        return banded_sender_sum_plain(data, plan, precision=precision)
    if data.device.type != "cuda":
        raise ValueError(f"banded_sender_sum: unsupported device {data.device}")
    _check_data("banded_sender_sum", data, plan)
    walk = stream_walk_arg("banded_sender_sum", plan.sender_walk, plan.n_pad,
                           plan.band)
    if precision == "fastest":
        return launch_tile_sum(banded_sender_sum_bf16,
                               data.to(torch.bfloat16), walk.order, walk,
                               plan.n_pad)
    return launch_tile_sum(banded_sender_sum, data, walk.order, walk,
                           plan.n_pad)


@build.counted
def banded_sender_sum_bf16(data: torch.Tensor, plan: BandPlan) -> torch.Tensor:
    """:func:`banded_sender_sum` under ``precision='fastest'``, whose
    launches of the one-limb kernel ``csrc/banded_sender_sum_bf16.cu`` (the
    TPU kernel's ``exact=False`` instantiation) this wrapper counts."""
    return banded_sender_sum(data, plan, precision="fastest")


def _check_values(what: str, values_b: torch.Tensor, plan: BandPlan) -> None:
    if (values_b.dtype != torch.float32
            or tuple(values_b.shape) != (plan.num_slots,)):
        raise ValueError(f"{what}: values must be [{plan.num_slots}] float32 "
                         f"in banded order, got {values_b.dtype} "
                         f"{tuple(values_b.shape)}")


def _walk(what: str, plan: BandPlan) -> SpmmWalk:
    """The plan's walk; raises inside a CUDA-graph capture when it is not
    built yet (building it syncs and allocates)."""
    if ("spmm_walk" not in plan.__dict__ and plan.band.is_cuda
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError(f"{what}: the plan's walk is built at its first "
                           "call, which must not be captured")
    return plan.spmm_walk


def _receiver_walk(what: str, plan: BandPlan) -> StreamWalk:
    """The plan's walk in receiver order as the tile-owner fused kernels
    and the stream segment sum read it: the SpMM walk's ``row_ptr`` and
    ``order`` with the plan's tile ranges and ``max_run`` (built at the
    first call, as :func:`_walk`)."""
    walk = _walk(what, plan)
    return StreamWalk(row_ptr=walk.row_ptr, tile_ptr=plan.tile_ptr,
                      split_at=plan.split_at, max_run=plan.max_run,
                      order=walk.order)


def _receiver_sum(data: torch.Tensor, plan: BandPlan,
                  precision: str = "high") -> torch.Tensor:
    """The receiver-side segment sum of banded-order ``data`` [E_b, L]
    (``stream_scatter`` at ``precision`` over the plan's receiver walk on
    CUDA)."""
    walk = (None if data.device.type == "cpu"
            else _receiver_walk("stream_scatter", plan))
    return stream_scatter(data, plan.r_local, plan.r_chunk, plan.n_pad,
                          walk=walk, precision=precision)


def banded_weighted_sum_plain(values_b: torch.Tensor, x: torch.Tensor,
                              plan: BandPlan, *, precision: str = "high",
                              f64: bool = False,
                              magnitude: bool = False) -> torch.Tensor:
    """Plain PyTorch version of :func:`banded_weighted_sum` (a row gather
    and ``index_add_``). Under ``precision='fastest'`` each message is the
    kernel's, ``bf16(v) * bf16(x)`` rounded to bf16
    (:func:`~pygat_tpu_torch.ops.stream.weighted_messages`); ``f64=True``
    sums the messages, still formed in f32, in float64 and returns float32
    (the kernel's oracle); ``magnitude=True`` sums their magnitudes (its
    allowance)."""
    check_precision("spmm_banded", precision)
    _check_table("spmm_banded", x, plan)
    _check_values("spmm_banded", values_b, plan)
    live = (plan.s_loc < plan.w * TILE) & (plan.r_local < TILE)
    msgs = weighted_messages(values_b, x[banded_senders(plan, 0)],
                             precision=precision, round_values=True,
                             magnitude=magnitude)
    return stream_scatter_plain(torch.where(live[:, None], msgs, 0.0),
                                plan.r_local, plan.r_chunk, plan.n_pad,
                                f64=f64)


@build.counted(kernel="spmm_banded")
def banded_weighted_sum(values_b: torch.Tensor, x: torch.Tensor,
                        plan: BandPlan, *,
                        precision: str = "high") -> torch.Tensor:
    """[N_pad, L] f32: per receiver, the sum of ``values_b[k] *
    x[sender(k)]`` over the live banded slots ``k`` (``values_b`` [E_b] f32
    in banded order, ``x`` [N_pad, L] f32); dead slots add nothing. Under
    ``precision='fastest'`` (the reference's ``exact=False``) each message
    is ``bf16(v) * bf16(x)`` rounded to bf16, and the messages are summed in
    f32. On a CUDA tensor this launches ``csrc/spmm_banded.cu`` (counted in
    ``banded_weighted_sum.launches``), or under ``'fastest'``
    ``csrc/spmm_banded_bf16.cu`` on a bf16 copy of ``x`` (counted in
    ``banded_weighted_sum_bf16.launches``), whose result is the same bit
    for bit from call to call; on a CPU tensor it runs
    :func:`banded_weighted_sum_plain`. The first CUDA call on a plan builds
    its walk (:attr:`BandPlan.spmm_walk`), so it must not be inside a
    CUDA-graph capture. Not differentiable."""
    check_precision("spmm_banded", precision)
    if x.device.type == "cpu":
        return banded_weighted_sum_plain(values_b, x, plan,
                                         precision=precision)
    if x.device.type != "cuda":
        raise ValueError(f"spmm_banded: unsupported device {x.device}")
    _check_table("spmm_banded", x, plan)
    _check_values("spmm_banded", values_b, plan)
    walk = _walk("spmm_banded", plan)
    wrapper = banded_weighted_sum
    if precision == "fastest":
        x, wrapper = x.to(torch.bfloat16), banded_weighted_sum_bf16
    width, n_split = x.shape[1], plan.split_at.shape[0]
    out = torch.empty(plan.n_pad, width, dtype=torch.float32, device=x.device)
    part = (torch.empty(n_split, TILE, width, dtype=torch.float32,
                        device=x.device) if n_split else None)
    build.launch(wrapper, values_b, x, walk.rows, walk.local,
                 walk.order, plan.tile_ptr,
                 plan.split_at, plan.n_pad // TILE, n_split, width, out, part)
    return out


@build.counted(kernel="spmm_banded_bf16")
def banded_weighted_sum_bf16(values_b: torch.Tensor, x: torch.Tensor,
                             plan: BandPlan) -> torch.Tensor:
    """:func:`banded_weighted_sum` under ``precision='fastest'``, whose
    launches of the one-limb kernel ``csrc/spmm_banded_bf16.cu`` (the TPU
    kernel's ``exact=False`` instantiation) this wrapper counts."""
    return banded_weighted_sum(values_b, x, plan, precision="fastest")


def fused_v1_banded_plain(wh, f_dst, bound, a_src, keepq, plan: BandPlan,
                          alpha: float, *, f64: bool = False,
                          precision: str = "high", magnitude: bool = False):
    """Plain PyTorch version of :func:`fused_v1_banded`: the receiver
    stream's plain version over the banded slots (``f64``, ``precision``
    and ``magnitude`` as there)."""
    _check_table("fused_v1_banded", wh, plan)
    return fused_v1_plain(wh, f_dst, bound, a_src, keepq,
                          banded_senders(plan, plan.n_pad - 1).int(),
                          plan.r_local, plan.r_chunk, alpha, f64=f64,
                          precision=precision, magnitude=magnitude)


def _launch_banded(wrapper, tensors, a, plan: BandPlan, alpha: float):
    """Launch ``wrapper``'s tile-owner kernel over the plan's walk on the
    current stream and count the launch; ``tensors`` are the node tables,
    the per-node head terms, ``a`` and ``keepq`` in the kernel's order.
    Returns the new (out [N, HF], den [N, H])."""
    walk = _walk(wrapper.kernel, plan)
    return launch_tile_fused(wrapper, (*tensors, walk.rows, walk.order), a,
                             plan.n_pad, _receiver_walk(wrapper.kernel, plan),
                             alpha)


@build.counted
def fused_v1_banded(wh, f_dst, bound, a_src, keepq, plan: BandPlan,
                    alpha: float, *, precision: str = "high"):
    """(out [N, HF], den [N, H]) of the fused GATv1 forward over the banded
    slots (``keepq`` [E_b, H]), at ``precision`` (``'fastest'``: the
    rounding points of :func:`~pygat_tpu_torch.ops.fused_stream.fused_v1`).
    On a CUDA tensor this launches ``csrc/fused_v1_banded.cu`` (counted in
    ``fused_v1_banded.launches``), or under ``'fastest'``
    ``csrc/fused_v1_banded_bf16.cu`` on a bf16 copy of ``wh`` (counted in
    ``fused_v1_banded_bf16.launches``), whose result is the same bit for
    bit from call to call; on a CPU tensor it runs
    :func:`fused_v1_banded_plain`. The first CUDA call on a plan builds its
    walk (:attr:`BandPlan.spmm_walk`), so it must not be inside a
    CUDA-graph capture."""
    check_precision("fused_v1_banded", precision)
    if wh.device.type == "cpu":
        return fused_v1_banded_plain(wh, f_dst, bound, a_src, keepq, plan,
                                     alpha, precision=precision)
    if wh.device.type != "cuda":
        raise ValueError(f"fused_v1_banded: unsupported device {wh.device}")
    _check_table("fused_v1_banded", wh, plan)
    _check_fused_args("fused_v1_banded", (wh,), (f_dst, bound), a_src, keepq,
                      plan.s_loc, plan.r_local, plan.r_chunk)
    if precision == "fastest":
        return _launch_banded(fused_v1_banded_bf16, (
            wh.to(torch.bfloat16), f_dst, bound, a_src, keepq), a_src, plan,
            alpha)
    return _launch_banded(fused_v1_banded, (wh, f_dst, bound, a_src, keepq),
                          a_src, plan, alpha)


@build.counted
def fused_v1_banded_bf16(wh, f_dst, bound, a_src, keepq, plan: BandPlan,
                         alpha: float):
    """:func:`fused_v1_banded` under ``precision='fastest'``, whose launches
    of the one-limb kernel ``csrc/fused_v1_banded_bf16.cu`` (the TPU
    kernel's ``two_limb=False`` instantiation) this wrapper counts."""
    return fused_v1_banded(wh, f_dst, bound, a_src, keepq, plan, alpha,
                           precision="fastest")


def fused_v2_banded_plain(whi, whj, ub, a, keepq, plan: BandPlan,
                          alpha: float, *, f64: bool = False,
                          precision: str = "high", magnitude: bool = False):
    """Plain PyTorch version of :func:`fused_v2_banded`: the receiver
    stream's plain version over the banded slots (``f64``, ``precision``
    and ``magnitude`` as there)."""
    _check_table("fused_v2_banded", whi, plan)
    return fused_v2_plain(whi, whj, ub, a, keepq,
                          banded_senders(plan, plan.n_pad - 1).int(),
                          plan.r_local, plan.r_chunk, alpha, f64=f64,
                          precision=precision, magnitude=magnitude)


@build.counted
def fused_v2_banded(whi, whj, ub, a, keepq, plan: BandPlan, alpha: float, *,
                    precision: str = "high"):
    """(out [N, HF], den [N, H]) of the fused GATv2 forward over the banded
    slots (``keepq`` [E_b, H]), at ``precision`` (``'fastest'``: the
    rounding points of :func:`~pygat_tpu_torch.ops.fused_stream.fused_v2`).
    On a CUDA tensor this launches ``csrc/fused_v2_banded.cu`` (counted in
    ``fused_v2_banded.launches``), or under ``'fastest'``
    ``csrc/fused_v2_banded_bf16.cu`` on bf16 copies of ``whj`` and ``whi``
    for the sender's rows (counted in ``fused_v2_banded_bf16.launches``),
    whose result is the same bit for bit from call to call; on a CPU tensor
    it runs :func:`fused_v2_banded_plain`. The first CUDA call on a plan
    builds its walk (:attr:`BandPlan.spmm_walk`), so it must not be inside
    a CUDA-graph capture."""
    check_precision("fused_v2_banded", precision)
    if whi.device.type == "cpu":
        return fused_v2_banded_plain(whi, whj, ub, a, keepq, plan, alpha,
                                     precision=precision)
    if whi.device.type != "cuda":
        raise ValueError(f"fused_v2_banded: unsupported device {whi.device}")
    _check_table("fused_v2_banded", whi, plan)
    _check_fused_args("fused_v2_banded", (whi, whj), (ub,), a, keepq,
                      plan.s_loc, plan.r_local, plan.r_chunk)
    if precision == "fastest":
        return _launch_banded(fused_v2_banded_bf16, (
            whi, whi.to(torch.bfloat16), whj.to(torch.bfloat16), ub, a,
            keepq), a, plan, alpha)
    return _launch_banded(fused_v2_banded, (whi, whj, ub, a, keepq), a, plan,
                          alpha)


@build.counted
def fused_v2_banded_bf16(whi, whj, ub, a, keepq, plan: BandPlan,
                         alpha: float):
    """:func:`fused_v2_banded` under ``precision='fastest'``, whose launches
    of the one-limb kernel ``csrc/fused_v2_banded_bf16.cu`` (the TPU
    kernel's ``two_limb=False`` instantiation) this wrapper counts."""
    return fused_v2_banded(whi, whj, ub, a, keepq, plan, alpha,
                           precision="fastest")


# ---------------------------------------------------------------------------
# Differentiable fused banded attention
# ---------------------------------------------------------------------------


class _FusedV1AttentionBanded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, wh, f_dst, bound, a_src, keepq, plan, alpha, precision):
        wh, f_dst, bound, a_src, keepq = (
            t.contiguous() for t in (wh, f_dst, bound, a_src, keepq))
        out, den = fused_v1_banded(wh, f_dst, bound, a_src, keepq, plan,
                                   alpha, precision=precision)
        ctx.save_for_backward(wh, f_dst, bound, a_src, keepq)
        ctx.plan, ctx.alpha, ctx.precision = plan, alpha, precision
        return out, den

    @staticmethod
    def backward(ctx, g_out, g_den):
        wh, f_dst, bound, a_src, keepq = ctx.saved_tensors
        plan, alpha, precision = ctx.plan, ctx.alpha, ctx.precision
        h, f = a_src.shape
        hf = h * f

        # recompute the per-slot pipeline in banded order, lane-minor:
        # sender rows by the banded take (rounded to bf16 under 'fastest',
        # as the reference's exact=False take), the four receiver-side
        # operands by one expand
        g_w = banded_take(wh, plan, precision=precision).float()  # [E_b, HF]
        abd = _block_diag_a(a_src)  # [HF, H]
        exp_bd = _expand_bd(h, f, device=wh.device)  # [H, HF]
        eall = expand(torch.cat([f_dst, bound, g_out, g_den], dim=1),
                      plan.r_local, plan.r_chunk)  # [E_b, 3H + HF]
        fde, bnd, dmsg, dden = eall.split([h, h, hf, h], dim=1)
        raw = fde + g_w @ abd
        live = (plan.r_local < TILE)[:, None]
        num = torch.where(live, torch.exp(leaky_relu(raw, alpha) - bnd), 0.0)
        qnum = num * keepq

        dqnum = (dmsg * g_w) @ exp_bd.T  # per-head sums over F
        draw = (dqnum * keepq + dden) * num * torch.where(raw >= 0, 1.0, alpha)
        df_dst = _receiver_sum(draw, plan, precision)
        dgathered = dmsg * (qnum @ exp_bd) + draw @ abd.T  # [E_b, HF]
        dwh = banded_sender_sum(dgathered, plan, precision=precision)
        da = (g_w * (draw @ exp_bd)).sum(0).reshape(h, f)
        return dwh, df_dst, None, da, None, None, None, None


def fused_v1_attention_banded(wh, f_dst, bound, a_src, keepq, plan: BandPlan,
                              alpha: float, precision: str = "high"):
    """Differentiable fused GATv1 attention over the banded order: (out
    [N, HF], den [N, H]). ``keepq`` is [plan.num_slots, H], drawn over the
    banded slots; ``bound`` must be detached. Gradients flow to ``wh``,
    ``f_dst`` and ``a_src``. ``precision`` is the forward's and the
    backward's: under ``'fastest'`` the backward recomputes the sender rows
    rounded to bf16 (the reference's ``exact=False`` banded take, where the
    receiver stream's backward takes them unrounded) and runs both segment
    sums in one limb."""
    check_precision("fused_v1_attention_banded", precision)
    return _FusedV1AttentionBanded.apply(wh, f_dst, bound, a_src, keepq, plan,
                                         alpha, precision)


class _FusedV2AttentionBanded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, whi, whj, ub, a, keepq, plan, alpha, precision):
        whi, whj, ub, a, keepq = (
            t.contiguous() for t in (whi, whj, ub, a, keepq))
        out, den = fused_v2_banded(whi, whj, ub, a, keepq, plan, alpha,
                                   precision=precision)
        ctx.save_for_backward(whi, whj, ub, a, keepq)
        ctx.plan, ctx.alpha, ctx.precision = plan, alpha, precision
        return out, den

    @staticmethod
    def backward(ctx, g_out, g_den):
        whi, whj, ub, a, keepq = ctx.saved_tensors
        plan, alpha, precision = ctx.plan, ctx.alpha, ctx.precision
        h, f = a.shape
        hf = h * f

        # one banded take of both sender operands (rounded to bf16 under
        # 'fastest'), one expand of the four receiver-side ones
        gj, gi = banded_take(torch.cat([whj, whi], dim=1), plan,
                             precision=precision).float().split(hf, 1)
        eall = expand(torch.cat([whi, ub, g_out, g_den], dim=1),
                      plan.r_local, plan.r_chunk)  # [E_b, 2HF + 2H]
        wi_e, ub_e, dmsg, dden = eall.split([hf, h, hf, h], dim=1)
        raw = wi_e + gj
        pre = leaky_relu(raw, alpha)
        abd = _block_diag_a(a)  # [HF, H]
        exp_bd = _expand_bd(h, f, device=whi.device)  # [H, HF]
        live = (plan.r_local < TILE)[:, None]
        num = torch.where(live, torch.exp(pre @ abd - ub_e), 0.0)
        qnum = num * keepq

        dqnum = (dmsg * gi) @ exp_bd.T  # per-head sums over F
        dlogits = (dqnum * keepq + dden) * num  # [E_b, H]
        dpre = (dlogits @ abd.T) * torch.where(raw >= 0, 1.0, alpha)

        # receiver side: dwhi from the logit path; sender side: one sum for
        # dwhj (logit path) and the message half of dwhi
        dwhi_e = _receiver_sum(dpre, plan, precision)
        red = banded_sender_sum(torch.cat([dpre, dmsg * (qnum @ exp_bd)], 1),
                                plan, precision=precision)
        da = (pre * (dlogits @ exp_bd)).sum(0).reshape(h, f)
        return (dwhi_e + red[:, hf:], red[:, :hf], None, da, None, None, None,
                None)


def fused_v2_attention_banded(whi, whj, ub, a, keepq, plan: BandPlan,
                              alpha: float, precision: str = "high"):
    """Differentiable fused GATv2 attention over the banded order: (out
    [N, HF], den [N, H]). ``keepq`` is [plan.num_slots, H], drawn over the
    banded slots; ``ub`` must be detached. Gradients flow to ``whi``,
    ``whj`` and ``a``. ``precision`` as :func:`fused_v1_attention_banded`
    (under ``'fastest'`` both recomputed sender operands, ``whj`` and
    ``whi``, are rounded)."""
    check_precision("fused_v2_attention_banded", precision)
    return _FusedV2AttentionBanded.apply(whi, whj, ub, a, keepq, plan, alpha,
                                         precision)


# ---------------------------------------------------------------------------
# SpMM over a band plan
# ---------------------------------------------------------------------------


class _SpmmBanded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, values_b, x, plan, fused, precision):
        values_b, x = values_b.contiguous(), x.contiguous()
        ctx.save_for_backward(values_b, x)
        ctx.plan, ctx.precision = plan, precision
        if fused:
            return banded_weighted_sum(values_b, x, plan, precision=precision)
        # the two-pass form: the take rounds x under 'fastest', the values
        # stay f32, and the receiver sum rounds each message
        rows = banded_take(x, plan, precision=precision).float()
        return _receiver_sum(values_b[:, None] * rows, plan, precision)

    @staticmethod
    def backward(ctx, g_out):
        values_b, x = ctx.saved_tensors
        plan, precision = ctx.plan, ctx.precision
        # dvals[k] = <g_out[recv(k)], x[send(k)]>: both rows are zero at a
        # dead slot, so dvals vanishes there; under 'fastest' x's rows are
        # the rounded ones (the reference's exact=False take)
        ge = expand(g_out.contiguous(), plan.r_local, plan.r_chunk)
        dvals = (banded_take(x, plan, precision=precision).float()
                 * ge).sum(1)
        # dx: per-sender sum of vals * g_out[recv], in one limb under
        # 'fastest'
        dx = banded_sender_sum(values_b[:, None] * ge, plan,
                               precision=precision)
        return dvals, dx, None, None, None


def spmm_banded(values_b: torch.Tensor, x: torch.Tensor, plan: BandPlan, *,
                precision: str = "fastest",
                fused: bool = True) -> torch.Tensor:
    """``out[i] = sum over the banded slots k with receiver i of
    values_b[k] * x[sender(k)]`` (``values_b`` [E_b] f32 in banded order,
    dead slots ignored; ``x`` [N_pad, L] f32, any L). ``fused=True`` runs
    select, scale and scatter in one kernel (:func:`banded_weighted_sum`),
    so the [E_b, L] messages never reach memory; ``fused=False`` keeps the
    two-pass form (:func:`banded_take`, then the stream segment sum).
    Differentiable in ``values_b`` and ``x`` with either form (the
    reference's VJP: ``banded_take`` and ``expand`` for the values, the
    banded sender sum for ``x``). ``precision`` is the reference's, whose
    default, ``'fastest'`` (one bf16 limb), this keeps: the fused form
    sums ``bf16(bf16(v) * bf16(x))`` per receiver in f32, the two-pass form
    ``bf16(v * bf16(x))`` (its values stay f32), both as the reference's
    interpret mode rounds; the backward takes x's rows rounded to bf16 for
    the values and sums per sender in one limb. ``'high'`` sums f32
    messages in f32."""
    check_precision("spmm_banded", precision)
    return _SpmmBanded.apply(values_b, x, plan, bool(fused), precision)
