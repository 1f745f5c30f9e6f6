"""Segment reductions, the segment softmax and edge gathers (port of
``pygat_tpu/ops/segment.py``).

* :func:`segment_sum` is the plain scatter-add (``index_add_``), the
  reference's ``jax.ops.segment_sum``, and :func:`segment_max` the plain
  scatter-max (``scatter_reduce_("amax")``, ``-inf`` for an empty segment),
  its ``jax.ops.segment_max``;
* :func:`sorted_segment_sum`, :func:`sorted_segment_max` and
  :func:`sender_segment_sum` take the reference's arguments (CSR offsets,
  the CSC view) and keep its gradient rules: the sums' gradients are
  gathers, the max stops the gradient and fills empty segments with
  ``-9e15``; :func:`take_receivers` / :func:`take_senders` are the row
  gathers whose gradients are those sums. The reference lowers them to
  segmented scans or XLA scatters; here they are ``index_add_`` and
  ``scatter_reduce_``;
* :func:`segment_softmax_stable` returns the reference's ``(numerator,
  denominator)``, with padding edges at 0;
* :func:`segment_sum_receivers` / :func:`segment_sum_senders` sum edge data
  per receiver / per sender, and :func:`gather_receivers` /
  :func:`gather_senders` / :func:`gather_receivers_hn` (``x[:,
  receivers]`` of a head-major ``[H, N]`` table) are the row gathers whose
  gradient is the opposite-side sum, as in the reference's custom VJPs.
  Where the stream impl is active (below) and the graph has its stream
  layout, each sum runs the stream segment sum (kernel
  ``csrc/stream_scatter.cu``): the receiver side over the graph's stream
  order (its walk ``graph.stream_walk``), the sender side through the CSC
  slot map (its walk ``graph.sender_walk``). Otherwise it is
  :func:`segment_sum` (``index_add_``; along the head-major table's
  columns for ``gather_receivers_hn``).

The impl switch is the reference's: :func:`set_segment_impl` sets the
process default (``PYGAT_SEGMENT_IMPL`` at import, else ``auto``) and
:func:`use_impl` overrides it in a scope. ``stream`` and ``auto`` take the
stream sums, ``scatter`` and ``scan`` ``index_add_``. Two deliberate
differences from the reference: ``auto`` means the stream sums on every
device (the reference's ``auto`` is "stream on the TPU only"; on a CPU
tensor the stream sum runs its plain version), and ``scan`` names the
reference's segmented-scan lowering, which here computes the same sums as
``scatter``. A sum or gather reads the impl when its forward runs and its
backward keeps that choice, since PyTorch runs a backward later, and on
CUDA in another thread, where the scope is gone.

The stream sums' precision is the reference's switch: ``precision=`` of
:func:`segment_sum_receivers` / :func:`segment_sum_senders` (``'high'``,
f32 sums, or ``'fastest'``, the data rounded to one bf16 limb and summed in
f32: kernel ``csrc/stream_scatter_bf16.cu`` on the card), and where a call
names none, the module default ``_STREAM_PRECISION``, read once from
``PYGAT_STREAM_PRECISION`` at import (the sparse layers and the ring read
it too, and the gathers' backward sums take the value it had when their
forward ran). The ``index_add_`` branch sums in f32 whatever the precision,
as the reference's scatter does. One deliberate difference: the unset
default is ``'high'`` here, where the reference's is ``'fastest'``. The
reference's ``auto`` runs no stream kernel off the TPU, so on the CPU it
sums in f32 whatever the variable says; the port's ``auto`` runs the
stream sums everywhere, and a ``'fastest'`` default would round on the CPU
where the reference does not.

Edge data may be [E_pad] or [E_pad, ...]; trailing dimensions are summed
as columns.
"""

from __future__ import annotations

import contextlib
import contextvars
import os

import torch

from pygat_tpu_torch.ops.stream import check_precision, stream_scatter


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *, sorted_ids: bool = True) -> torch.Tensor:
    """``out[s] = sum of data[e] over segment_ids[e] == s`` ([num_segments,
    ...]). ``sorted_ids`` is accepted for the reference's signature; the
    sum does not need it."""
    del sorted_ids
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


NEG_FILL = -9e15  # the reference's fill for masked logits and empty maxima


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, *, sorted_ids: bool = True) -> torch.Tensor:
    """``out[s] = max of data[e] over segment_ids[e] == s``; ``-inf`` for an
    empty segment, as ``jax.ops.segment_max`` gives. ``sorted_ids`` is
    accepted for the reference's signature."""
    del sorted_ids
    out = torch.full((num_segments,) + tuple(data.shape[1:]), -torch.inf,
                     dtype=data.dtype, device=data.device)
    ids = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    return out.scatter_reduce(0, ids.expand_as(data), data, "amax",
                              include_self=False)


def sorted_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       row_ptr: torch.Tensor) -> torch.Tensor:
    """Per-segment sum of ``data`` [E, ...] grouped by sorted
    ``segment_ids`` -> [N, ...], zeros for empty segments; ``row_ptr``
    [N + 1] are the CSR offsets (only their length is read). The gradient
    (``index_add_``'s) is the gather ``g[segment_ids]``."""
    return segment_sum(data, segment_ids, row_ptr.shape[0] - 1)


def sorted_segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                       row_ptr: torch.Tensor, *,
                       fill: float = NEG_FILL) -> torch.Tensor:
    """Per-segment max (sorted ids), ``fill`` where the max is not finite
    (an empty segment). Stops the gradient: its use is softmax
    stabilisation, where the shift cancels."""
    out = segment_max(data.detach(), segment_ids, row_ptr.shape[0] - 1)
    return torch.where(torch.isfinite(out), out, fill)


def sender_segment_sum(data: torch.Tensor, senders: torch.Tensor,
                       col_perm: torch.Tensor,
                       col_ptr: torch.Tensor) -> torch.Tensor:
    """Per-sender sum of edge ``data`` [E, ...] -> [N, ...]. ``col_perm`` /
    ``col_ptr`` are the graph's CSC view, taken for the reference's
    signature (only ``col_ptr``'s length is read). The gradient
    (``index_add_``'s) is the gather ``g[senders]``."""
    del col_perm
    return segment_sum(data, senders, col_ptr.shape[0] - 1, sorted_ids=False)


def segment_softmax_stable(
    logits: torch.Tensor,  # [E, ...] per-edge attention logits
    segment_ids: torch.Tensor,  # [E] receiver of each edge (sorted)
    num_segments: int,
    edge_mask: torch.Tensor | None = None,  # [E] bool, False on padding
    *,
    sorted_ids: bool = True,
    row_ptr: torch.Tensor | None = None,  # [N + 1] CSR offsets
) -> tuple[torch.Tensor, torch.Tensor]:
    """Numerically stable segment softmax as ``(numerator [E, ...],
    denominator [N, ...])``: ``exp(logit - max of its segment)`` and the
    per-segment sum, kept apart because attention dropout multiplies the
    numerator after the denominator is taken (reference ``layers.py``
    :145-160). The max is gradient-stopped (the shift cancels); padding
    edges get numerator 0, and an empty segment denominator 0. Trailing
    dimensions of ``logits`` (heads) are batched."""
    ids = segment_ids.long()
    mask = None
    if edge_mask is not None:
        mask = edge_mask.reshape((-1,) + (1,) * (logits.dim() - 1))
        logits = torch.where(mask, logits, NEG_FILL)
    if row_ptr is not None:
        seg_max = sorted_segment_max(logits, segment_ids, row_ptr)
    else:
        seg_max = segment_max(logits.detach(), segment_ids, num_segments,
                              sorted_ids=sorted_ids)
    # empty or all-padding segments: a max of -inf or the fill becomes 0,
    # so the exp below stays finite
    seg_max = torch.where(torch.isfinite(seg_max) & (seg_max > -8.9e15),
                          seg_max, 0.0)
    num = torch.exp(logits - seg_max.detach()[ids])
    if mask is not None:
        num = torch.where(mask, num, 0.0)
    if row_ptr is not None:
        den = sorted_segment_sum(num, segment_ids, row_ptr)
    else:
        den = segment_sum(num, segment_ids, num_segments)
    return num, den


# ---------------------------------------------------------------------------
# The impl switch
# ---------------------------------------------------------------------------

_IMPLS = ("auto", "stream", "scan", "scatter")
_STREAM_IMPLS = ("auto", "stream")

_segment_impl = os.environ.get("PYGAT_SEGMENT_IMPL", "auto")

# scoped override (use_impl), for one forward without touching the process
# default
_impl_override: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "pygat_torch_segment_impl_override", default=None)


def set_segment_impl(name: str) -> None:
    """Process-wide default: ``'auto'`` or ``'stream'`` (the stream segment
    sums), ``'scan'`` or ``'scatter'`` (``index_add_``). For one forward
    prefer the scoped :func:`use_impl`."""
    global _segment_impl
    if name not in _IMPLS:
        raise ValueError(f"unknown segment impl {name!r}")
    _segment_impl = name


@contextlib.contextmanager
def use_impl(name: str | None):
    """Scoped segment-impl override (``None``: no change) for every sum and
    gather whose forward runs inside the ``with`` body; restored on
    exit."""
    if name is None:
        yield
        return
    if name not in _IMPLS:
        raise ValueError(f"unknown segment impl {name!r}")
    token = _impl_override.set(name)
    try:
        yield
    finally:
        _impl_override.reset(token)


def current_impl() -> str:
    """The active segment impl: the scoped override, else the default."""
    return _impl_override.get() or _segment_impl


# the stream sums' precision where a caller names none (module docstring)
_STREAM_PRECISION = os.environ.get("PYGAT_STREAM_PRECISION", "high")


def stream_precision(precision: str | None = None) -> str:
    """``precision``, or the module default ``_STREAM_PRECISION`` when it is
    None; raises ``ValueError`` unless the result is ``'high'`` or
    ``'fastest'``."""
    if precision is None:
        return check_precision("PYGAT_STREAM_PRECISION", _STREAM_PRECISION)
    return check_precision("precision", precision)


def stream_enabled() -> bool:
    """Whether the stream segment sums are the active lowering."""
    impl = current_impl()
    if impl not in _IMPLS:
        raise ValueError(f"unknown segment impl {impl!r} "
                         "(PYGAT_SEGMENT_IMPL)")
    return impl in _STREAM_IMPLS


# ---------------------------------------------------------------------------
# Graph-aware sums and gathers
# ---------------------------------------------------------------------------


def _receiver_sum(data: torch.Tensor, graph, stream: bool,
                  precision: str) -> torch.Tensor:
    n_pad = graph.num_nodes_padded
    if not stream or graph.r_local is None:
        return segment_sum(data, graph.receivers, n_pad)
    flat = data.reshape(data.shape[0], -1).contiguous()
    out = stream_scatter(flat, graph.r_local, graph.r_chunk, n_pad,
                         walk=graph.stream_walk, precision=precision)
    return out.reshape((n_pad,) + tuple(data.shape[1:]))


def _sender_sum(data: torch.Tensor, graph, stream: bool,
                precision: str) -> torch.Tensor:
    n_pad = graph.num_nodes_padded
    if not stream or graph.c_local is None:
        return segment_sum(data, graph.senders, n_pad, sorted_ids=False)
    flat = data.reshape(data.shape[0], -1).contiguous()
    out = stream_scatter(flat, graph.c_local, graph.c_chunk, n_pad,
                         slot=graph.c_slot, walk=graph.sender_walk,
                         precision=precision)
    return out.reshape((n_pad,) + tuple(data.shape[1:]))


class _SumReceivers(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, graph, precision):
        ctx.graph = graph
        return _receiver_sum(data, graph, stream_enabled(), precision)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.graph.receivers.long()], None, None


class _SumSenders(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, graph, precision):
        ctx.graph = graph
        return _sender_sum(data, graph, stream_enabled(), precision)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.graph.senders.long()], None, None


class _GatherReceivers(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph, ctx.stream = graph, stream_enabled()
        ctx.precision = stream_precision()
        return x[graph.receivers.long()]

    @staticmethod
    def backward(ctx, g):
        return _receiver_sum(g, ctx.graph, ctx.stream, ctx.precision), None


class _GatherSenders(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph, ctx.stream = graph, stream_enabled()
        ctx.precision = stream_precision()
        return x[graph.senders.long()]

    @staticmethod
    def backward(ctx, g):
        return _sender_sum(g, ctx.graph, ctx.stream, ctx.precision), None


class _GatherReceiversHN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, graph):
        ctx.graph, ctx.stream = graph, stream_enabled()
        ctx.precision = stream_precision()
        return x[:, graph.receivers.long()]

    @staticmethod
    def backward(ctx, g):
        graph = ctx.graph
        if ctx.stream and graph.r_local is not None:
            # [H, E] -> a contiguous [E, H] for the stream sum, and back
            return _receiver_sum(g.t().contiguous(), graph, True,
                                 ctx.precision).t(), None
        out = torch.zeros(g.shape[0], graph.num_nodes_padded, dtype=g.dtype,
                          device=g.device)
        return out.index_add_(1, graph.receivers.long(), g), None


class _Take(torch.autograd.Function):
    """``x[idx]`` whose gradient is the per-``idx`` segment sum over
    ``num_segments`` rows."""

    @staticmethod
    def forward(ctx, x, idx, num_segments):
        ctx.save_for_backward(idx)
        ctx.num_segments = num_segments
        return x[idx.long()]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return segment_sum(g, idx, ctx.num_segments), None, None


def segment_sum_receivers(data: torch.Tensor, graph, *,
                          precision: str | None = None) -> torch.Tensor:
    """Sum edge ``data`` [E_pad, ...] per receiver -> [N_pad, ...]; the
    gradient is ``g[graph.receivers]``. ``precision``: ``'high'`` or
    ``'fastest'`` for the stream sum (None: the module default,
    ``PYGAT_STREAM_PRECISION``)."""
    return _SumReceivers.apply(data, graph, stream_precision(precision))


def segment_sum_senders(data: torch.Tensor, graph, *,
                        precision: str | None = None) -> torch.Tensor:
    """Sum edge ``data`` [E_pad, ...] per sender -> [N_pad, ...]; the
    gradient is ``g[graph.senders]``. ``precision`` as
    :func:`segment_sum_receivers`."""
    return _SumSenders.apply(data, graph, stream_precision(precision))


def gather_receivers(x: torch.Tensor, graph) -> torch.Tensor:
    """``x[graph.receivers]``, whose gradient is the receiver segment sum."""
    return _GatherReceivers.apply(x, graph)


def gather_senders(x: torch.Tensor, graph) -> torch.Tensor:
    """``x[graph.senders]``, whose gradient is the sender segment sum."""
    return _GatherSenders.apply(x, graph)


def gather_receivers_hn(x: torch.Tensor, graph) -> torch.Tensor:
    """``x[:, graph.receivers]`` for a head-major [H, N_pad] table -> [H,
    E_pad]. The gradient is the receiver segment sum of the [H, E]
    cotangent: under the stream impl, of its transpose as a contiguous
    [E, H], transposed back; otherwise an ``index_add_`` along the
    columns."""
    return _GatherReceiversHN.apply(x, graph)


def take_receivers(x: torch.Tensor, receivers: torch.Tensor,
                   row_ptr: torch.Tensor) -> torch.Tensor:
    """``x[receivers]``, whose gradient is :func:`sorted_segment_sum` over
    the CSR offsets ``row_ptr`` [N + 1] (only their length is read)."""
    return _Take.apply(x, receivers, row_ptr.shape[0] - 1)


def take_senders(x: torch.Tensor, senders: torch.Tensor,
                 col_perm: torch.Tensor, col_ptr: torch.Tensor) -> torch.Tensor:
    """``x[senders]``, whose gradient is :func:`sender_segment_sum` over the
    CSC view (``col_perm`` is taken for the reference's signature; only
    ``col_ptr``'s length is read)."""
    del col_perm
    return _Take.apply(x, senders, col_ptr.shape[0] - 1)
