"""Which part of each array is this rank's (port of
``pygat_tpu/parallel/sharding.py``).

Where the JAX package places one array over the mesh with a
``PartitionSpec``, each rank of the port holds its own part:

* the ``data`` half: node shard ``d`` (the rank's data index) is rows ``d
  * n_local .. (d + 1) * n_local - 1``, the shard whose edges into it the
  ring partition gives that data index;
* the ``model`` half: a head-stacked ``[H, ...]`` leaf whose H divides by
  ``n_model`` is split on its head axis (:func:`split_leaf`, decided from
  the shape alone as ``head_leaf_spec`` decides), and model index ``m``
  holds heads ``m * H/M .. (m + 1) * H/M - 1`` (:func:`head_slice`); every
  other leaf is replicated. Adam's moments mirror their parameters' shapes
  and follow them; its step counter, a scalar, is replicated.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pygat_tpu_torch.parallel.mesh import Mesh


class ShardIdx(NamedTuple):
    """This rank's share of a split (train, validation or test): the
    positions of its nodes among the shard's rows, and the split's size
    over every rank (a mean over the split divides by it)."""

    local: torch.Tensor  # [n_mine] int64 rows of the shard
    count: int


def split_leaf(shape, n_model: int) -> bool:
    """Whether a leaf of ``shape`` is split on the model axis: the JAX
    ``head_leaf_spec`` (``pygat_tpu/parallel/sharding.py:55-64``) shards a
    leaf of at least one dimension whose leading size is a multiple of
    ``n_model > 1`` and not smaller than it; scalars and other leading
    sizes replicate."""
    shape = tuple(shape)
    return (len(shape) > 0 and n_model > 1 and shape[0] % n_model == 0
            and shape[0] >= n_model)


def param_split(params, n_model: int) -> list[tuple]:
    """:func:`split_leaf` of every leaf of ``params`` (full-size, any
    array with a ``shape``), layer by layer, None where a leaf is None:
    the counterpart of ``param_pspecs``."""
    return [tuple(None if t is None else split_leaf(t.shape, n_model)
                  for t in layer) for layer in params]


def head_rows(t, m: int, n_model: int):
    """Model index ``m``'s rows of the head axis of ``t`` (any array), or
    ``t`` itself where the leaf is not split."""
    if not split_leaf(t.shape, n_model):
        return t
    k = t.shape[0] // n_model
    return t[m * k:(m + 1) * k]


def head_slice(params, m: int, n_model: int) -> list:
    """Model index ``m``'s heads of ``params`` (full-size) on a model axis
    of ``n_model``: each split leaf's rows ``m * H/M .. (m + 1) * H/M -
    1``, each replicated leaf as it is (the same objects). The leaves are
    the same kind as the input's: slices of tensors are views (the caller
    clones what it trains), of numpy arrays numpy arrays."""
    return [_like(layer, [None if t is None else head_rows(t, m, n_model)
                          for t in layer]) for layer in params]


def _like(layer, leaves):
    """``leaves`` in ``layer``'s container (a NamedTuple or a tuple)."""
    return type(layer)(*leaves) if hasattr(layer, "_fields") else tuple(leaves)


def node_range(mesh: Mesh, n_pad: int) -> tuple[int, int]:
    """(first, end) of this rank's node rows (by its data index)."""
    if n_pad % mesh.n_data:
        raise ValueError(f"N_pad={n_pad} not divisible by {mesh.n_data} "
                         "shards")
    n_local = n_pad // mesh.n_data
    d = mesh.data_index
    return d * n_local, (d + 1) * n_local


def shard_index(idx: torch.Tensor, mesh: Mesh, n_pad: int) -> ShardIdx:
    """The split ``idx`` (global node ids) as this rank's :class:`ShardIdx`."""
    lo, hi = node_range(mesh, n_pad)
    idx = idx.long()
    mine = idx[(idx >= lo) & (idx < hi)] - lo
    return ShardIdx(local=mine.to(mesh.device), count=int(idx.numel()))


def shard_transductive_data(data, mesh: Mesh):
    """``data`` (a CitationDataset on any device) with this rank's node rows
    of the features and labels, on the rank's device, and its
    :class:`ShardIdx` of each split; the graph is left whole (the ring
    reads its partition, not the graph)."""
    n_pad = data.graph.num_nodes_padded
    lo, hi = node_range(mesh, n_pad)
    return data._replace(
        features=data.features[lo:hi].contiguous().to(mesh.device),
        labels=data.labels[lo:hi].contiguous().to(mesh.device),
        idx_train=shard_index(data.idx_train, mesh, n_pad),
        idx_val=shard_index(data.idx_val, mesh, n_pad),
        idx_test=shard_index(data.idx_test, mesh, n_pad))
