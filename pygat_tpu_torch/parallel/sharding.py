"""The data-axis half of ``pygat_tpu/parallel/sharding.py``: which node rows
and which split indices are this rank's.

Where the JAX package places one array over the mesh with a
``PartitionSpec``, each rank of the port holds its own part: node shard
``r`` is rows ``r * n_local .. (r + 1) * n_local - 1``, the shard whose
edges into it the ring partition gives rank ``r``. The head axis (the
``model`` half: ``param_pspecs``, ``head_leaf_spec``) is ROADMAP item 18.
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


def node_range(mesh: Mesh, n_pad: int) -> tuple[int, int]:
    """(first, end) of this rank's node rows."""
    if n_pad % mesh.n_data:
        raise ValueError(f"N_pad={n_pad} not divisible by {mesh.n_data} "
                         "shards")
    n_local = n_pad // mesh.n_data
    return mesh.rank * n_local, (mesh.rank + 1) * n_local


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
