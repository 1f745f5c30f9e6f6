"""Expand: rows of a node table in the order of a chunked edge stream (port
of the expand kernel of ``pygat_tpu/ops/large.py``).

:func:`expand` gives slot ``k`` the row ``x[chunk_tile[k // EC] * 128 +
local[k]]`` and zeros at dead slots (``local == 128``), bit-exact. On a CUDA
tensor it launches the hand-written kernel ``csrc/expand.cu``, which
replaces the TPU kernel ``pygat_tpu/ops/large.py::_make_expand_kernel``; on
a CPU tensor it runs :func:`expand_plain`, the plain PyTorch version that is
also the kernel's oracle. The banded backward (:mod:`.banded`) reads its
receiver-side operands this way; the corner and panel paths of the JAX
package, which use it too, are not ported.
"""

from __future__ import annotations

import torch

from pygat_tpu_torch.ops import build
from pygat_tpu_torch.ops.stream import EC, TILE


def _check_args(x, local, chunk_tile):
    if x.dim() != 2 or x.dtype != torch.float32 or x.shape[0] % TILE:
        raise ValueError(f"expand: x must be [N_pad, L] float32 on 128-row "
                         f"tiles, got {x.dtype} {tuple(x.shape)}")
    if local.dim() != 1 or local.shape[0] != chunk_tile.shape[0] * EC:
        raise ValueError("expand: local must hold EC slots per chunk of "
                         "chunk_tile")
    for t in (local, chunk_tile):
        if t.dtype != torch.int32:
            raise ValueError(f"expand takes int32 indices, got {t.dtype}")


def expand_plain(x: torch.Tensor, local: torch.Tensor,
                 chunk_tile: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`expand` (a row gather)."""
    _check_args(x, local, chunk_tile)
    live = local < TILE
    rows = chunk_tile.long().repeat_interleave(EC) * TILE + local.long()
    rows = torch.where(live, rows, 0)
    return torch.where(live[:, None], x[rows], 0.0)


@build.counted
def expand(x: torch.Tensor, local: torch.Tensor,
           chunk_tile: torch.Tensor) -> torch.Tensor:
    """[C * EC, L] rows of ``x`` [N_pad, L] f32 in stream order: slot ``k``
    gets ``x[chunk_tile[k // EC] * 128 + local[k]]``, zeros where
    ``local[k] == 128``. On a CUDA tensor this launches ``csrc/expand.cu``
    (counted in ``expand.launches``); on a CPU tensor it runs
    :func:`expand_plain`. Not differentiable."""
    if x.device.type == "cpu":
        return expand_plain(x, local, chunk_tile)
    if x.device.type != "cuda":
        raise ValueError(f"expand: unsupported device {x.device}")
    _check_args(x, local, chunk_tile)
    out = torch.empty(local.shape[0], x.shape[1], dtype=torch.float32,
                      device=x.device)
    build.launch(expand, x, local, chunk_tile, chunk_tile.shape[0],
                 x.shape[1], out)
    return out
