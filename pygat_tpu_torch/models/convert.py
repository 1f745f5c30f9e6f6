"""Parameters from the JAX package to the port.

Both packages keep one stacked parameter set per layer with the same
layout (GATv1: ``W [H, F_in, F_out]``, ``a [H, 2 F_out]``; GATv2:
``W [H, 2 F_in, F_out]``, ``a [H, F_out]``; ``skip`` or None), so the
conversion is a copy into leaf tensors that require grad. The input is the
JAX parameter list with its leaves as numpy arrays (or anything
``numpy.asarray`` takes); nothing of JAX is imported here, so the two layer
kinds are told apart by the width of ``a``.
"""

from __future__ import annotations

import numpy as np
import torch

from pygat_tpu_torch.models.layers import V1Params, V2Params
from pygat_tpu_torch.utils.platform import resolve_device


def params_from_jax(layers, device: torch.device | str | None = None, *,
                    model: tuple[int, int] | None = None
                    ) -> list[V1Params | V2Params]:
    """``[V1Params(W, a, skip), ...]`` or ``[V2Params(W, a, skip), ...]`` of
    numpy arrays -> the port's parameters on ``device`` (CUDA unless the
    caller names another device; raises without CUDA). A layer is GATv2
    when ``a`` has ``F_out`` columns, GATv1 when it has ``2 F_out``.
    ``model=(m, M)``: model index ``m``'s heads of a mesh with ``M`` model
    ranks (:func:`~pygat_tpu_torch.parallel.sharding.head_slice`), each
    split leaf's rows copied alone."""
    from pygat_tpu_torch.parallel.sharding import head_rows

    device = resolve_device(device)
    out = []
    for layer in layers:
        w, a, skip = layer
        f_out = np.shape(w)[2]
        if model is not None:
            w, a, skip = (None if t is None else head_rows(np.asarray(t),
                                                          *model)
                          for t in (w, a, skip))
        if np.shape(a)[1] not in (f_out, 2 * f_out):
            raise ValueError(f"a {np.shape(a)} fits neither GATv1 nor GATv2 "
                             f"with W {np.shape(w)}")
        cls = V2Params if np.shape(a)[1] == f_out else V1Params
        out.append(cls(*(
            None if t is None else torch.tensor(
                np.asarray(t, dtype=np.float32), device=device,
                requires_grad=True)
            for t in (w, a, skip))))
    return out
