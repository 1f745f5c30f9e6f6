"""Parameters from the JAX package to the port.

Both packages keep one stacked parameter set per layer with the same
layout (``W [H, F_in, F_out]``, ``a [H, 2 F_out]``, ``skip`` or None), so
the conversion is a copy into leaf tensors that require grad. The input is
the JAX parameter list with its leaves as numpy arrays (or anything
``numpy.asarray`` takes); nothing of JAX is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from pygat_tpu_torch.models.layers import V1Params
from pygat_tpu_torch.utils.platform import resolve_device


def params_from_jax(layers, device: torch.device | str | None = None
                    ) -> list[V1Params]:
    """``[V1Params(W, a, skip), ...]`` of numpy arrays -> the port's
    parameters on ``device`` (CUDA unless the caller names another device;
    raises without CUDA)."""
    device = resolve_device(device)
    out = []
    for layer in layers:
        w, a, skip = layer
        out.append(V1Params(*(
            None if t is None else torch.tensor(
                np.asarray(t, dtype=np.float32), device=device,
                requires_grad=True)
            for t in (w, a, skip))))
    return out
