"""Parameter initializers replicating the reference's torch distributions
(port of ``pygat_tpu/models/init.py``).

Sparse layers draw ``W`` and ``a`` from xavier normal, skip projections from
xavier uniform, all with gain 1.414. The bound depends only on the sum of
the two fan dims, so ``a`` stored as ``[2F]`` uses the fan sum of the
reference's ``[2F, 1]``. All heads of a layer are drawn in one call from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

import math

import torch

GAIN = 1.414  # reference uses nn.init gain=1.414 everywhere


def xavier_uniform(gen: torch.Generator, shape, fan_sum: int,
                   gain: float = GAIN) -> torch.Tensor:
    """U(-b, b) with b = gain * sqrt(6 / fan_sum); fan_sum = fan_in + fan_out."""
    bound = gain * math.sqrt(6.0 / fan_sum)
    u = torch.rand(shape, generator=gen, device=gen.device)
    return u * (2 * bound) - bound


def xavier_normal(gen: torch.Generator, shape, fan_sum: int,
                  gain: float = GAIN) -> torch.Tensor:
    """N(0, std^2) with std = gain * sqrt(2 / fan_sum)."""
    std = gain * math.sqrt(2.0 / fan_sum)
    return torch.randn(shape, generator=gen, device=gen.device) * std
