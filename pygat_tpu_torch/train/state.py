"""Train state: parameters, optimizer, dropout generator and step counter
(port of ``pygat_tpu/train/state.py``).

The optimizer is ``torch.optim.Adam(lr, weight_decay=wd)``: L2 added to the
gradient before the moments, betas (0.9, 0.999), eps 1e-8, bias correction
on; the JAX package's ``chain(add_decayed_weights, adam)`` computes the
same update. Unlike the JAX state the port's state is updated in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pygat_tpu_torch.models.gat import parameters
from pygat_tpu_torch.models.layers import V1Params


@dataclass
class TrainState:
    step: int
    params: list[V1Params]
    optimizer: torch.optim.Adam
    generator: torch.Generator  # dropout masks


def make_optimizer(params: list[V1Params], lr: float,
                   weight_decay: float) -> torch.optim.Adam:
    return torch.optim.Adam(parameters(params), lr=lr,
                            weight_decay=weight_decay)


def init_state(params: list[V1Params], optimizer: torch.optim.Adam,
               generator: torch.Generator) -> TrainState:
    """A fresh state. Adam's moments are created here (zeros, step 0), as
    Adam would at its first step, so a fresh state has the same leaves as
    a trained one and a checkpoint restores into it."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state[p]
            if not st:
                st["step"] = torch.tensor(0.0)
                st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return TrainState(step=0, params=params, optimizer=optimizer,
                      generator=generator)
