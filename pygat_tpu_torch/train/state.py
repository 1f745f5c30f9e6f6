"""Train state: parameters, optimizer, dropout generator and step counter
(port of ``pygat_tpu/train/state.py``).

The optimizer is ``torch.optim.Adam(lr, weight_decay=wd)``: L2 added to the
gradient before the moments, betas (0.9, 0.999), eps 1e-8, bias correction
on; the JAX package's ``chain(add_decayed_weights, adam)`` computes the
same update. Unlike the JAX state the port's state is updated in place.
The state holds either layer kind's parameters (``V1Params`` / ``V2Params``).

``capturable=True`` keeps Adam's step counters on the parameters' device
and its update free of host reads, which a CUDA-graph capture of the train
step needs (``fit_transductive_fast``); it computes the same update.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from pygat_tpu_torch.models.gat import parameters
from pygat_tpu_torch.models.layers import V1Params, V2Params

Params = list[V1Params | V2Params]


@dataclass
class TrainState:
    step: int
    params: Params
    optimizer: torch.optim.Adam
    generator: torch.Generator  # dropout masks


def make_optimizer(params: Params, lr: float, weight_decay: float, *,
                   capturable: bool = False) -> torch.optim.Adam:
    return torch.optim.Adam(parameters(params), lr=lr,
                            weight_decay=weight_decay, capturable=capturable)


def init_state(params: Params, optimizer: torch.optim.Adam,
               generator: torch.Generator) -> TrainState:
    """A fresh state. Adam's moments are created here (zeros, step 0), as
    Adam would at its first step, so a fresh state has the same leaves as
    a trained one and a checkpoint restores into it. The step counter sits
    where Adam would put it: on the parameter's device when the optimizer
    is capturable, else on the CPU."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            st = optimizer.state[p]
            if not st:
                st["step"] = torch.zeros(
                    (), dtype=torch.float32,
                    device=p.device if group["capturable"] else "cpu")
                st["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
    return TrainState(step=0, params=params, optimizer=optimizer,
                      generator=generator)


def tensor_leaves(state: TrainState, params: Params | None = None
                  ) -> list[torch.Tensor]:
    """The state's tensors in a fixed order: the parameters (``params`` in
    place of the state's own when given), then each of the state's
    parameters' optimizer state by sorted key."""
    own = parameters(state.params)
    leaves = list(own if params is None else parameters(params))
    for p in own:
        st = state.optimizer.state[p]
        leaves += [st[k] for k in sorted(st)]
    return leaves
