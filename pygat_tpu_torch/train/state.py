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
from typing import Any

import torch

from pygat_tpu_torch.models.gat import parameters
from pygat_tpu_torch.models.layers import V1Params, V2Params

Params = list[V1Params | V2Params]


@dataclass
class TrainState:
    """``generator`` draws the dropout masks: one ``torch.Generator``, or
    under a model axis a :class:`~pygat_tpu_torch.models.gat.
    HeadGenerators` pair. ``split`` says, per parameter (the order of
    :func:`~pygat_tpu_torch.models.gat.parameters`), whether this state
    holds only model index ``model[0]``'s heads of it, of ``model[1]``
    model ranks (empty: the whole model)."""

    step: int
    params: Params
    optimizer: torch.optim.Adam
    generator: Any  # dropout masks
    split: tuple = ()
    model: tuple = (0, 1)


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


def leaf_split(state: TrainState) -> list[bool]:
    """Per tensor of :func:`tensor_leaves`, whether it holds the model
    rank's heads only: a split parameter and its Adam moments (the step
    counter, a scalar, is whole)."""
    flags = list(state.split) or [False] * len(parameters(state.params))
    out = list(flags)
    for p, flag in zip(parameters(state.params), flags):
        st = state.optimizer.state[p]
        out += [flag and st[k].ndim > 0 for k in sorted(st)]
    return out


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
