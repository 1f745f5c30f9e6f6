"""Distributed training state and inputs (port of
``pygat_tpu/parallel/distributed.py``).

:func:`shard_train_state` broadcasts rank 0's state once; with a model
axis each rank then keeps its heads of every split leaf (and of Adam's
moments, which follow their parameters: Adam and the L2 term added to the
gradient are elementwise, so a slice's update is the update's slice). From
then on every rank applies gradients all-reduced over its data group
(:func:`all_reduce_grads`), so each leaf's copies stay equal bit for bit:
a replicated leaf on every rank, a split one on the ranks of its model
index. The JAX package leaves the gradient reduction to GSPMD.

A checkpoint is the one-device format at every mesh: :func:`save_state`
gathers the heads over the model group (every rank calls it) and rank 0
writes; :func:`restore_state` reads the file on every rank and keeps the
rank's heads.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pygat_tpu_torch.models.gat import parameters
from pygat_tpu_torch.parallel import collectives as col
from pygat_tpu_torch.parallel.mesh import Mesh
from pygat_tpu_torch.parallel.sharding import head_rows, param_split
from pygat_tpu_torch.train import checkpoint as ckpt
from pygat_tpu_torch.train.state import (
    TrainState,
    leaf_split,
    tensor_leaves,
)


def _rebuild(state: TrainState, params, moment, flags, split=(),
             model=(0, 1), generator=None) -> TrainState:
    """A state over the new leaves ``params`` (shaped as ``state.params``),
    with an Adam of the same settings whose moments are ``moment(t,
    flag)`` of the old ones (``flags``: per parameter), its step counters
    copied."""
    old = parameters(state.params)
    opt = torch.optim.Adam(parameters(params), **state.optimizer.defaults)
    for p_old, p_new, flag in zip(old, parameters(params), flags):
        opt.state[p_new] = {
            k: (moment(v, flag) if v.ndim else v.detach().clone())
            for k, v in state.optimizer.state[p_old].items()}
    return TrainState(step=state.step, params=params, optimizer=opt,
                      generator=(state.generator if generator is None
                                 else generator),
                      split=tuple(split), model=tuple(model))


def _leaf(t: torch.Tensor) -> torch.Tensor:
    return t.detach().clone().requires_grad_()


def slice_state(state: TrainState, m: int, n_model: int) -> TrainState:
    """Model index ``m``'s share of a whole ``state`` (one device, no
    collective): each split leaf's heads (:func:`~pygat_tpu_torch.
    parallel.sharding.split_leaf`) and their Adam moments, the other
    leaves whole; new tensors throughout, and a new Adam over them."""
    if state.split:
        raise ValueError("the state is already split")
    flags = [f for layer in param_split(state.params, n_model)
             for f in layer if f is not None]
    params = [type(lp)(*(None if t is None else
                         _leaf(head_rows(t.detach(), m, n_model))
                         for t in lp)) for lp in state.params]
    return _rebuild(state, params,
                    lambda t, flag: head_rows(t.detach(), m, n_model).clone()
                    if flag else t.detach().clone(), flags,
                    split=flags if any(flags) else (), model=(m, n_model))


def _merge(state: TrainState, join, params=None) -> TrainState:
    """The whole state of a split ``state`` whose split leaves ``join``
    makes whole (an all-gather, or a concatenation on one device);
    ``params`` in place of the state's own parameters."""
    src = state.params if params is None else params
    flags = iter(state.split)
    whole = []
    for lp in src:
        whole.append(type(lp)(*(None if t is None else
                                _leaf(join(t) if next(flags) else t)
                                for t in lp)))
    gen = state.generator
    return _rebuild(state, whole,
                    lambda t, flag: join(t) if flag else t.detach().clone(),
                    state.split, generator=getattr(gen, "shared", gen))


def gather_heads_state(state: TrainState, mesh: Mesh,
                       params=None) -> TrainState:
    """The whole state (parameters, Adam's moments, the shared dropout
    generator) of this rank's split ``state``: every split leaf gathered
    over the model group, in model order; ``params`` (split as the
    state's) in place of the state's parameters. Collective: every rank
    of the model group calls it. A state that is not split comes back as
    it is."""
    if not state.split:
        return state
    return _merge(state, lambda t: col.all_gather(t, mesh.model_group),
                  params)


def merge_states(states: list[TrainState]) -> TrainState:
    """:func:`gather_heads_state` on one device: the whole state of the
    model ranks' split states ``states`` (in model order), by
    concatenation."""
    parts = {id(t): i for i, t in enumerate(tensor_leaves(states[0]))}
    by_rank = [tensor_leaves(s) for s in states]

    def join(t):
        i = parts[id(t)]
        return torch.cat([leaves[i].detach() for leaves in by_rank])

    return _merge(states[0], join)


def shard_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Replicate ``state``'s parameters and optimizer state from rank 0 (in
    place; nothing is sent without a group), and with a model axis return
    this rank's share of it (:func:`slice_state`); else ``state`` itself.
    A leaf off the mesh's device (Adam's step counter, on the CPU unless
    the optimizer is capturable) travels through a copy on it: NCCL sends
    device tensors only."""
    if dist.is_initialized():
        with torch.no_grad():
            for t in tensor_leaves(state):
                buf = t if t.device == mesh.device else t.to(mesh.device)
                dist.broadcast(buf, src=0)
                if buf is not t:
                    t.copy_(buf)
    if mesh.n_model == 1:
        return state
    return slice_state(state, mesh.model_index, mesh.n_model)


def all_reduce_grads(params, group=None) -> None:
    """Sum every parameter's gradient over ``group`` (a mesh's data group;
    None: every rank), in place, with one all-reduce of the gradients side
    by side (a parameter without a gradient counts as zeros). A group of
    one reduces too. A split leaf is reduced only over the ranks of its
    model index, which hold the same heads."""
    if not dist.is_initialized():
        return
    ps = parameters(params)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in ps]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=group)
    at = 0
    for p, g in zip(ps, grads):
        n = g.numel()
        if p.grad is None:
            p.grad = flat[at:at + n].view_as(p).clone()
        else:
            p.grad.copy_(flat[at:at + n].view_as(p))
        at += n


def save_state(mesh: Mesh | None, ckpt_dir: str, epoch: int, tag: str,
               state: TrainState, extra: dict | None = None,
               params=None) -> None:
    """:func:`~pygat_tpu_torch.train.checkpoint.save` of the whole state,
    written by rank 0 alone (without a mesh: by this process). With a
    model axis every rank must call it: the heads are gathered first."""
    if mesh is not None and state.split:
        state = gather_heads_state(state, mesh, params)
        params = None
    if mesh is None or mesh.is_main:
        ckpt.save(ckpt_dir, epoch, tag, state, extra=extra, params=params)


def _select(state: TrainState, flags):
    m, n_model = state.model
    return lambda i, arr: head_rows(arr, m, n_model) if flags[i] else arr


def restore_state(path: str, state: TrainState) -> tuple[TrainState, dict]:
    """:func:`~pygat_tpu_torch.train.checkpoint.restore` of a one-device
    checkpoint into ``state``, keeping this rank's heads of each split
    leaf (no collective: every rank reads the file)."""
    return ckpt.restore(path, like=state,
                        select=_select(state, leaf_split(state)))


def restore_params_split(path: str, state: TrainState, into) -> None:
    """:func:`~pygat_tpu_torch.train.checkpoint.restore_params` into the
    parameter set ``into`` (split as ``state``'s), this rank's heads."""
    ckpt.restore_params(path, into=into,
                        select=_select(state, leaf_split(state)))
