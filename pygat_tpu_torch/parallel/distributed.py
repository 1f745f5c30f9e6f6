"""Distributed training state and inputs (port of
``pygat_tpu/parallel/distributed.py``).

The parameters are replicated: :func:`shard_train_state` broadcasts rank
0's once, with Adam's moments, and from then on every rank applies the
same all-reduced gradients (:func:`all_reduce_grads`), so the copies stay
equal bit for bit. The JAX package leaves the gradient reduction to GSPMD.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pygat_tpu_torch.models.gat import parameters
from pygat_tpu_torch.parallel.mesh import Mesh
from pygat_tpu_torch.train.state import TrainState, tensor_leaves


def shard_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Replicate ``state``'s parameters and optimizer state from rank 0 (in
    place; nothing is sent without a group). A leaf off the mesh's device
    (Adam's step counter, on the CPU unless the optimizer is capturable)
    travels through a copy on it: NCCL sends device tensors only."""
    if dist.is_initialized():
        with torch.no_grad():
            for t in tensor_leaves(state):
                buf = t if t.device == mesh.device else t.to(mesh.device)
                dist.broadcast(buf, src=0)
                if buf is not t:
                    t.copy_(buf)
    return state


def all_reduce_grads(params) -> None:
    """Sum every parameter's gradient over the ranks, in place, with one
    all-reduce of the gradients side by side (a parameter without a
    gradient counts as zeros). A group of one reduces too."""
    if not dist.is_initialized():
        return
    ps = parameters(params)
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in ps]
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    at = 0
    for p, g in zip(ps, grads):
        n = g.numel()
        if p.grad is None:
            p.grad = flat[at:at + n].view_as(p).clone()
        else:
            p.grad.copy_(flat[at:at + n].view_as(p))
        at += n
