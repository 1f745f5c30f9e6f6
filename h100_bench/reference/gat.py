"""A plain PyTorch GAT, float32, with no kernel, cache or batching: the
layer stack of Velickovic et al., "Graph Attention Networks" (ICLR 2018,
arXiv:1710.10903), with its loss head and a plain Adam step. It imports
nothing of the port; autograd gives the backward.

A layer of H heads over the edges ``j -> i`` (self-loops included):
``wh = x W``, ``e_ij = LeakyReLU(a_dst . wh_i + a_src . wh_j)``, a softmax
over each receiver's in-edges (the receiver's largest logit subtracted, by
``scatter_reduce``; sums by ``index_add_``), ``out_i = sum_j alpha_ij
wh_j``, then a skip projection of the input where the model has one, ELU
and the heads side by side in a hidden layer, their mean in the last.

The cells train without dropout (the PPI model has none), so the
reference has none.

Loss head: the mean binary cross-entropy with logits over the graph's
nodes and labels (train_ppi.py:114).
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def f32():
    """Float32 products in float32: TF32 off for the reference's work,
    whatever the caller had set, and put back after."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    old = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = old


def layer(p: dict, x: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
          *, alpha: float, concat: bool) -> torch.Tensor:
    """One GAT layer of H heads: x [n, F_in] -> [n, H F_out] (``concat``)
    or [n, F_out] (the heads' mean)."""
    n = x.shape[0]
    w, a, skip = p["W"], p["a"], p["skip"]
    h, _, f_out = w.shape
    wh = torch.einsum("nf,hfo->nho", x, w)
    f_dst = (wh * a[None, :, :f_out]).sum(-1)  # [n, H]
    f_src = (wh * a[None, :, f_out:]).sum(-1)
    logit = F.leaky_relu(f_dst[dst] + f_src[src], alpha)  # [E, H]
    with torch.no_grad():
        top = torch.full((n, h), -math.inf, device=x.device).scatter_reduce(
            0, dst[:, None].expand(-1, h), logit, "amax")
    num = torch.exp(logit - top[dst])
    den = torch.zeros(n, h, device=x.device).index_add(0, dst, num)
    att = num / den[dst]
    out = torch.zeros(n, h, f_out, device=x.device).index_add(
        0, dst, att[:, :, None] * wh[src])
    if skip is not None:
        out = out + torch.einsum("nf,hfo->nho", x, skip)
    if concat:
        return F.elu(out).reshape(n, h * f_out)
    return out.mean(dim=1)


def forward(params: list, x, src, dst, *, alpha: float) -> torch.Tensor:
    """The layer stack: hidden layers concatenate their heads, the last
    averages them."""
    h = x
    last = len(params) - 1
    for i, p in enumerate(params):
        h = layer(p, h, src, dst, alpha=alpha, concat=i < last)
    return h


def bce(out: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The inductive loss: mean binary cross-entropy with logits."""
    return F.binary_cross_entropy_with_logits(out, y)


class Adam:
    """Adam with L2 weight decay added to the gradient (Kingma and Ba,
    arXiv:1412.6980; the optimiser of the authors' code): betas (0.9,
    0.999), eps 1e-8, bias correction. ``moments[i]`` is the first moment
    of leaf i."""

    def __init__(self, leaves: list, lr: float, weight_decay: float):
        self.leaves, self.lr, self.wd = leaves, lr, weight_decay
        self.b1, self.b2, self.eps = 0.9, 0.999, 1e-8
        self.moments = [torch.zeros_like(t) for t in leaves]
        self.seconds = [torch.zeros_like(t) for t in leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: list) -> None:
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.leaves, grads, self.moments, self.seconds):
            g = g + self.wd * p
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = v.sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(m, denom, value=-self.lr / c1)


def leaves(params: list) -> list:
    """The tensors of ``params`` in the port's order: layer by layer W,
    a, skip."""
    return [p[k] for p in params for k in ("W", "a", "skip")
            if p[k] is not None]
