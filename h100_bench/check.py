"""The comparison that decides ``correct``: the program's first steps
against the plain reference's, on the same inputs.

Four numbers, each held to its own limit (the cell file's ``limits``):

* ``loss_gap``: the largest relative gap between the two sides' training
  loss, over the steps followed;
* ``val_loss_gap``: the same for the validation loss after each step (the
  forward without dropout);
* ``grad_gap``: the gradient as the optimiser got it, by Adam's first
  moment after the first step (after the first epoch's steps in an
  inductive cell): by the worst leaf, the gap between the two sides' norms
  of the leaf over the larger of the reference's norm of that leaf and of
  the median leaf;
* ``update_gap``: each parameter's change after the last step, taken the
  same way, over the leaves whose first moment in the reference is at
  least a thousandth of the median leaf's (a leaf whose gradient is zero
  to rounding moves under Adam by round-off alone).

A leaf is one layer's ``W``, ``skip``, or one half of its ``a``: the
receiver half, whose gradient is zero under each receiver's softmax, and
the sender half.
"""

from __future__ import annotations

import math
import sys

import torch

NUMBERS = ("loss_gap", "val_loss_gap", "grad_gap", "update_gap")
LEAF_FLOOR = 1e-3


def split_leaves(tensors: list, has_skip: bool) -> list:
    """The per-layer leaves (W, a, skip) with ``a`` cut into its halves."""
    out = []
    per = 3 if has_skip else 2
    for i in range(0, len(tensors), per):
        w, a = tensors[i], tensors[i + 1]
        half = a.shape[-1] // 2
        out += [w, a[..., :half], a[..., half:]]
        if has_skip:
            out.append(tensors[i + 2])
    return out


def _rel(p: float, r: float) -> float:
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf
    return abs(p - r) / max(abs(r), 1e-30)


def _norms(leaves: list) -> list[float]:
    return [float(torch.linalg.vector_norm(t.double())) for t in leaves]


def leaf_gap(prog: list, ref: list, keep: list[bool] | None = None) -> float:
    """The worst kept leaf's gap of norms over the larger of its reference
    norm and the median kept leaf's."""
    keep = keep or [True] * len(ref)
    p_n = [v for v, k in zip(_norms(prog), keep) if k]
    r_n = [v for v, k in zip(_norms(ref), keep) if k]
    if not r_n or not all(map(math.isfinite, p_n)):
        return math.inf
    med = sorted(r_n)[len(r_n) // 2]
    return max(abs(p - r) / max(r, med, 1e-30) for p, r in zip(p_n, r_n))


def numbers(prog: dict, ref: dict, has_skip: bool) -> dict:
    """The four numbers of the module docstring."""
    m_p = split_leaves(prog["moment"], has_skip)
    m_r = split_leaves(ref["moment"], has_skip)
    r_norms = _norms(m_r)
    med = sorted(r_norms)[len(r_norms) // 2]
    keep = [v >= LEAF_FLOOR * med for v in r_norms]
    return {
        "loss_gap": max(_rel(p, r) for p, r in zip(prog["train_loss"],
                                                   ref["train_loss"])),
        "val_loss_gap": max(_rel(p, r) for p, r in zip(prog["val_loss"],
                                                       ref["val_loss"])),
        "grad_gap": leaf_gap(m_p, m_r),
        "update_gap": leaf_gap(split_leaves(prog["change"], has_skip),
                               split_leaves(ref["change"], has_skip), keep),
    }


def judge(values: dict, limits: dict, out=sys.stderr) -> tuple[bool, dict]:
    """(every number within its limit, ``{name: {value, limit}}``); prints
    each number beside its limit, one a line, on ``out``."""
    table = {}
    ok = True
    for name in NUMBERS:
        v, lim = values[name], float(limits[name])
        held = math.isfinite(v) and v <= lim
        ok &= held
        table[name] = {"value": v, "limit": lim}
        print(f"check {name} {v!r} limit {lim!r} "
              f"{'held' if held else 'FAILED'}", file=out)
    return ok, table
