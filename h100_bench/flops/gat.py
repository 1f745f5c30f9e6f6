"""The floating-point operations a GAT epoch needs, on the real nodes and
edges at the published widths (the work the model defines, not what the
program pads or repeats).

A layer of H heads, F_in inputs and F_out outputs, over n nodes and e
edges (self-loops included), forward:

* projection ``x W``: 2 n F_in H F_out; skip projection (where the model
  has one) as much again;
* the two logit terms ``wh . a``: 2 x 2 n H F_out;
* per edge and head: the sum of the terms, LeakyReLU, the shift, exp and
  the softmax sum: 5 e H;
* aggregation ``sum_j alpha_ij wh_j``: 2 e H F_out; normalisation n H F_out;
* ELU of a hidden layer, or the head mean of the last: n H F_out.

Backward: each product twice over (the weight gradient, and the input's
gradient except in the first layer, whose input needs none), every other
term twice its forward. Dropout's masks and scaling, the loss head and
Adam's update are not counted (under 0.1 % of a step at these widths).
"""

from __future__ import annotations


def layer_forward(n: int, e: int, f_in: int, f_out: int, h: int,
                  skip: bool) -> tuple[float, float]:
    """(products, everything else) of one layer's forward."""
    products = 2.0 * n * f_in * h * f_out * (2 if skip else 1)
    rest = (4.0 * n * h * f_out + 5.0 * e * h + 2.0 * e * h * f_out
            + 2.0 * n * h * f_out)
    return products, rest


def epoch_flops(model: dict, shapes: dict) -> float:
    """FLOPs of one epoch: every pass of ``shapes['passes']`` forward, and
    the training passes' backward."""
    total = 0.0
    skip = bool(model.get("skip"))
    for ps in shapes["passes"]:
        for i, lay in enumerate(shapes["layers"]):
            prod, rest = layer_forward(ps["n_real"], ps["e_real"], lay["f_in"],
                                       lay["f_out"], lay["heads"], skip)
            total += prod + rest
            if ps["train"]:
                total += prod * (1 if i == 0 else 2) + 2 * rest
    return total
