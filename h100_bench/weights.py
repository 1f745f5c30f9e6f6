"""The initial weights of a configuration, made from the seed on the
device: the GAT paper's initialisation (Glorot, "xavier", with the gain
1.414 of the authors' code), normal for the sparse layers' ``W`` and
``a``, uniform for the skip projections, one draw per leaf from one
``torch.Generator`` on the device. Both the program and the reference are
handed these weights: the benchmark makes them, neither side does.

A leaf is laid out as the port stores a layer's heads: ``W`` [H, F_in,
F_out], ``a`` [H, 2 F_out] (receiver half, then sender half), ``skip``
[H, F_in, F_out]. ``in_width`` pads layer 0's input rows to the width the
program feeds (PPI's 50 features sit in 128 columns): the padding rows are
zero, so the model is the published one."""

from __future__ import annotations

import math

import torch

from h100_bench.seeds import derive

GAIN = 1.414


def layer_shapes(model: dict) -> list[tuple[int, int, int]]:
    """(F_in, F_out, H) of each layer: layer i takes ``widths[i]`` inputs
    per head of the previous layer."""
    heads, widths = model["heads"], model["widths"]
    prev = [1] + list(heads)
    return [(widths[i] * prev[i], widths[i + 1], heads[i])
            for i in range(len(heads))]


def layers(model: dict) -> list[dict]:
    """Each layer's published input width, output width and heads."""
    return [dict(f_in=f_in, f_out=f_out, heads=h)
            for f_in, f_out, h in layer_shapes(model)]


def init_weights(model: dict, seed: int, device, in_width: int | None = None
                 ) -> list[dict]:
    """``[{'W', 'a', 'skip'}]`` per layer (``skip`` None without skip
    connections), float32 on ``device``, from ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(derive(seed, "weights"))
    out = []
    for i, (f_in, f_out, h) in enumerate(layer_shapes(model)):
        rows = in_width if (i == 0 and in_width) else f_in
        std_w = GAIN * math.sqrt(2.0 / (f_in + f_out))
        std_a = GAIN * math.sqrt(2.0 / (2 * f_out + 1))
        w = torch.randn((h, f_in, f_out), generator=gen, device=device) * std_w
        a = torch.randn((h, 2 * f_out), generator=gen, device=device) * std_a
        skip = None
        if model.get("skip"):
            b = GAIN * math.sqrt(6.0 / (f_in + f_out))
            skip = (torch.rand((h, f_in, f_out), generator=gen, device=device)
                    * (2 * b) - b)
        if rows > f_in:
            w = torch.nn.functional.pad(w, (0, 0, 0, rows - f_in))
            skip = None if skip is None else torch.nn.functional.pad(
                skip, (0, 0, 0, rows - f_in))
        out.append({"W": w, "a": a, "skip": skip})
    return out
