"""The reference's first epochs of an inductive (PPI) cell: the same
initial weights and graphs as the program's, each epoch's train graphs in
the order the program's loop draws (``np.random.default_rng(order seed +
epoch)`` shuffles them, batches take them in turn, a last short batch is
filled with the first graphs, which count for nothing), one Adam step a
batch on the batch's graphs side by side, then the validation graphs'
mean loss.

Under data parallelism over D ranks (the configuration's
``deployment.data_parallel``) a step takes D consecutive batches, the last
step's missing ones filled with the first batches at weight 0, and
descends the weighted mean of their losses: what D ranks each computing
one batch and summing their weighted gradients make."""

from __future__ import annotations

import numpy as np
import torch

from h100_bench.reference import gat
from h100_bench.seeds import derive
from h100_bench.weights import init_weights


def _batch(graphs: list, members, in_width: int, device):
    xs, ys, ss, rs = [], [], [], []
    off = 0
    for g in (graphs[i] for i in members):
        x = np.zeros((g["num_nodes"], in_width), np.float32)
        x[:, :g["features"].shape[1]] = g["features"]
        xs.append(x)
        ys.append(g["labels"])
        ss.append(g["senders"] + off)
        rs.append(g["receivers"] + off)
        off += g["num_nodes"]
    cat = lambda parts: torch.from_numpy(np.concatenate(parts)).to(device)  # noqa: E731
    return cat(xs), cat(ys), cat(ss), cat(rs)


def supersteps(n_batches: int, d: int) -> list:
    """(batch ids, weights) of each step of D batches."""
    ids = np.arange(-(-n_batches // d) * d)
    return list(zip((ids % n_batches).reshape(-1, d),
                    (ids < n_batches).astype(float).reshape(-1, d)))


def order(seed: int, epoch: int, n_graphs: int) -> np.ndarray:
    """The train graphs' order in ``epoch`` (the loop's own rule)."""
    o = np.arange(n_graphs)
    np.random.default_rng(derive(seed, "order") + epoch).shuffle(o)
    return o


def follow(*args) -> dict:
    """:func:`_follow` with TF32 off."""
    with gat.f32():
        return _follow(*args)


def _follow(config: dict, cell: dict, data: dict, seed: int, device,
           steps: int) -> dict:
    """Readings after each of ``steps`` epochs: each epoch's mean train
    loss (``train_loss``) and validation loss (``val_loss``), Adam's first
    moment of each leaf after the first epoch's steps (``moment``), and
    each leaf's change after the last (``change``). The features sit in
    the cell's ``input_columns`` columns, as the program feeds them."""
    model = config["model"]
    in_width = int(cell["input_columns"])
    if float(model["dropout"]) > 0.0:
        raise ValueError("the inductive reference runs without dropout")
    alpha, b = float(model["alpha"]), int(model["batch_size"])
    params = init_weights(model, seed, device, in_width)
    start = [t.detach().clone() for t in gat.leaves(params)]
    for t in gat.leaves(params):
        t.requires_grad_()
    opt = gat.Adam(gat.leaves(params), float(model["lr"]),
                   float(model["weight_decay"]))
    train, valid = data["train"], data["valid"]
    d = int(config.get("deployment", {}).get("data_parallel", 1))
    out = {"train_loss": [], "val_loss": []}
    for e in range(steps):
        o = order(seed, e, len(train))
        # the short batch's fillers count for nothing
        batches = [o[lo:lo + b] for lo in range(0, len(train), b)]
        losses = []
        for ids, weights in supersteps(len(batches), d):
            wsum = max(float(weights.sum()), 1.0)
            loss = 0.0
            for j, w in zip(ids, weights):
                x, y, s, r = _batch(train, batches[j], in_width, device)
                loss = loss + gat.bce(gat.forward(
                    params, x, s, r, alpha=alpha), y) * (w / wsum)
            opt.step(torch.autograd.grad(loss, gat.leaves(params)))
            losses.append(loss.item())
        if e == 0:
            out["moment"] = [m.cpu().clone() for m in opt.moments]
        vals = []
        with torch.no_grad():
            for lo in range(0, len(valid), b):
                x, y, s, r = _batch(valid, range(lo, min(lo + b, len(valid))),
                                    in_width, device)
                vals.append(float(gat.bce(gat.forward(
                    params, x, s, r, alpha=alpha), y)))
        out["train_loss"].append(float(np.mean(losses)))
        out["val_loss"].append(float(np.mean(vals)))
    out["change"] = [(t.detach() - s).cpu()
                     for t, s in zip(gat.leaves(params), start)]
    return out
