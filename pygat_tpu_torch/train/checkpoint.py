"""Checkpointing with the reference's keep-best rotation policy (port of
``pygat_tpu/train/checkpoint.py``).

The reference saves ``{epoch}_{dataset}.pkl`` every epoch, deletes files
older than the current best each epoch, deletes newer-than-best at the end,
and restores the best for testing (train.py:198-233).

Format, as in the JAX package: one pickle-free ``{epoch}_{tag}.ckpt.npz``
per checkpoint with the state's tensors stored by index plus a small JSON
header. The leaves are the parameters, Adam's per-parameter state and the
dropout generator's state; the header carries the step counter. Restoring
needs a template state with the same structure (always available from
``init_state``) and writes into it in place.
"""

from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from pygat_tpu_torch.models.gat import parameters
from pygat_tpu_torch.train.state import TrainState, tensor_leaves

_FNAME = re.compile(r"^(\d+)_(.+)\.ckpt\.npz$")


def _path(ckpt_dir: str, epoch: int, tag: str) -> str:
    return os.path.join(ckpt_dir, f"{epoch}_{tag}.ckpt.npz")


def save(ckpt_dir: str, epoch: int, tag: str, state: TrainState,
         extra: dict | None = None, params=None) -> str:
    """Write ``{epoch}_{tag}.ckpt.npz``. ``params`` stores another parameter
    set of the same structure in place of the state's (the fast loop's best
    model, kept beside the running one)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    leaves = tensor_leaves(state, params)
    payload = {f"leaf_{i}": t.detach().cpu().numpy()
               for i, t in enumerate(leaves)}
    payload["generator"] = state.generator.get_state().numpy()
    header = json.dumps({"epoch": epoch, "tag": tag, "n_leaves": len(leaves),
                         "step": state.step, **(extra or {})})
    payload["header"] = np.frombuffer(header.encode(), dtype=np.uint8)
    path = _path(ckpt_dir, epoch, tag)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
    os.replace(tmp, path)  # atomic publish
    return path


def _load_leaves(z, leaves: list[torch.Tensor], select=None) -> None:
    """Copy ``leaf_0 .. leaf_{n-1}`` of an open checkpoint into ``leaves``
    (in place), after checking every shape; ``select(i, array)`` (when
    given) takes the part of leaf ``i`` that its template holds."""
    arrays = [z[f"leaf_{i}"] for i in range(len(leaves))]
    if select is not None:
        arrays = [select(i, a) for i, a in enumerate(arrays)]
    for i, (old, arr) in enumerate(zip(leaves, arrays)):
        if tuple(arr.shape) != tuple(old.shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != template {tuple(old.shape)}")
    with torch.no_grad():
        for old, arr in zip(leaves, arrays):
            old.copy_(torch.from_numpy(arr))


def restore(path: str, like: TrainState, select=None
            ) -> tuple[TrainState, dict]:
    """Load into ``like`` (in place); returns (state, header). ``select``:
    as :func:`_load_leaves` (a model rank's heads of a whole checkpoint).
    The generator's state goes into ``like``'s generator, or its shared
    one under a model axis."""
    with np.load(path) as z:
        header = json.loads(bytes(z["header"]).decode())
        leaves = tensor_leaves(like)
        if header["n_leaves"] != len(leaves):
            raise ValueError(
                f"checkpoint has {header['n_leaves']} leaves, template has {len(leaves)}"
            )
        _load_leaves(z, leaves, select)
        gen = getattr(like.generator, "shared", like.generator)
        gen.set_state(torch.from_numpy(z["generator"].copy()))
    like.step = int(header["step"])
    return like, header


def restore_params(path: str, into, select=None) -> None:
    """Load only the parameter leaves of a checkpoint (they come first) into
    the parameter set ``into`` (in place); optimizer state and generator are
    left alone. ``select``: as :func:`_load_leaves`."""
    with np.load(path) as z:
        _load_leaves(z, parameters(into), select)


def list_checkpoints(ckpt_dir: str, tag: str) -> list[tuple[int, str]]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        m = _FNAME.match(name)
        if m and m.group(2) == tag:
            out.append((int(m.group(1)), os.path.join(ckpt_dir, name)))
    return sorted(out)


def latest(ckpt_dir: str, tag: str) -> tuple[int, str] | None:
    """(epoch, path) of the newest checkpoint for ``tag``, or None."""
    cks = list_checkpoints(ckpt_dir, tag)
    return cks[-1] if cks else None


def rotate_below_best(ckpt_dir: str, tag: str, best_epoch: int) -> None:
    """Per-epoch rotation: drop checkpoints older than best (train.py:213-217)."""
    for epoch, path in list_checkpoints(ckpt_dir, tag):
        if epoch < best_epoch:
            os.remove(path)


def rotate_above_best(
    ckpt_dir: str, tag: str, best_epoch: int, keep_epoch: int | None = None
) -> None:
    """Final rotation: drop checkpoints newer than best (train.py:220-224).

    ``keep_epoch`` (the run's final epoch) survives alongside the best one so
    a later resume is a true continuation rather than a replay of all
    post-best epochs from the best checkpoint.
    """
    for epoch, path in list_checkpoints(ckpt_dir, tag):
        if epoch > best_epoch and epoch != keep_epoch:
            os.remove(path)


def rotate_except(ckpt_dir: str, tag: str, keep_epoch: int) -> None:
    """Drop every checkpoint of ``tag`` but ``keep_epoch``'s (the fast loop's
    one ``{tag}-best`` file)."""
    for epoch, path in list_checkpoints(ckpt_dir, tag):
        if epoch != keep_epoch:
            os.remove(path)


def best_path(ckpt_dir: str, tag: str, best_epoch: int) -> str:
    return _path(ckpt_dir, best_epoch, tag)
