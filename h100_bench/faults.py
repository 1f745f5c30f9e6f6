"""The control and the planted faults that ``correct`` has to catch, as
context managers around a session's set-up and first steps. The
benchmark's own runs use none of them; ``readings.py`` reads each on the
card at a cell's size, and the CPU tests drive a whole run under each.

* ``tf32``: the control, the program's own next precision down: float32
  matrix products in TF32 (the configurations state float32 with TF32
  off);
* ``frozen``: a step that leaves the state as it was (Adam's step does
  nothing);
* ``half``: half of the batch left out, the mean taken over the rest (the
  loss over the first half of the batch's rows, its first graph);
* ``altered``: an answer altered where it is produced (the model's output
  shifted by 1 in its first column);
* ``exchange``: the exchange between cards left out (each rank steps on
  its own batch's gradient; data-parallel cells only).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name: str, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


@contextlib.contextmanager
def planted(mode: str):
    """The program as ``mode`` breaks it (``sound``: as it is)."""
    from pygat_tpu_torch.train import inductive

    with contextlib.ExitStack() as stack:
        if mode == "tf32":
            old = (torch.backends.cuda.matmul.allow_tf32,
                   torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            stack.callback(_restore_tf32, old)
        elif mode == "frozen":
            stack.enter_context(_patched(torch.optim.Adam, "step",
                                         lambda self, closure=None: None))
        elif mode == "half":
            bce = inductive.bce_with_logits

            def half_bce(logits, targets, mask=None):
                mask = mask.clone()
                mask[mask.shape[0] // 2:] = False
                return bce(logits, targets, mask=mask)

            stack.enter_context(_patched(inductive, "bce_with_logits",
                                         half_bce))
        elif mode == "altered":
            stack.enter_context(_patched(inductive, "apply_gat",
                                         _shifted(inductive.apply_gat)))
        elif mode == "exchange":
            stack.enter_context(_patched(inductive, "all_reduce_grads",
                                         lambda params, group=None: None))
        elif mode != "sound":
            raise ValueError(f"unknown mode {mode!r}")
        yield


def _restore_tf32(old) -> None:
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _shifted(apply_gat):
    def shifted(*args, **kwargs):
        out = apply_gat(*args, **kwargs)
        shift = torch.zeros_like(out)
        shift[:, 0] = 1.0
        return out + shift

    return shifted
