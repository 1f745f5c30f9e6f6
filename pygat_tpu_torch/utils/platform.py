"""Device resolution and seeded generators (port of
``pygat_tpu/utils/platform.py``).

Entry points run on CUDA unless the caller asks for the CPU. There is no
silent fallback: when CUDA is absent and the CPU was not requested,
:func:`resolve_device` raises. Under a launcher (``torchrun`` sets
``LOCAL_RANK``) each process takes its own card, ``cuda:LOCAL_RANK``.
"""

from __future__ import annotations

import os

import torch


def resolve_device(device: torch.device | str | None = None, *,
                   cpu: bool = False) -> torch.device:
    """The device an entry point runs on: ``device`` when the caller names
    one, else ``cpu`` when asked (``--no-cuda``), else ``cuda`` (under a
    launcher ``cuda:LOCAL_RANK``)."""
    if device is not None:
        return torch.device(device)
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass --no-cuda (or device='cpu') to run "
            "on the CPU")
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda")


def make_generator(device: torch.device | str, seed: int) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return gen
