"""Loss head and accuracy (port of the transductive half of
``pygat_tpu/train/metrics.py``).

The transductive head is ``log_softmax(elu(output))`` + NLL, including the
reference's extra ELU on the final logits (train.py:151-152).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def log_logits(output: torch.Tensor) -> torch.Tensor:
    """Reference compute_log_logits (train.py:151-152)."""
    return F.log_softmax(F.elu(output), dim=1)


def nll_loss(log_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """F.nll_loss: mean negative log-probability of the true class."""
    return -log_probs.gather(1, labels.long()[:, None]).mean()


def accuracy(output: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    preds = output.argmax(dim=1)
    return (preds == labels.long()).float().mean()
