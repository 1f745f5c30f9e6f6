"""Loss heads and metrics (port of ``pygat_tpu/train/metrics.py``).

* transductive head: ``log_softmax(elu(output))`` + NLL, including the
  reference's extra ELU on the final logits (train.py:151-152), and the
  argmax accuracy;
* inductive (PPI) head: mean BCE-with-logits over the real rows
  (train_ppi.py:114) and micro-F1 at the threshold logit > 0
  (train_ppi.py:106-110), computed on the device.
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


# -- the inductive (PPI) head: multi-label, train_ppi.py:106-114 ------------


def _row_mask(mask, like: torch.Tensor) -> torch.Tensor:
    """``mask`` ([N] or broadcastable to ``like``) as a float tensor, a
    1-D mask taken as one entry per row."""
    m = mask.to(like.dtype)
    return m[:, None] if m.dim() == 1 else m


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor,
                    mask=None) -> torch.Tensor:
    """nn.BCEWithLogitsLoss(reduction='mean') in its stable form,
    ``max(x, 0) - x y + log1p(exp(-|x|))``. ``mask`` (optional, [N] or
    broadcastable) restricts the mean to real (non-padding) rows; the
    reference has no padding, so its mean is over everything."""
    per = (logits.clamp(min=0.0) - logits * targets
           + torch.log1p(torch.exp(-logits.abs())))
    if mask is None:
        return per.mean()
    m = _row_mask(mask, per)
    weights = m * torch.ones_like(per)  # broadcast to the element count
    return (per * m).sum() / weights.sum().clamp(min=1.0)


def f1_counts(logits: torch.Tensor, targets: torch.Tensor, mask=None):
    """(tp, fp, fn) at the threshold logit > 0, over the rows ``mask``
    keeps; micro-F1 over a concatenation of batches equals micro-F1 of the
    summed counts (the test split's, train_ppi.py:155-174)."""
    preds = (logits > 0).to(torch.float32)
    t = targets.to(torch.float32)
    if mask is not None:
        m = _row_mask(mask, preds)
        preds = preds * m
        t = t * m
    tp = (preds * t).sum()
    fp = (preds * (1 - t)).sum()
    fn = ((1 - preds) * t).sum()
    return tp, fp, fn


def micro_f1(logits: torch.Tensor, targets: torch.Tensor,
             mask=None) -> torch.Tensor:
    """Micro-averaged F1 at the threshold logit > 0 (train_ppi.py:107)."""
    tp, fp, fn = f1_counts(logits, targets, mask)
    return 2 * tp / (2 * tp + fp + fn).clamp(min=1.0)
