"""Evaluators: outputs + labels -> loss and metrics
(port of ``znicz_tpu/nn/evaluator.py``).

Every function takes a float ``mask`` [batch] so the padded last minibatch
of an epoch counts only its valid rows.  The metrics stay tensors on the
device; the workflow folds them into its epoch accumulator there.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


def _norm_mask(mask: Optional[torch.Tensor], batch: int, device):
    if mask is None:
        return torch.ones((batch,), dtype=torch.float32, device=device), float(batch)
    mask = mask.float()
    return mask, torch.clamp_min(mask.sum(), 1.0)


def softmax(
    logits: torch.Tensor,
    labels: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
    n_classes: Optional[int] = None,
    compute_confusion: bool = False,
) -> Dict[str, torch.Tensor]:
    """Cross-entropy over integer labels: ``loss`` (masked mean),
    ``n_err`` (misclassified count), ``n_samples`` and ``max_err_y_sum``
    (largest ``sum |p - onehot|`` over the valid rows); with
    ``compute_confusion``, ``confusion``: the int32 ``[n_classes,
    n_classes]`` counts of the valid rows, rows the truth and columns the
    prediction, summed on the device by an integer ``index_add_`` (exact in
    any order)."""
    mask, n_valid = _norm_mask(mask, logits.shape[0], logits.device)
    labels = labels.long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(1, labels[:, None])[:, 0]
    loss = torch.sum(nll * mask) / n_valid
    pred = torch.argmax(logits, dim=1)
    err = (pred != labels).float() * mask
    p = torch.exp(logp)
    onehot = torch.zeros_like(p).scatter_(1, labels[:, None], 1.0)
    out = {
        "loss": loss,
        "n_err": torch.sum(err).to(torch.int32),
        "n_samples": n_valid,
        "max_err_y_sum": torch.max(torch.sum(torch.abs(p - onehot), dim=1) * mask),
    }
    if compute_confusion:
        nc = n_classes or logits.shape[-1]
        flat = labels * nc + pred
        out["confusion"] = torch.zeros(
            (nc * nc,), dtype=torch.int32, device=logits.device
        ).index_add_(0, flat, mask.to(torch.int32)).reshape(nc, nc)
    return out


def mse(
    output: torch.Tensor,
    target: torch.Tensor,
    *,
    mask: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Mean-squared error: ``loss`` (masked mean of per-sample mean
    squares), ``max_diff`` and ``n_samples``.  Both sides are flattened
    first, so a flat output compares with a spatial target."""
    mask, n_valid = _norm_mask(mask, output.shape[0], output.device)
    diff = output.reshape(output.shape[0], -1) - target.reshape(
        target.shape[0], -1
    )
    per_sample = torch.mean(torch.square(diff), dim=1)
    return {
        "loss": torch.sum(per_sample * mask) / n_valid,
        "max_diff": torch.max(torch.amax(torch.abs(diff), dim=1) * mask),
        "n_samples": n_valid,
    }
