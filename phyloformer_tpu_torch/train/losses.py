"""Losses and metrics for distance-vector training.

MAE (L1, the reference trainer's loss), MRE (the published checkpoints'
fine-tuning loss) and MSE, each mask-aware so that bucketed, padded batches
train exactly, and the validation metrics (MAE, MRE, RMSE).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

EPS = 1e-8


def _masked_mean(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return x.mean()
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp_min(1.0)


def mae_loss(preds, targets, mask=None):
    """Mean absolute error."""
    return _masked_mean((preds - targets).abs(), mask)


def mre_loss(preds, targets, mask=None):
    """Mean relative error |pred - true| / true."""
    return _masked_mean((preds - targets).abs() / (targets + EPS), mask)


def mse_loss(preds, targets, mask=None):
    return _masked_mean((preds - targets).square(), mask)


LOSSES: Dict[str, Callable] = {"mae": mae_loss, "l1": mae_loss, "mre": mre_loss, "mse": mse_loss}


def get_loss(name: str) -> Callable:
    try:
        return LOSSES[name.lower()]
    except KeyError as err:
        raise ValueError(f"unknown loss {name!r}; options: {sorted(LOSSES)}") from err


def metrics(preds, targets, mask=None) -> Dict[str, torch.Tensor]:
    """Validation metrics: MAE, MRE and RMSE."""
    return {
        "mae": mae_loss(preds, targets, mask),
        "mre": mre_loss(preds, targets, mask),
        "rmse": mse_loss(preds, targets, mask).sqrt(),
    }
