"""Learning-rate schedule, optimizer and gradient clipping.

The schedule is the closed form of HuggingFace's linear warmup then linear
decay to 0 at ``total_steps``, stepped once per optimizer update.  The
optimizer is Adam (AdamW when ``weight_decay > 0``) with the schedule as a
``LambdaLR``: the first update uses ``lr(0)``, which is 0 during warmup, as
optax evaluates a schedule at the count before its increment.
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable, List, Tuple

import torch


def warmup_decay_factor(step: int, warmup_steps: int, total_steps: int) -> float:
    """clip(min(step / warmup, (total − step) / (total − warmup)), 0, 1),
    each denominator at least 1."""
    warm = step / max(1.0, float(warmup_steps))
    decay = (float(total_steps) - step) / max(1.0, float(total_steps - warmup_steps))
    return min(max(min(warm, decay), 0.0), 1.0)


def linear_warmup_decay(base_lr: float, warmup_steps: int, total_steps: int
                        ) -> Callable[[int], float]:
    """lr(step) = base_lr · :func:`warmup_decay_factor`."""
    return lambda step: base_lr * warmup_decay_factor(step, warmup_steps, total_steps)


def make_optimizer(
    params: Iterable[torch.Tensor],
    base_lr: float = 1e-4,
    warmup_steps: int = 5000,
    total_steps: int = 100_000,
    weight_decay: float = 0.0,
) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
    """Adam (or AdamW) with β = (0.9, 0.999), ε = 1e-8 and the linear
    warmup-decay schedule as a ``LambdaLR`` stepped once per update."""
    params = list(params)
    if weight_decay and weight_decay > 0:
        opt: torch.optim.Optimizer = torch.optim.AdamW(
            params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay)
    else:
        opt = torch.optim.Adam(params, lr=base_lr, betas=(0.9, 0.999), eps=1e-8)
    factor = functools.partial(warmup_decay_factor, warmup_steps=warmup_steps,
                               total_steps=total_steps)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, factor)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """√(Σ ‖g‖²) over every gradient."""
    return torch.sqrt(sum(g.square().sum() for g in grads))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float) -> torch.Tensor:
    """optax's rule, in place: ``g · max_norm / ‖g‖`` when ``‖g‖ ≥ max_norm``
    (no ε added, unlike ``clip_grad_norm_``).  Returns the norm."""
    norm = global_norm(grads)
    if norm >= max_norm:
        for g in grads:
            g.div_(norm).mul_(max_norm)
    return norm
