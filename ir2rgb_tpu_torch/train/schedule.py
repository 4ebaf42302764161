"""Learning-rate schedule and coarse-to-fine parameter gating — the port
of ``ir2rgb_tpu/train/schedule.py``.

Both are functions of the step counter, as in the JAX package: the
schedule gives the lr to set before each optimizer step, and the gate
zeroes the global trunk's gradients while it is frozen.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Tuple

import torch

# the JAX package's "global" parameter group: the LocalEnhancer's trunk,
# whose state_dict keys are the reference's model.*; the enhancers are
# model{n}_*
GLOBAL_PREFIX = "model."


def linear_decay_schedule(lr: float, niter: int, niter_decay: int,
                          steps_per_epoch: int) -> Callable[[int], float]:
    """Constant for ``niter`` epochs, then the reference's per-epoch
    staircase to 0: ``lr * (1 - max(0, e - niter) / niter_decay)`` at
    0-based epoch e."""

    def schedule(step: int) -> float:
        epoch = step // steps_per_epoch
        frac = 1.0 - max(epoch - niter, 0) / max(niter_decay, 1)
        return lr * min(max(frac, 0.0), 1.0)

    return schedule


def lr_schedule(policy: str, lr: float, niter: int, niter_decay: int,
                steps_per_epoch: int,
                lr_decay_iters: int = 50) -> Callable[[int], float]:
    """The family's ``--lr_policy``: ``linear`` (above), ``step``
    (lr * 0.1^(epoch // lr_decay_iters)) or ``cosine``
    (0.5 lr (1 + cos(pi epoch / niter)), periodic like torch's
    CosineAnnealingLR with T_max = niter)."""
    if policy == "linear":
        return linear_decay_schedule(lr, niter, niter_decay,
                                     steps_per_epoch)
    if policy == "step":
        return lambda step: lr * 0.1 ** (
            (step // steps_per_epoch) // lr_decay_iters)
    if policy == "cosine":
        t_max = max(niter, 1)
        return lambda step: 0.5 * lr * (1.0 + math.cos(
            math.pi * (step // steps_per_epoch) / t_max))
    raise ValueError(f"unknown lr_policy: {policy}")


def global_freeze_mask(fix_steps: int) -> Callable[
        [Iterable[Tuple[str, torch.nn.Parameter]], int], None]:
    """gate(named G parameters, step): while ``step < fix_steps`` the
    global trunk's grads (``model.*``) become zero tensors, in place; the
    enhancers keep theirs. Zero grads leave the trunk's Adam moments at
    zero, so it does not move; the train step also clears G's Adam state
    at ``step == fix_steps``, which together is the reference's fresh
    optimizer at the unfreeze."""

    def gate(named_params, step: int) -> None:
        if step >= fix_steps:
            return
        for k, p in named_params:
            if k.startswith(GLOBAL_PREFIX):
                p.grad = torch.zeros_like(p)

    return gate
