"""Optimizer (port of ``hairci/train/optim.py``): Adam(W) with weight decay
on every parameter except biases and 1-D parameters (BN scales and biases),
after clipping by global norm in the optax form.

As optax does, the optimizer holds every parameter, also those that take
no gradient (a ViT's fixed position table, its unused mask token): the step
gives them zero gradients (``fill_missing_grads_``), so they still decay and
their Adam moments still shrink.

Under data parallelism ``all_reduce_grads_`` averages the gradients over
the ranks right after ``backward()``, before ``fill_missing_grads_`` and the
clip, so the clip sees the global gradient, as under JAX's sharding; every
rank then takes the same step and the parameters stay equal bit for bit.
The model is not wrapped in DDP."""

from __future__ import annotations

from typing import Iterable, Optional

import torch
from torch import nn

from hairci_torch.parallel import collectives


def decays(name: str, p: torch.Tensor) -> bool:
    """True where weight decay applies (``decay_mask``)."""
    return not (name.split(".")[-1] == "bias" or p.dim() <= 1)


def make_optimizer(module: nn.Module, learning_rate: float,
                   weight_decay: float = 0.0,
                   betas=(0.9, 0.999)) -> torch.optim.Optimizer:
    """``optax.adamw(mask=decay_mask)`` or ``optax.adam``: decoupled decay,
    eps 1e-8 outside the square root."""
    named = list(module.named_parameters())
    groups = [{"params": [p for n, p in named if decays(n, p)],
               "weight_decay": weight_decay or 0.0},
              {"params": [p for n, p in named if not decays(n, p)],
               "weight_decay": 0.0}]
    return torch.optim.AdamW(groups, lr=learning_rate, betas=tuple(betas),
                             eps=1e-8)


def all_reduce_grads_(optimizer: torch.optim.Optimizer) -> None:
    """The mean over the ranks of every gradient of ``optimizer``, in one
    coalesced all-reduce (nothing without a process group). A loss that
    every rank computes from gathered rows gives each rank W times its
    share of the gradient (``parallel.collectives``); the mean makes it the
    global loss's gradient."""
    collectives.all_reduce_mean_(
        [p.grad for group in optimizer.param_groups for p in group["params"]
         if p.grad is not None])


@torch.no_grad()
def fill_missing_grads_(optimizer: torch.optim.Optimizer) -> None:
    """A zero gradient for every parameter of ``optimizer`` that has none:
    ``torch.optim.AdamW`` skips such a parameter, optax updates it."""
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)


@torch.no_grad()
def clip_grad_global_norm_(params: Iterable[torch.Tensor],
                           max_norm: float) -> Optional[torch.Tensor]:
    """``optax.clip_by_global_norm``: g <- (g / |g|) * max_norm when
    |g| >= max_norm, with no eps added to the norm (unlike
    ``torch.nn.utils.clip_grad_norm_``). Returns |g|; never waits for the
    card."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return None
    norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
    keep = norm < max_norm
    one = torch.ones_like(norm)
    div = torch.where(keep, one, norm)
    mul = torch.where(keep, one, torch.full_like(norm, max_norm))
    for g in grads:
        g.div_(div.to(g.dtype)).mul_(mul.to(g.dtype))
    return norm
