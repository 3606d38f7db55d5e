"""Train state (port of ``hairci/train/state.py``).

The JAX pytree becomes one mutable object: the online module, the
optimizer, the step count and, where the recipe has them, the EMA teacher
copy (SHAM, DINOv2, MSN, BYOL, DenseCL, SiameseIM, SHAM v1), the
mined-negative cache (SHAM)
and ``extra`` tensors (DINOv2's DINO and iBOT centres, DenseCL's memory
banks and their pointers).
The port updates it in place (the JAX step returns a new state), which keeps
one copy of the weights and optimizer moments on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    online: nn.Module
    optimizer: torch.optim.Optimizer
    ema: Optional[nn.Module] = None
    # staged hard-negative cache: (num_batches, B) neighbour indices
    neg_indices: Optional[torch.Tensor] = None
    step: int = 0
    # recipe-specific tensors carried from step to step (DINOv2's centres,
    # DenseCL's banks)
    extra: Optional[Dict[str, torch.Tensor]] = None


@torch.no_grad()
def ema_update(ema: nn.Module, online: nn.Module, momentum: float) -> None:
    """ema <- ema * m + online * (1 - m), over the parameters AND the BN
    buffers, the token-axis PermuteBNs' too (lightly ``update_momentum``;
    ``ema_update`` of both trees)."""
    e = list(ema.parameters()) + list(ema.buffers())
    o = list(online.parameters()) + list(online.buffers())
    # multi-tensor ops: a few launches for the whole model, not three each
    torch._foreach_mul_(e, momentum)
    torch._foreach_add_(e, torch._foreach_mul(o, 1.0 - momentum))
