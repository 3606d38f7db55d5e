"""DualViewHair losses (port of ``hairci/experiments/dualview/losses.py``):
the symmetric 2B x 2B NT-Xent, the weighted student->teacher /
teacher->student InfoNCE, and the 4096-negative ``MomentumQueue`` as a ring
buffer whose bank and pointer the caller carries (on the device, outside
the train state and its checkpoint, as in JAX)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from hairci_torch.eval.features import l2_normalize
from hairci_torch.losses.contrastive import nt_xent_loss
from hairci_torch.losses.dense import memory_bank_infonce, update_memory_bank


def ntxent_loss_symmetric(z_s: torch.Tensor, z_t: torch.Tensor,
                          temperature: float = 0.07) -> torch.Tensor:
    """Symmetric 2B x 2B NT-Xent (the reference's ``ntxent_loss.py:10-57``)."""
    return nt_xent_loss(z_s, z_t, temperature)


def asymmetric_ntxent_loss(z_s: torch.Tensor, z_t: torch.Tensor,
                           temperature: float = 0.07,
                           weight_s2t: float = 0.7) -> torch.Tensor:
    """``weight_s2t`` x the student->teacher InfoNCE + the rest x the
    teacher->student one, the positives on the diagonal."""
    s, t = l2_normalize(z_s.float()), l2_normalize(z_t.float())
    logits_st = (s @ t.T) / temperature
    labels = torch.arange(s.shape[0], device=s.device)
    return (weight_s2t * F.cross_entropy(logits_st, labels)
            + (1.0 - weight_s2t) * F.cross_entropy(logits_st.T, labels))


class MomentumQueue:
    """The reference's 4096-negative feature queue
    (``train_with_queue.py:17-53``): ``init`` makes the (size, dim) f32 bank
    of zeros and a 0-d int64 pointer on ``device``; ``enqueue`` writes a
    batch of keys at the pointer (``losses.dense.update_memory_bank``), and
    ``loss`` is the InfoNCE of each query against its key and the bank
    (``memory_bank_infonce``)."""

    def __init__(self, dim: int, size: int = 4096):
        self.dim = dim
        self.size = size

    def init(self, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
        return (torch.zeros(self.size, self.dim, device=device),
                torch.zeros((), dtype=torch.int64, device=device))

    def enqueue(self, bank: torch.Tensor, ptr: torch.Tensor,
                keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return update_memory_bank(bank, ptr, keys)

    def loss(self, query: torch.Tensor, key: torch.Tensor, bank: torch.Tensor,
             temperature: float = 0.07) -> torch.Tensor:
        return memory_bank_infonce(query, key, bank, temperature)
