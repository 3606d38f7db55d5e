"""Dense / patch-level contrastive losses (port of ``hairci/losses/dense.py``).

  - ``dense_loss``: per-patch InfoNCE where every other patch-positive in
    the batch is a negative (the reference's ``DenseLoss``);
  - ``patch_contrastive_loss``: per-sample symmetric NT-Xent over a
    sample's patches, batched over B (``PatchContrastiveLoss``);
  - ``memory_bank_infonce``, ``update_memory_bank``: DenseCL's InfoNCE
    against a ring buffer of stale keys (lightly ``NTXentLoss`` with
    ``memory_bank_size``), the bank carried in the recipe's state;
  - ``select_most_similar``: DenseCL's local matching.

Every similarity is an f32 product, as ``preferred_element_type=f32`` makes
it in JAX. ``_normalize`` maps a zero row to zero (a fresh bank is zeros).

Under data parallelism (``parallel.collectives``) the losses the recipes
call are the global batch's, as under JAX's sharding:
``patch_contrastive_loss`` (SHAM v1) stays per sample and its mean is
global; ``memory_bank_infonce`` (DenseCL) is a global mean against the
bank, which every rank holds whole and writes with every rank's keys
(``ssl.densecl``). ``dense_loss``, which no recipe calls, is per rank.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from hairci_torch.parallel import collectives


def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) over the last axis: a zero row stays zero."""
    return F.normalize(x, dim=-1, eps=eps)


def _first_column_ce(logits: torch.Tensor) -> torch.Tensor:
    """-mean(log_softmax(logits, 1)[:, 0]): the positive is column 0."""
    return -torch.log_softmax(logits, dim=1)[:, 0].mean()


def dense_loss(anchor_tokens: torch.Tensor, pos_tokens: torch.Tensor,
               temperature: float = 0.1) -> torch.Tensor:
    """Queries: every anchor patch; its positive: the matching ``pos``
    patch; negatives: every ``pos`` patch of the batch but that one (no
    gradient through them). Tokens are used as given, not normalised."""
    B, K, D = anchor_tokens.shape
    q = anchor_tokens.reshape(B * K, D).float()
    k_pos = pos_tokens.reshape(B * K, D).float()
    pos = torch.sum(q * k_pos, dim=-1, keepdim=True)
    neg = q @ k_pos.detach().T
    eye = torch.eye(B * K, dtype=torch.bool, device=neg.device)
    neg = neg.masked_fill(eye, float("-inf"))
    return _first_column_ce(torch.cat([pos, neg], dim=1) / temperature)


def patch_contrastive_loss(patch_s: torch.Tensor, patch_t: torch.Tensor,
                           temperature: float = 0.5) -> torch.Tensor:
    """Per sample, symmetric NT-Xent over its 2N normalised patches: patch
    i's positive is i + N (mod 2N), every other patch of the same sample a
    negative."""
    B, N, D = patch_s.shape
    z = torch.cat([_normalize(patch_s), _normalize(patch_t)], dim=1).float()
    sim = torch.einsum("bnd,bmd->bnm", z, z) / temperature
    eye = torch.eye(2 * N, dtype=torch.bool, device=sim.device)
    sim = sim.masked_fill(eye, float("-inf"))
    pos = (torch.arange(2 * N, device=sim.device) + N) % (2 * N)
    logprob = torch.log_softmax(sim, dim=2)
    return -collectives.global_mean(
        logprob[:, torch.arange(2 * N, device=sim.device), pos])


def memory_bank_infonce(query: torch.Tensor, key: torch.Tensor,
                        bank: torch.Tensor,
                        temperature: float = 0.1) -> torch.Tensor:
    """MoCo-style InfoNCE: query (B, D), its positive key (B, D) and the
    negatives, the (M, D) bank; no gradient through key or bank."""
    q = _normalize(query.float())
    k = _normalize(key.detach().float())
    b = _normalize(bank.detach().float())
    pos = torch.sum(q * k, dim=-1, keepdim=True)
    neg = q @ b.T
    logits = torch.cat([pos, neg], dim=1) / temperature
    return -collectives.global_mean(torch.log_softmax(logits, dim=1)[:, 0])


def update_memory_bank(bank: torch.Tensor, ptr, keys: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ring-buffer enqueue of ``keys`` (B, D) at rows (ptr + i) % M of
    ``bank`` (M, D); returns (the new bank, (ptr + B) % M). ``ptr`` is an
    int or an integer tensor on the bank's device. B > M is refused: the
    rows would be written twice in an order JAX leaves undefined."""
    M, B = bank.shape[0], keys.shape[0]
    if B > M:
        raise ValueError(f"{B} keys do not fit a bank of {M} rows")
    idx = (ptr + torch.arange(B, device=bank.device)) % M
    new_bank = bank.index_copy(0, idx, keys.detach().to(bank.dtype))
    return new_bank, (ptr + B) % M


def select_most_similar(query_feats: torch.Tensor, key_feats: torch.Tensor,
                        key_local: torch.Tensor) -> torch.Tensor:
    """For each query position, the local embedding of the most similar key
    position (cosine of the (B, N, C) backbone grids; the first of equal
    maxima, as ``jnp.argmax``): key_local (B, N, D) -> (B, N, D)."""
    qn = _normalize(query_feats.float())
    kn = _normalize(key_feats.float())
    match = torch.einsum("bnc,bmc->bnm", qn, kn).argmax(dim=2)
    return torch.gather(key_local, 1, match[..., None].expand(
        -1, -1, key_local.shape[-1]))
