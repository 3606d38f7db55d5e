"""Losses (port of hairci.losses)."""

from hairci_torch.losses.dense import (
    dense_loss,
    memory_bank_infonce,
    patch_contrastive_loss,
    select_most_similar,
    update_memory_bank,
)
from hairci_torch.losses.distill import (
    dino_loss,
    distillation_loss,
    ibot_patch_loss,
    koleo_loss,
    msn_loss,
    negative_cosine_similarity,
)
from hairci_torch.losses.recon import (
    masked_l1_loss,
    masked_mse_loss,
    patchify,
    unigrad_loss,
    unpatchify,
)

__all__ = ["dense_loss", "dino_loss", "distillation_loss", "ibot_patch_loss",
           "koleo_loss", "masked_l1_loss", "masked_mse_loss",
           "memory_bank_infonce", "msn_loss", "negative_cosine_similarity",
           "patch_contrastive_loss", "patchify", "select_most_similar",
           "unigrad_loss", "unpatchify", "update_memory_bank"]
