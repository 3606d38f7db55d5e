"""Losses (port of hairci.losses)."""

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

__all__ = ["dino_loss", "distillation_loss", "ibot_patch_loss", "koleo_loss",
           "masked_l1_loss", "masked_mse_loss", "msn_loss",
           "negative_cosine_similarity", "patchify", "unigrad_loss",
           "unpatchify"]
