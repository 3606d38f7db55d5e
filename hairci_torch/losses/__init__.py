"""Losses (port of hairci.losses)."""

from hairci_torch.losses.recon import (
    masked_l1_loss,
    masked_mse_loss,
    patchify,
    unigrad_loss,
    unpatchify,
)

__all__ = ["masked_l1_loss", "masked_mse_loss", "patchify", "unigrad_loss",
           "unpatchify"]
