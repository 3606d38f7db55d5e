"""Self-supervised recipes (port of hairci.ssl): SHAM, SimCLR (with the
S2R2 term), SupCon, MAE, SimMIM, DINOv2, MSN, BYOL, DenseCL, SiameseIM and
SHAM v1."""

from hairci_torch.ssl.base import RECIPES, build_recipe, register_recipe

__all__ = ["RECIPES", "build_recipe", "register_recipe"]
