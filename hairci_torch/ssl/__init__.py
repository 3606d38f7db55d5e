"""Self-supervised recipes (port of hairci.ssl): SHAM."""

from hairci_torch.ssl.base import RECIPES, build_recipe, register_recipe

__all__ = ["RECIPES", "build_recipe", "register_recipe"]
