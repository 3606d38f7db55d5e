"""SSL recipe registry (port of ``hairci/ssl/base.py``).

A recipe owns its modules and exposes ``create_state``, ``train_step`` and
``extract_features``; ``build_recipe`` is keyed on the reference ``--mode``
strings. Ported: ``SHAM``, ``simclr``, ``simclr_supcon``, ``mae``,
``simMIM``, ``dinov2``, ``MSN``, ``BYOL``, ``DenseCL``, ``siameseim`` and
``SHAM_v1`` (the last reached through this registry only, as in JAX).
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from hairci_torch.aug.pipelines import shard_draws
from hairci_torch.models.vit import VisionTransformer
from hairci_torch.parallel import collectives


def backbone_features(backbone: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Pooled features of a backbone: a ViT's with ``pool=True`` (the
    final-normed cls token, or fc_norm of the mean patch token); the ResNets
    return them directly."""
    if isinstance(backbone, VisionTransformer):
        return backbone(x, pool=True)
    return backbone(x)


@torch.no_grad()
def eval_features(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module.extract_features(x)`` in eval mode (running BN statistics),
    the module's mode restored afterwards."""
    was_training = module.training
    module.eval()
    try:
        return module.extract_features(x)
    finally:
        module.train(was_training)


def rank_draws(draw, gen: torch.Generator,
               images: torch.Tensor) -> Dict[str, Any]:
    """A recipe's ``draw(gen, B, H, W)`` for the global batch, B = W b where
    ``images`` holds this rank's b rows, cut to this rank's rows ``[r b,
    (r+1) b)``: each view's draws by ``shard_draws``, every other draw (a
    token mask's noise) by its leading rows. Without a process group, the
    draws of ``images``."""
    b, H, W, _ = images.shape
    lo = collectives.rank() * b
    d = draw(gen, b * collectives.world(), H, W)
    return {k: [shard_draws(v, lo, lo + b) for v in x] if k == "views"
            else x[lo:lo + b] for k, x in d.items()}


RECIPES: Dict[str, Any] = {}


def register_recipe(name: str):
    def deco(cls):
        RECIPES[name] = cls
        cls.name = name
        return cls
    return deco


def build_recipe(mode: str, **kwargs):
    # importing a recipe module registers it
    from hairci_torch.ssl import (  # noqa: F401
        byol, densecl, dinov2, mae, msn, sham, sham_v1, siameseim, simclr,
        simmim, supcon)

    if mode not in RECIPES:
        raise NotImplementedError(
            f"mode {mode!r} is not yet ported; ported: {sorted(RECIPES)}")
    return RECIPES[mode](**kwargs)
