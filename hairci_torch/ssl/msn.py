"""MSN recipe (port of ``hairci/ssl/msn.py``).

The anchor branch is a ViT-B/16 (one backbone for the 224-px views and the
96-px focal views, the position table resized for the latter), lightly's
MSN projection head ((Linear + BN + GELU) x 2 + Linear, 2048 -> 256) and
1,024 learnable prototypes; the target branch is its EMA copy. One step, as
in the JAX package:
  1. ``msn_transform``: a target view, an anchor view and ``n_focal`` focal
     views;
  2. the target branch follows the anchor branch BEFORE the step, its
     parameters and its BN running statistics;
  3. the target branch, in eval mode (its EMA statistics), on the target
     view; the anchor branch on the anchor view with ``mask_ratio`` of its
     tokens dropped (``random_token_mask`` -> ``ids_keep``), then on the
     focal views: the head's BNs take batch statistics from the bn_stats
     kernel on a card and update their running statistics twice, anchors
     first;
  4. ``msn_loss`` over [anchors; focal] against the targets with the
     prototypes, then AdamW (no clipping).

The features are the TARGET branch's (the reference's ``extract_features``
uses the frozen target backbone). Weights are f32, computed in ``dtype``.

The port updates the state in place. ``train_step`` draws every random
parameter from one CPU generator (``draw``) and hands views and mask to
``step_on_views``, so a test can feed JAX's.

Under data parallelism (a process group, ``parallel.collectives``) the step
is the global batch's, as under JAX's sharding: ``images`` are this rank's
rows of the global batch, the views' draws and the anchor mask's noise are
taken for the global batch and cut to those rows, each of the head's two
BN passes (anchors, then focal views) takes the statistics of every rank's
rows of that pass (``models.norm``), Sinkhorn balances the global batch's
targets and the cross-entropy and the me-max term's mean probabilities are
global means (``losses.distill.msn_loss``), and the gradients are averaged
over the ranks (``train.optim.all_reduce_grads_``), so that both branches
and their statistics stay equal bit for bit on every rank.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Sequence

import torch
from torch import nn

from hairci_torch.aug.ops import to_device
from hairci_torch.aug.pipelines import (
    MultiViewTransform,
    knn_transform,
    msn_transform,
)
from hairci_torch.losses.distill import msn_loss
from hairci_torch.models.heads import MLPHead
from hairci_torch.models.masking import (
    draw_token_noise,
    random_token_mask_from_noise,
)
from hairci_torch.models.vit import VIT_CONFIGS, build_vit
from hairci_torch.ssl.base import (
    eval_features,
    rank_draws,
    register_recipe,
)
from hairci_torch.ssl.mae import vit_backbone_name
from hairci_torch.train.optim import (
    all_reduce_grads_,
    fill_missing_grads_,
    make_optimizer,
)
from hairci_torch.train.state import TrainState, ema_update


class MSNModule(nn.Module):
    """Backbone + projection head (2048, 2048, 256) + 1,024 ``prototypes``
    of width 256, N(0, 0.02)."""

    def __init__(self, backbone_name: str = "vit_base_patch16",
                 img_size: int = 224, dtype: torch.dtype = torch.float32):
        super().__init__()
        # f32 weights cast per call, as Flax trains them
        self.backbone = build_vit(backbone_name, img_size=img_size,
                                  dtype=dtype, param_dtype=torch.float32)
        self.projection_head = MLPHead(
            self.backbone.embed_dim,
            [(2048, True, True), (2048, True, True), (256, False, False)],
            dtype=dtype, act="gelu")
        self.prototypes = nn.Parameter(torch.randn(1024, 256) * 0.02)

    def encode(self, x: torch.Tensor,
               ids_keep: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.projection_head(self.backbone(x, ids_keep=ids_keep)[:, 0])

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x, pool=True)


@register_recipe("MSN")
class MSNRecipe:
    def __init__(
        self,
        backbone: str = "vit_base_patch16",
        img_size: int = 224,
        focal_size: int = 96,
        n_focal: int = 10,
        mask_ratio: float = 0.15,
        learning_rate: float = 1e-3,
        weight_decay: float = 0.0,
        betas=(0.9, 0.999),
        ema_momentum: float = 0.996,
        dtype: torch.dtype = torch.bfloat16,
        transform: Optional[MultiViewTransform] = None,
        **_unused: Any,
    ):
        # ResNet names and vit_b_16 mean ViT-B/16 (the JAX recipe maps only
        # the ResNet names, and raises KeyError on vit_b_16)
        self.backbone = vit_backbone_name(backbone)
        self.img_size = img_size
        self.n_focal = n_focal
        self.mask_ratio = mask_ratio
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.betas = tuple(betas)
        self.ema_momentum = ema_momentum
        self.dtype = dtype
        self.num_patches = (img_size // VIT_CONFIGS[self.backbone][0]) ** 2
        self.transform = transform or msn_transform(img_size, focal_size,
                                                    n_focal)

    def create_state(self, seed: int, batch_size: int,
                     device: torch.device) -> TrainState:
        """Seeded random weights; the target branch starts as a copy."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            online = MSNModule(self.backbone, self.img_size,
                               dtype=self.dtype)
        online = online.to(device)
        ema = copy.deepcopy(online).requires_grad_(False).eval()
        return TrainState(
            online=online, ema=ema,
            optimizer=make_optimizer(online, self.learning_rate,
                                     self.weight_decay, self.betas))

    def draw(self, gen: torch.Generator, B: int, H: int,
             W: int) -> Dict[str, Any]:
        return {"views": self.transform.draw(gen, B, H, W),
                "noise": draw_token_noise(gen, B, self.num_patches)}

    def train_step(self, state: TrainState, images: torch.Tensor,
                   gen: torch.Generator,
                   labels: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step on a uint8 (B, H, W, 3) batch on the training device
        (this rank's rows under data parallelism; ``labels`` unused).
        Returns the loss as a device tensor."""
        draws = rank_draws(self.draw, gen, images)
        views = self.transform.apply(images, draws["views"])
        ids_keep, _, _ = random_token_mask_from_noise(
            to_device(draws["noise"], images.device), self.mask_ratio)
        return self.step_on_views(state, views, ids_keep)

    def step_on_views(self, state: TrainState,
                      views: Sequence[torch.Tensor],
                      ids_keep: torch.Tensor) -> Dict[str, torch.Tensor]:
        online, target = state.online, state.ema
        # the target branch follows the anchor branch BEFORE the step
        ema_update(target, online, self.ema_momentum)
        online.train()
        target.eval()
        with torch.no_grad():
            target_out = target.encode(views[0])
        anchor_out = online.encode(views[1], ids_keep)
        focal_out = online.encode(torch.cat(list(views[2:]), dim=0))
        loss = msn_loss(torch.cat([anchor_out, focal_out], dim=0),
                        target_out, online.prototypes)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads_(state.optimizer)
        # the fixed position table and the unused mask token still decay
        fill_missing_grads_(state.optimizer)
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach()}

    def extract_features(self, state: TrainState,
                         images: torch.Tensor) -> torch.Tensor:
        """The target branch's final-normed cls token of the kNN view."""
        return eval_features(state.ema, knn_transform(images, self.img_size))
