"""BYOL recipe (port of ``hairci/ssl/byol.py``).

The online branch is a backbone (ResNet-50 from the CLI), lightly's BYOL
projection head (2048 -> 4096 -> 256, Dense + BN + ReLU, Dense) and
prediction head (256 -> 4096 -> 256); the momentum branch is their EMA copy
(it never runs the predictor). One step, as in the JAX package:
  1. two ``byol_transform`` views (blur off in both when the recipe builds
     the transform, as the reference runs it);
  2. the momentum branch follows the online branch BEFORE the forward, its
     parameters and its BN running statistics, at the epoch's momentum
     (``momentum_for_epoch``: a cosine from 0.996 to 1 over the run's
     epochs, which the engine passes);
  3. ONE online forward over both views concatenated, so each BN's
     statistics span the 2B rows (the bn_stats kernel on a card: 53 in a
     ResNet-50 trunk, two in the heads);
  4. the momentum branch's projections of the same 2B rows, in eval mode
     and without gradient (its ResNet-50 layer1 3x3 convs go to the conv3x3
     kernel on a card);
  5. 0.5 (ncs(p0, z1) + ncs(p1, z0)) with negative cosine similarity, then
     Adam(W) with no clipping.

``extract_features`` is the online backbone's pooled features of the kNN
view in eval mode. Weights are f32, computed in ``dtype``.

The port updates the state in place. ``train_step`` draws the views'
random parameters from one CPU generator (``draw``) and hands the views to
``step_on_views``, so a test can feed JAX's.

Under data parallelism (a process group, ``parallel.collectives``) the step
is the global batch's, as under JAX's sharding: ``images`` are this rank's
rows of the global batch, the views' draws are taken for the global batch
and cut to those rows, the online trunk's and heads' BN statistics cover
both views of every rank (``models.norm``), the loss is a mean over every
rank's rows (``losses.distill.negative_cosine_similarity``), and the
gradients are averaged over the ranks (``train.optim.all_reduce_grads_``),
so that the online branch, its statistics and the momentum branch stay
equal bit for bit on every rank. The momentum branch runs in eval mode and
reduces nothing.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from hairci_torch.aug.pipelines import (
    MultiViewTransform,
    byol_transform,
    knn_transform,
)
from hairci_torch.losses.distill import negative_cosine_similarity
from hairci_torch.models import backbone_feature_dim, build_backbone
from hairci_torch.models.heads import (
    byol_prediction_head,
    byol_projection_head,
)
from hairci_torch.ssl.base import (
    backbone_features,
    eval_features,
    rank_draws,
    register_recipe,
)
from hairci_torch.train.optim import (
    all_reduce_grads_,
    fill_missing_grads_,
    make_optimizer,
)
from hairci_torch.train.schedules import cosine_schedule
from hairci_torch.train.state import TrainState, ema_update


class BYOLModule(nn.Module):
    """Backbone + projection head + prediction head."""

    def __init__(self, backbone_name: str = "resnet50", img_size: int = 224,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = build_backbone(backbone_name, img_size=img_size,
                                       dtype=dtype)
        self.projection_head = byol_projection_head(
            backbone_feature_dim(backbone_name), dtype=dtype)
        self.prediction_head = byol_prediction_head(dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The online output p = predictor(projector(backbone(x)))."""
        return self.prediction_head(self.project(x))

    def project(self, x: torch.Tensor) -> torch.Tensor:
        """The momentum branch's output z (no predictor)."""
        return self.projection_head(backbone_features(self.backbone, x))

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        return backbone_features(self.backbone, x)


@register_recipe("BYOL")
class BYOLRecipe:
    def __init__(
        self,
        backbone: str = "resnet50",
        img_size: int = 224,
        learning_rate: float = 1e-3,
        weight_decay: float = 0.0,
        betas=(0.9, 0.999),
        dtype: torch.dtype = torch.bfloat16,
        transform: Optional[MultiViewTransform] = None,
        epochs: int = 100,
        **_unused: Any,
    ):
        self.backbone = backbone
        self.img_size = img_size
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.betas = tuple(betas)
        self.dtype = dtype
        self.epochs = epochs
        if transform is None:
            # the reference turns the blur off in both views
            t = byol_transform(img_size)
            transform = dataclasses.replace(t, views=tuple(
                dataclasses.replace(v, blur_p=0.0) for v in t.views))
        self.transform = transform

    def momentum_for_epoch(self, epoch: int) -> float:
        return cosine_schedule(epoch, self.epochs, 0.996, 1.0)

    def create_state(self, seed: int, batch_size: int,
                     device: torch.device) -> TrainState:
        """Seeded random weights; the momentum branch starts as a copy."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            online = BYOLModule(self.backbone, self.img_size, self.dtype)
        online = online.to(device).to(memory_format=torch.channels_last)
        ema = copy.deepcopy(online).requires_grad_(False).eval()
        return TrainState(
            online=online, ema=ema,
            optimizer=make_optimizer(online, self.learning_rate,
                                     self.weight_decay, self.betas))

    def draw(self, gen: torch.Generator, B: int, H: int,
             W: int) -> Dict[str, Any]:
        return {"views": self.transform.draw(gen, B, H, W)}

    def train_step(self, state: TrainState, images: torch.Tensor,
                   gen: torch.Generator, momentum: float = 0.996
                   ) -> Dict[str, torch.Tensor]:
        """One step on a uint8 (b, H, W, 3) batch on the training device
        (this rank's rows under data parallelism). Returns the loss as a
        device tensor."""
        v0, v1 = self.transform.apply(
            images, rank_draws(self.draw, gen, images)["views"])
        return self.step_on_views(state, v0, v1, momentum)

    def step_on_views(self, state: TrainState, v0: torch.Tensor,
                      v1: torch.Tensor, momentum: float = 0.996
                      ) -> Dict[str, torch.Tensor]:
        online, ema = state.online, state.ema
        # the momentum branch follows BEFORE the forward
        ema_update(ema, online, momentum)
        online.train()
        ema.eval()
        both = torch.cat([v0, v1])
        p0, p1 = online(both).chunk(2)
        with torch.no_grad():
            z0, z1 = ema.project(both).chunk(2)
        loss = 0.5 * (negative_cosine_similarity(p0, z1)
                      + negative_cosine_similarity(p1, z0))
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads_(state.optimizer)
        # a ViT's fixed position table and unused mask token still decay
        fill_missing_grads_(state.optimizer)
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach()}

    def extract_features(self, state: TrainState,
                         images: torch.Tensor) -> torch.Tensor:
        return eval_features(state.online,
                             knn_transform(images, self.img_size))
