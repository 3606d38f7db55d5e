"""SimCLR recipe (port of ``hairci/ssl/simclr.py``).

One step, as in the JAX package: two SimCLR views of the uint8 batch, ONE
online forward over both views concatenated (so each BN's statistics span
the 2B rows, from the bn_stats kernel on a card), NT-Xent between the two
halves of the projections, plus ``s2r2_weight`` Smooth-AP over the
concatenated projections (``--mode S2R2`` and ``--mode simclr --S2R2``),
then Adam(W) with no gradient clipping.

The backbone is resnet18/34/50/101 or ViT-B/16 (``vit_b_16`` /
``vit_base_patch16``), with the reference's projection head widths
(``heads.SIMCLR_PROJ_DIMS``). The ViT trains f32 weights computed in
``dtype`` and keeps every block's activations (no remat, as the JAX recipe
builds it). ``extract_features`` is the pooled backbone features of
the kNN view in eval mode.

The port updates the state in place. ``train_step`` draws the views' random
parameters from one CPU generator (``draw``) and hands the views to
``step_on_views``, so a test can feed JAX's views instead.

Under data parallelism (a process group, ``parallel.collectives``) the step
is the global batch's, as under JAX's sharding: ``images`` are this rank's
rows of the global batch, the views' draws are taken for the global batch
and cut to those rows, the BN statistics cover both views of every rank
(``models.norm``; on the ViT only the head's), NT-Xent's negatives span
the global 2B views, the Smooth-AP term ranks each rank's views against
every rank's (``losses.ranking``), and the gradients are averaged over the
ranks (``train.optim.all_reduce_grads_``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from hairci_torch.aug.pipelines import (
    MultiViewTransform,
    knn_transform,
    simclr_transform,
)
from hairci_torch.losses.contrastive import nt_xent_loss
from hairci_torch.losses.ranking import s2r2_loss
from hairci_torch.models.heads import SIMCLR_PROJ_DIMS, simclr_projection_head
from hairci_torch.models.resnet import build_resnet
from hairci_torch.models.vit import build_vit
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
from hairci_torch.train.state import TrainState


class SimCLRModule(nn.Module):
    """Backbone + SimCLR projection head (``projection_head``, as SHAM's:
    the reference's SimCLR ``.pth`` loads through ``sham2_state_dict``)."""

    def __init__(self, backbone_name: str = "resnet50",
                 dtype: torch.dtype = torch.float32, img_size: int = 224):
        super().__init__()
        if backbone_name.startswith("vit"):
            # f32 weights cast per call, as Flax trains them
            self.backbone = build_vit(
                "vit_base_patch16", img_size=img_size, dtype=dtype,
                param_dtype=torch.float32)
        else:
            self.backbone = build_resnet(backbone_name, dtype=dtype)
        hidden, out = SIMCLR_PROJ_DIMS[backbone_name]
        self.projection_head = simclr_projection_head(
            self.backbone.num_features, hidden, out, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection_head(backbone_features(self.backbone, x))

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        return backbone_features(self.backbone, x)


@register_recipe("simclr")
class SimCLRRecipe:
    def __init__(
        self,
        backbone: str = "resnet50",
        img_size: int = 224,
        temperature: float = 0.5,
        learning_rate: float = 1e-3,
        weight_decay: float = 0.0,
        betas=(0.9, 0.999),
        dtype: torch.dtype = torch.float32,
        transform: Optional[MultiViewTransform] = None,
        s2r2_weight: float = 0.0,
    ):
        self.backbone = backbone
        self.img_size = img_size
        self.temperature = temperature
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.betas = tuple(betas)
        self.dtype = dtype
        self.s2r2_weight = s2r2_weight
        self.transform = transform or simclr_transform(img_size)

    def create_state(self, seed: int, batch_size: int,
                     device: torch.device) -> TrainState:
        """Seeded random weights; no EMA teacher, no negative cache."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            online = SimCLRModule(self.backbone, self.dtype, self.img_size)
        online = online.to(device).to(memory_format=torch.channels_last)
        return TrainState(
            online=online,
            optimizer=make_optimizer(online, self.learning_rate,
                                     self.weight_decay, self.betas))

    def draw(self, gen: torch.Generator, B: int, H: int,
             W: int) -> Dict[str, Any]:
        return {"views": self.transform.draw(gen, B, H, W)}

    def train_step(self, state: TrainState, images: torch.Tensor,
                   gen: torch.Generator, labels: Optional[torch.Tensor] = None
                   ) -> Dict[str, torch.Tensor]:
        """One step on a uint8 (B, H, W, 3) batch on the training device
        (this rank's rows under data parallelism; ``labels`` unused).
        Returns the loss as a device tensor."""
        v0, v1 = self.transform.apply(
            images, rank_draws(self.draw, gen, images)["views"])
        return self.step_on_views(state, v0, v1)

    def step_on_views(self, state: TrainState, v0: torch.Tensor,
                      v1: torch.Tensor) -> Dict[str, torch.Tensor]:
        online = state.online
        online.train()
        state.optimizer.zero_grad(set_to_none=True)
        out = online(torch.cat([v0, v1]))
        z0, z1 = out.chunk(2)
        loss = nt_xent_loss(z0, z1, self.temperature)
        if self.s2r2_weight > 0:
            loss = loss + self.s2r2_weight * s2r2_loss(out, k_views=2)
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
