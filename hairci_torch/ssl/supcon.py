"""SupCon recipe (port of ``hairci/ssl/supcon.py``): the reference's
``SupConResNet`` -- a CIFAR-stem ResNet encoder trained from scratch and an
``mlp`` (or ``linear``) head giving L2-normalised 128-d features -- trained
with the supervised contrastive loss on two views and the batch's labels
(``--mode simclr_supcon``).

One step: SupCon's two views of the uint8 batch (hflip, colour jitter, a
resize, the CIFAR-100 normalisation), ONE forward over both views
concatenated (BN statistics over the 2B rows), the features stacked as
(B, 2, D), ``supcon_loss`` at ``temperature`` with the labels, Adam(W)
with no gradient clipping. ``extract_features`` is the encoder alone, in
eval mode, on the kNN view.

Under data parallelism (a process group, ``parallel.collectives``) the step
is the global batch's, as under JAX's sharding: ``images`` and ``labels``
are this rank's rows of the global batch (the loader shards both), the
views' draws are taken for the global batch and cut to those rows, the BN
statistics cover both views of every rank (``models.norm``), the loss
contrasts this rank's anchors with every rank's views under the global
labels (``losses.contrastive.supcon_loss``), and the gradients are
averaged over the ranks (``train.optim.all_reduce_grads_``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from hairci_torch.aug.pipelines import (
    MultiViewTransform,
    knn_transform,
    supcon_train_transform,
)
from hairci_torch.eval.features import l2_normalize
from hairci_torch.losses.contrastive import supcon_loss
from hairci_torch.models.heads import supcon_head
from hairci_torch.models.resnet import build_resnet
from hairci_torch.ssl.base import (
    eval_features,
    rank_draws,
    register_recipe,
)
from hairci_torch.train.optim import all_reduce_grads_, make_optimizer
from hairci_torch.train.state import TrainState

# CIFAR-100 statistics, which the reference normalises SupCon's views with
CIFAR_MEAN = (0.5071, 0.4867, 0.4408)
CIFAR_STD = (0.2675, 0.2565, 0.2761)


class SupConModule(nn.Module):
    """``encoder`` (CIFAR-stem ResNet) + ``head``, in the reference's key
    layout apart from ``downsample`` for its ``shortcut``."""

    def __init__(self, backbone_name: str = "resnet18", head: str = "mlp",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.encoder = build_resnet(backbone_name, stem="cifar", dtype=dtype)
        self.head = supcon_head(self.encoder.num_features, head, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return l2_normalize(self.head(self.encoder(x)).float(), eps=1e-12)

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x)


@register_recipe("simclr_supcon")
class SupConRecipe:
    def __init__(
        self,
        backbone: str = "resnet18",
        img_size: int = 224,
        temperature: float = 0.07,
        learning_rate: float = 1e-3,
        weight_decay: float = 0.0,
        betas=(0.9, 0.999),
        dtype: torch.dtype = torch.float32,
        transform: Optional[MultiViewTransform] = None,
    ):
        self.backbone = backbone
        self.img_size = img_size
        self.temperature = temperature
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.betas = tuple(betas)
        self.dtype = dtype
        self.transform = transform or supcon_train_transform(
            img_size, CIFAR_MEAN, CIFAR_STD)

    def create_state(self, seed: int, batch_size: int,
                     device: torch.device) -> TrainState:
        """Seeded random weights; no EMA teacher, no negative cache."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            online = SupConModule(self.backbone, dtype=self.dtype)
        online = online.to(device).to(memory_format=torch.channels_last)
        return TrainState(
            online=online,
            optimizer=make_optimizer(online, self.learning_rate,
                                     self.weight_decay, self.betas))

    def draw(self, gen: torch.Generator, B: int, H: int,
             W: int) -> Dict[str, Any]:
        return {"views": self.transform.draw(gen, B, H, W)}

    def train_step(self, state: TrainState, images: torch.Tensor,
                   gen: torch.Generator, labels: torch.Tensor
                   ) -> Dict[str, torch.Tensor]:
        """One step on a uint8 (b, H, W, 3) batch and its (b,) labels on
        the training device (this rank's rows under data parallelism).
        Returns the loss as a device tensor."""
        v0, v1 = self.transform.apply(
            images, rank_draws(self.draw, gen, images)["views"])
        return self.step_on_views(state, v0, v1, labels)

    def step_on_views(self, state: TrainState, v0: torch.Tensor,
                      v1: torch.Tensor, labels: Optional[torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
        online = state.online
        online.train()
        state.optimizer.zero_grad(set_to_none=True)
        f1, f2 = online(torch.cat([v0, v1])).chunk(2)
        loss = supcon_loss(torch.stack([f1, f2], dim=1), labels,
                           self.temperature)
        loss.backward()
        all_reduce_grads_(state.optimizer)
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach()}

    def extract_features(self, state: TrainState,
                         images: torch.Tensor) -> torch.Tensor:
        return eval_features(state.online,
                             knn_transform(images, self.img_size))
