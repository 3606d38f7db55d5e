"""DenseCL recipe (port of ``hairci/ssl/densecl.py``).

The online branch is a ResNet kept spatial (``ResNetFeatures``), lightly's
DenseCL global head on the pooled features and the same head on every
position of the last map (2048 -> 2048 -> 512 both, for ResNet-50); the
momentum branch is their EMA copy. ``state.extra`` carries two ring
buffers of stale keys, ``bank_g`` / ``bank_l`` (4096 x 512 f32, zeros at
the start) with their pointers ``ptr_g`` / ``ptr_l`` (0-d int64 tensors on
the training device, so no step waits for the card), checkpointed with the
model. One step, as in the JAX package:
  1. two ``densecl_transform`` views, the query and the key;
  2. the momentum branch follows the online branch BEFORE the forward, its
     parameters and its BN running statistics, at the epoch's momentum
     (``momentum_for_epoch``: a cosine from 0.996 to 1 over the run's
     epochs);
  3. the momentum branch on the key view, in eval mode and without
     gradient (its ResNet-50 layer1 3x3 convs go to the conv3x3 kernel on
     a card): its grid, global and local keys;
  4. the online branch on the query view, B rows (the trunk's 53 BNs take
     the bn_stats kernel on a card);
  5. each query position takes the local key of its most similar key
     position (``select_most_similar`` on the two backbone grids);
  6. (1 - lambda) InfoNCE of the global embeddings + lambda InfoNCE of the
     local ones, each against its bank AS IT WAS BEFORE this step, then
     Adam(W) with no clipping;
  7. the batch's global keys, and the per-image mean of its local keys,
     are enqueued.

``extract_features`` is the online trunk's pooled f32 features (not
rounded to ``dtype``) of the kNN view in eval mode.

The port updates the state in place. ``train_step`` draws the views'
random parameters from one CPU generator (``draw``) and hands the views to
``step_on_views``, so a test can feed JAX's.

Under data parallelism (a process group, ``parallel.collectives``) the step
is the global batch's, as under JAX's sharding: ``images`` are this rank's
rows of the global batch, the views' draws are taken for the global batch
and cut to those rows, the online trunk's and heads' BN statistics cover
every rank's query views (``models.norm``), both InfoNCE terms are means
over every rank's queries (``losses.dense.memory_bank_infonce``; each
query position is matched within its own image), and the gradients are
averaged over the ranks (``train.optim.all_reduce_grads_``). Every rank
holds both banks whole and enqueues every rank's keys, gathered in rank
order, so that the pointers advance by the global batch and the banks stay
equal bit for bit on every rank, and to the one-process run's.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch
from torch import nn

from hairci_torch.aug.pipelines import (
    MultiViewTransform,
    densecl_transform,
    knn_transform,
)
from hairci_torch.losses.dense import (
    memory_bank_infonce,
    select_most_similar,
    update_memory_bank,
)
from hairci_torch.models.heads import DenseCLLocalHead, densecl_global_head
from hairci_torch.models.resnet import build_resnet
from hairci_torch.parallel import collectives
from hairci_torch.ssl.base import (
    eval_features,
    rank_draws,
    register_recipe,
)
from hairci_torch.train.optim import all_reduce_grads_, make_optimizer
from hairci_torch.train.schedules import cosine_schedule
from hairci_torch.train.state import TrainState, ema_update


class DenseCLModule(nn.Module):
    """Spatial ResNet + global head + local head (the reference's
    ``DenseCLProjectionHead(2048, 2048, 512)`` twice)."""

    def __init__(self, backbone_name: str = "resnet50", out_dim: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.backbone = build_resnet(backbone_name, dtype=dtype,
                                     with_spatial=True)
        d = self.backbone.num_features
        self.projection_head_global = densecl_global_head(d, out=out_dim,
                                                          dtype=dtype)
        self.projection_head_local = DenseCLLocalHead(d, out=out_dim,
                                                      dtype=dtype)

    def forward(self, x: torch.Tensor):
        """(grid (B, H*W, C), global (B, D), local (B, H*W, D)), all f32."""
        pooled, spatial = self.backbone(x)
        B, H, W, C = spatial.shape
        return (spatial.reshape(B, H * W, C),
                self.projection_head_global(pooled),
                self.projection_head_local(spatial))

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x)[0]


@register_recipe("DenseCL")
class DenseCLRecipe:
    def __init__(
        self,
        backbone: str = "resnet50",
        img_size: int = 224,
        learning_rate: float = 1e-3,
        weight_decay: float = 0.0,
        betas=(0.9, 0.999),
        temperature: float = 0.1,
        bank_size: int = 4096,
        lambda_: float = 0.5,
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
        self.temperature = temperature
        self.bank_size = bank_size
        self.lambda_ = lambda_
        self.dtype = dtype
        self.epochs = epochs
        self.out_dim = 512
        self.transform = transform or densecl_transform(img_size)

    def momentum_for_epoch(self, epoch: int) -> float:
        return cosine_schedule(epoch, self.epochs, 0.996, 1.0)

    def create_state(self, seed: int, batch_size: int,
                     device: torch.device) -> TrainState:
        """Seeded random weights; the momentum branch starts as a copy; zero
        banks, pointers at 0."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            online = DenseCLModule(self.backbone, self.out_dim, self.dtype)
        online = online.to(device).to(memory_format=torch.channels_last)
        ema = copy.deepcopy(online).requires_grad_(False).eval()
        bank = (self.bank_size, self.out_dim)
        extra = {
            "bank_g": torch.zeros(bank, device=device),
            "ptr_g": torch.zeros((), dtype=torch.long, device=device),
            "bank_l": torch.zeros(bank, device=device),
            "ptr_l": torch.zeros((), dtype=torch.long, device=device),
        }
        return TrainState(
            online=online, ema=ema,
            optimizer=make_optimizer(online, self.learning_rate,
                                     self.weight_decay, self.betas),
            extra=extra)

    def draw(self, gen: torch.Generator, B: int, H: int,
             W: int) -> Dict[str, Any]:
        return {"views": self.transform.draw(gen, B, H, W)}

    def train_step(self, state: TrainState, images: torch.Tensor,
                   gen: torch.Generator, momentum: float = 0.996
                   ) -> Dict[str, torch.Tensor]:
        """One step on a uint8 (b, H, W, 3) batch on the training device
        (this rank's rows under data parallelism). Returns the loss and its
        two terms as device tensors."""
        x_query, x_key = self.transform.apply(
            images, rank_draws(self.draw, gen, images)["views"])
        return self.step_on_views(state, x_query, x_key, momentum)

    def step_on_views(self, state: TrainState, x_query: torch.Tensor,
                      x_key: torch.Tensor, momentum: float = 0.996
                      ) -> Dict[str, torch.Tensor]:
        online, ema, extra = state.online, state.ema, state.extra
        # the momentum branch follows BEFORE the forward
        ema_update(ema, online, momentum)
        online.train()
        ema.eval()
        with torch.no_grad():
            key_grid, key_global, key_local = ema(x_key)
        q_grid, q_global, q_local = online(x_query)
        with torch.no_grad():
            matched = select_most_similar(q_grid, key_grid, key_local)
        B, N, D = q_local.shape
        loss_g = memory_bank_infonce(q_global, key_global, extra["bank_g"],
                                     self.temperature)
        loss_l = memory_bank_infonce(q_local.reshape(B * N, D),
                                     matched.reshape(B * N, D),
                                     extra["bank_l"], self.temperature)
        loss = (1 - self.lambda_) * loss_g + self.lambda_ * loss_l
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_grads_(state.optimizer)
        state.optimizer.step()
        state.step += 1
        # enqueue the global batch's keys, the local ones as a mean per
        # image, every rank's in rank order
        bank_g, ptr_g = update_memory_bank(
            extra["bank_g"], extra["ptr_g"],
            collectives.all_gather(key_global))
        bank_l, ptr_l = update_memory_bank(
            extra["bank_l"], extra["ptr_l"],
            collectives.all_gather(key_local.mean(dim=1)))
        state.extra = {"bank_g": bank_g, "ptr_g": ptr_g,
                       "bank_l": bank_l, "ptr_l": ptr_l}
        return {"loss": loss.detach(), "global_loss": loss_g.detach(),
                "local_loss": loss_l.detach()}

    def extract_features(self, state: TrainState,
                         images: torch.Tensor) -> torch.Tensor:
        return eval_features(state.online,
                             knn_transform(images, self.img_size))
