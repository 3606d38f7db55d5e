"""SHAM / HSimCLR recipe (port of ``hairci/ssl/sham.py``).

One step, as in the JAX package:
  1. two SimCLR views of the uint8 batch: anchor and pos1;
  2. the EMA teacher updated from the online weights BEFORE the forward,
     parameters and BN buffers alike;
  3. negatives: a derangement (``warmup``), the k-th nearest neighbour of
     each pos1 in the EMA's eval-mode features, cached per batch (``mine``),
     or the cached indices (``mined``);
  4. positives: rotate +-15 degrees + 3-tap blur of pos1 (the rotate kernel
     on a card), then hair-patch masking of the positives;
  5. ONE online forward over [negatives; positives; anchors] (3B rows, one
     BN pass and one running-stat update, the stats from the bn_stats
     kernel), and one eval-mode EMA forward of the masked positives;
  6. loss = NT-Xent + 0.5 triplet + 0.2 MSE (+ ``s2r2_weight`` Smooth-AP
     over [anchors; positives; negatives] with ``--S2R2``), clip at global
     norm 1.0, AdamW.

The backbone is a ResNet or ViT-B/16 (``vit_b_16`` / ``vit_base_patch16``).
The ViT trains f32 weights computed in ``dtype`` and checkpoints its blocks
by ``remat`` (default ``True``, as in the JAX package: without it the step's
three gradient-carrying passes keep every block's attention matrices).

The port updates the state in place. ``train_step`` draws every random
parameter of the step from one CPU generator (``draw``) and hands them to
``step_on_views``, so a test can feed JAX's views and draws instead.
While a profiler runs, the step's phases are spans
(``hairci_torch.utils.profiling.span``): ``sham.step`` holds
``sham.augment``, ``sham.update``, ``sham.forward`` and ``sham.backward``,
each entered where the code's order puts its work.

Under data parallelism (a process group, ``parallel.collectives``) the step
is the global batch's, as under JAX's sharding. ``images`` are this rank's
rows ``[r B/W, (r+1) B/W)`` of the global batch of B. Every rank draws the
step's random parameters for all B from the same generator and keeps its
rows (``shard_draws``); the derangement is of the global permutation; the
``mine`` stage ranks the all-gathered EMA features of the global batch, so
``neg_indices`` holds global indices, the same on every rank; each rank
takes its negatives from the all-gathered ``pos1`` views, runs the fused
online forward on its own 3B/W rows (the BN statistics still cover all 3B,
``models.norm``) and the rotate kernel and the EMA forwards on its own
rows. The losses and statistics are the global batch's
(``losses.contrastive``), the gradients are averaged over the ranks before
the clip (``train.optim.all_reduce_grads_``), and the parameters stay equal
bit for bit. On the ViT, which has no BN, the head's BNs and the losses are
the global parts, and every remat mode runs as without a group; the
Smooth-AP term ranks each rank's [anchors; positives; negatives] against
every rank's (``losses.ranking``).
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from hairci_torch.aug.ops import to_device
from hairci_torch.aug.pipelines import (
    MultiViewTransform,
    draw_positive,
    draw_positive_masking,
    knn_transform,
    positive_masking_transform,
    positive_transform,
    shard_draws,
    simclr_transform,
)
from hairci_torch.eval.features import l2_normalize
from hairci_torch.losses.contrastive import (
    margin_violation_stats,
    nt_xent_loss,
    triplet_margin_loss,
)
from hairci_torch.losses.ranking import s2r2_loss
from hairci_torch.models.heads import MLPHead
from hairci_torch.models.resnet import build_resnet
from hairci_torch.models.vit import build_vit
from hairci_torch.parallel import collectives
from hairci_torch.ssl.base import (
    backbone_features,
    eval_features,
    register_recipe,
)
from hairci_torch.train.optim import (
    all_reduce_grads_,
    clip_grad_global_norm_,
    fill_missing_grads_,
    make_optimizer,
)
from hairci_torch.train.state import TrainState, ema_update
from hairci_torch.utils.profiling import span

_PROJ_DIMS = {
    "resnet18": (512, 512, 128),
    "resnet50": (2048, 2048, 1024),
    "vit_b_16": (768, 768, 512),
    "vit_base_patch16": (768, 768, 512),
}


class SHAMModule(nn.Module):
    """Online branch: backbone + projection head (the EMA teacher is a copy
    of the same module)."""

    def __init__(self, backbone_name: str = "resnet18",
                 dtype: torch.dtype = torch.float32, img_size: int = 224,
                 remat: Any = True):
        super().__init__()
        if backbone_name not in _PROJ_DIMS:
            raise ValueError(f"unknown backbone {backbone_name!r}")
        if backbone_name.startswith("vit"):
            # f32 weights cast per call, as Flax trains them
            self.backbone = build_vit(
                "vit_base_patch16", img_size=img_size, dtype=dtype,
                param_dtype=torch.float32, remat=remat)
        else:
            self.backbone = build_resnet(backbone_name, dtype=dtype)
        _, hidden, out = _PROJ_DIMS[backbone_name]
        self.projection_head = MLPHead(
            self.backbone.num_features,
            [(hidden, True, True), (out, True, False)], dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection_head(backbone_features(self.backbone, x))

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        return backbone_features(self.backbone, x)


def derangement(perm: torch.Tensor) -> torch.Tensor:
    """``NegSamplerRandomly``: a permutation with self-matches moved on by
    one (the apply half; ``perm`` is the drawn permutation)."""
    B = perm.shape[0]
    idx = torch.arange(B, device=perm.device)
    return torch.where(perm == idx, (perm + 1) % B, perm)


def kth_neighbor_indices(features: torch.Tensor, k: int) -> torch.Tensor:
    """``NegSamplerStatic``: per row, the k-th most cosine-similar index
    (1-based, k = 1 is the row itself), ties to the lower index."""
    z = l2_normalize(features.float(), eps=1e-8)
    order = torch.sort(-(z @ z.T), dim=1, stable=True).indices
    return order[:, min(max(int(k) - 1, 0), features.shape[0] - 1)]


@register_recipe("SHAM")
class SHAMRecipe:
    def __init__(
        self,
        backbone: str = "resnet18",
        img_size: int = 224,
        temperature: float = 0.5,
        learning_rate: float = 1e-3,
        weight_decay: float = 0.0,
        betas=(0.9, 0.999),
        ema_momentum: float = 0.99,
        warm_up_epochs: int = 10,
        margin_stage1: float = 0.7,
        margin_stage2: float = 0.5,
        triplet_w: float = 0.5,
        mse_w: float = 0.2,
        ablation: str = "None",
        num_batches: int = 1,
        dtype: torch.dtype = torch.float32,
        transform: Optional[MultiViewTransform] = None,
        mask_ratio_range: Tuple[float, float] = (0.1, 0.5),
        s2r2_weight: float = 0.0,
        remat: Any = True,
    ):
        if ablation == "fixed_margin_0_7":
            margin_stage1 = margin_stage2 = 0.7
        elif ablation == "fixed_margin_0_5":
            margin_stage1 = margin_stage2 = 0.5
        self.backbone = backbone
        self.dtype = dtype
        self.temperature = temperature
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.betas = tuple(betas)
        self.ema_momentum = ema_momentum
        self.warm_up_epochs = warm_up_epochs
        self.margin_stage1 = margin_stage1
        self.margin_stage2 = margin_stage2
        self.triplet_w = triplet_w
        self.mse_w = mse_w
        self.ablation = ablation
        self.num_batches = num_batches
        self.img_size = img_size
        self.mask_ratio_range = tuple(mask_ratio_range)
        self.s2r2_weight = s2r2_weight
        self.remat = remat
        self.transform = transform or simclr_transform(img_size)

    # ------------------------------------------------------------------
    def create_state(self, seed: int, batch_size: int,
                     device: torch.device) -> TrainState:
        """Seeded random weights; the EMA teacher starts as a copy."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            online = SHAMModule(self.backbone, self.dtype, self.img_size,
                                self.remat)
        online = online.to(device).to(memory_format=torch.channels_last)
        ema = copy.deepcopy(online).requires_grad_(False).eval()
        return TrainState(
            online=online, ema=ema,
            optimizer=make_optimizer(online, self.learning_rate,
                                     self.weight_decay, self.betas),
            neg_indices=torch.zeros((self.num_batches, batch_size),
                                    dtype=torch.long, device=device))

    # ------------------------------------------------------------------
    def draw(self, gen: torch.Generator, B: int, H: int,
             W: int) -> Dict[str, Any]:
        """Every random parameter of one step, from one CPU generator."""
        return {
            "views": self.transform.draw(gen, B, H, W),
            "perm": torch.randperm(B, generator=gen),
            "positive": draw_positive(gen, B),
            "mask": draw_positive_masking(gen, B, self.img_size,
                                          self.img_size, 32,
                                          self.mask_ratio_range),
        }

    def train_step(self, state: TrainState, images: torch.Tensor,
                   gen: torch.Generator, stage: str = "warmup",
                   batch_id: int = 0, k: int = 7) -> Dict[str, torch.Tensor]:
        """One step on a uint8 (B, H, W, 3) batch on the training device
        (this rank's rows under data parallelism). Returns the step's
        metrics as device tensors (no host sync)."""
        b, H, W, _ = images.shape
        dev = images.device
        with span("sham.step", b, dev):
            with span("sham.augment", b, dev):
                draws = self.draw(gen, b * collectives.world(), H, W)
                lo = collectives.rank() * b
                draws = {"views": [shard_draws(v, lo, lo + b)
                                   for v in draws["views"]],
                         "perm": draws["perm"],   # the global permutation
                         "positive": shard_draws(draws["positive"], lo,
                                                 lo + b),
                         "mask": shard_draws(draws["mask"], lo, lo + b)}
                x_anchor, x_pos1 = self.transform.apply(images,
                                                        draws["views"])
            return self.step_on_views(state, x_anchor, x_pos1, draws, stage,
                                      batch_id, k)

    def step_on_views(self, state: TrainState, x_anchor: torch.Tensor,
                      x_pos1: torch.Tensor, draws: Dict[str, Any],
                      stage: str = "warmup", batch_id: int = 0,
                      k: int = 7) -> Dict[str, torch.Tensor]:
        """One step on this rank's views; ``draws["perm"]`` is the global
        batch's, ``positive`` and ``mask`` this rank's rows."""
        online, ema = state.online, state.ema
        b, dev = x_pos1.shape[0], x_pos1.device
        with span("sham.update", b, dev):
            ema_update(ema, online, self.ema_momentum)  # before the forward

        with span("sham.forward", b, dev):
            if stage == "warmup":
                neg_idx = derangement(to_device(draws["perm"], dev))
                margin = self.margin_stage1
            elif stage == "mine":
                with torch.no_grad():
                    feats = ema.extract_features(x_pos1)
                neg_idx = kth_neighbor_indices(collectives.all_gather(feats),
                                               k)
                state.neg_indices[batch_id] = neg_idx
                margin = self.margin_stage2
            elif stage == "mined":
                neg_idx = state.neg_indices[batch_id]
                margin = self.margin_stage2
            else:
                raise ValueError(f"unknown stage {stage!r}")

            # this rank's rows of the global negatives, taken from every
            # rank's pos1 views
            lo = collectives.rank() * b
            negative = collectives.all_gather(x_pos1)[neg_idx[lo:lo + b]]
        with span("sham.augment", b, dev):
            pos = (x_pos1 if self.ablation == "No_pos_transform"
                   else positive_transform(x_pos1, draws["positive"]))
            masked_pos = (pos if self.ablation == "No masked positive"
                          else positive_masking_transform(pos, draws["mask"]))

        with span("sham.forward", b, dev):
            online.train()
            state.optimizer.zero_grad(set_to_none=True)
            out = online(torch.cat([negative, pos, x_anchor]))
            with torch.no_grad():
                masked_b = l2_normalize(ema(masked_pos))
            neg_b, pos_b, anchor_b = (l2_normalize(t) for t in out.chunk(3))

            contrastive = nt_xent_loss(pos_b, anchor_b, self.temperature)
            triplet = triplet_margin_loss(anchor_b, pos_b, neg_b, margin)
            mse = collectives.global_mean(torch.square(pos_b - masked_b))
            if self.ablation == "No_Triplet":
                total = contrastive + self.mse_w * mse
            elif self.ablation == "No_MSE":
                total = contrastive + self.triplet_w * triplet
            else:
                total = (contrastive + self.triplet_w * triplet
                         + self.mse_w * mse)
            if self.s2r2_weight > 0:
                total = total + self.s2r2_weight * s2r2_loss(
                    torch.cat([anchor_b, pos_b, neg_b]), tau=0.01, k_views=3)
        with span("sham.backward", b, dev):
            total.backward()
        with span("sham.update", b, dev):
            all_reduce_grads_(state.optimizer)
            # parameters without a gradient (the ViT's fixed position table
            # and unused mask token) still decay, as under optax
            fill_missing_grads_(state.optimizer)
            clip_grad_global_norm_(online.parameters(), 1.0)
            state.optimizer.step()
            state.step += 1

            pos_d, neg_d, violations = margin_violation_stats(
                anchor_b.detach(), pos_b.detach(), neg_b.detach(), margin)
        return {
            "loss": total.detach(),
            "contrastive_loss": contrastive.detach(),
            "triplet_loss": triplet.detach(),
            "mse_loss": mse.detach(),
            "pos_dist": pos_d,
            "neg_dist": neg_d,
            "margin_violations": violations,
        }

    # ------------------------------------------------------------------
    def extract_features(self, state: TrainState,
                         images: torch.Tensor) -> torch.Tensor:
        return eval_features(state.online,
                             knn_transform(images, self.img_size))

    def extract_features_ema(self, state: TrainState,
                             images: torch.Tensor) -> torch.Tensor:
        return eval_features(state.ema, knn_transform(images, self.img_size))

    @staticmethod
    def adapt_k(prev_margin_violations: float, batch_size: int) -> int:
        """k at the warm-up boundary: v = violations/B;
        k = max(2, round((1 - v) * 10))."""
        v = prev_margin_violations / batch_size
        return max(2, round((1.0 - v) * 10))

    def stage_for_epoch(self, epoch: int) -> str:
        if self.ablation == "randomly":
            return "warmup"
        if self.warm_up_epochs > epoch + 1:
            return "warmup"
        if epoch + 1 == self.warm_up_epochs:
            return "mine"
        return "mined"
