"""DINOv2 recipe (port of ``hairci/ssl/dinov2.py``).

A ViT-S/16 student with LayerScale (``init_values`` 1e-5) and one DINO head
(2048-2048-256 into 65,536 weight-normalised prototypes) that serves the
iBOT loss too; the teacher is an EMA copy. One step, as in the JAX package:
  1. ``dino_transform``: two global views and ``n_local`` local views;
  2. the teacher, in eval mode, on the clean global views: cls logits, and
     the patch tokens;
  3. the student on the global views block-masked (``random_block_mask``
     over 2B rows, the learned mask token in the masked patches) and on the
     local views;
  4. DINO cross-entropy over the views' cls logits (same-view pairs
     skipped), iBOT cross-entropy over the masked patches, and
     ``koleo_weight`` x KoLeo of the student's global cls tokens;
  5. AdamW (weight decay on, no clipping), then the teacher's EMA at the
     step's momentum. The DINO and iBOT centres are ``state.extra``.

The iBOT loss gathers at most ``n_masked`` tokens an image (the masked
ones first, ties at the lower index, as ``lax.top_k``) before the head, and
runs the 65,536-way head and its cross-entropy over chunks of 16 rows under
``torch.utils.checkpoint``, so no (2B, M, 65536) tensor exists in the
forward or the backward. The teacher temperature warms up linearly from
0.04 to 0.07 and the momentum follows a cosine from 0.992 to 1, per step
over ``epochs * steps_per_epoch`` (the engine passes both). The weight
decay is fixed: the JAX recipe's docstring promises a cosine from 0.04 to
0.4, its optimizer does not (a reference fault, followed here).

The port updates the state in place. ``train_step`` draws every random
parameter from one CPU generator (``draw``) and hands views and mask to
``step_on_views``, so a test can feed JAX's.

Under data parallelism (a process group, ``parallel.collectives``) the step
is the global batch's, as under JAX's sharding. ``images`` are this rank's
rows ``[r b, (r+1) b)`` of the global batch of B = W b. Every rank draws
the views and the block scores for all B from the same generator and keeps
its rows: of each view, and of each half of the scores, which are drawn
for 2B rows ordered [view 1 of all B; view 2 of all B]. DINO's terms and
centre and KoLeo are global in ``losses.distill``; the iBOT loss and centre
are weighted means whose numerators and weight (the masked-token count)
are summed over the ranks before the division, since the ranks hold
different mask counts. The gradients are averaged over the ranks before
the optimizer (``train.optim.all_reduce_grads_``), so the parameters, the
teacher and both centres stay equal bit for bit on every rank.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from hairci_torch.aug.ops import to_device
from hairci_torch.aug.pipelines import (
    MultiViewTransform,
    dino_transform,
    knn_transform,
    shard_draws,
)
from hairci_torch.losses.distill import dino_loss, koleo_loss
from hairci_torch.models.heads import DINOHead
from hairci_torch.models.masking import (
    block_grid,
    draw_block_scores,
    random_block_mask_from_scores,
)
from hairci_torch.models.vit import VIT_CONFIGS, build_vit
from hairci_torch.parallel import collectives
from hairci_torch.ssl.base import eval_features, register_recipe
from hairci_torch.train.optim import (
    all_reduce_grads_,
    fill_missing_grads_,
    make_optimizer,
)
from hairci_torch.train.schedules import (
    cosine_schedule,
    linear_warmup_schedule,
)
from hairci_torch.train.state import TrainState, ema_update


class DINOv2Module(nn.Module):
    """The ViT with LayerScale and the DINO head (also the iBOT head: the
    reference's ``ibot_separate_head=False``)."""

    def __init__(self, backbone_name: str = "vit_small_patch16",
                 img_size: int = 224, head_out: int = 65536,
                 dtype: torch.dtype = torch.float32, remat: Any = True):
        super().__init__()
        # f32 weights cast per call, as Flax trains them
        self.backbone = build_vit(backbone_name, img_size=img_size,
                                  dtype=dtype, param_dtype=torch.float32,
                                  init_values=1e-5, remat=remat)
        self.dino_head = DINOHead(self.backbone.embed_dim, out_dim=head_out,
                                  dtype=dtype)

    def forward_tokens(self, x: torch.Tensor,
                       token_mask: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
        return self.backbone(x, token_mask=token_mask)

    def cls_logits(self, cls_tokens: torch.Tensor) -> torch.Tensor:
        return self.dino_head(cls_tokens)

    def patch_logits(self, patch_tokens: torch.Tensor) -> torch.Tensor:
        return self.dino_head(patch_tokens)

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x, pool=True)


def ibot_indices(block_mask: torch.Tensor, n_masked: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k(mask, n_masked)`` of a (R, N) 0/1 mask: (values, indices),
    the masked positions first, each group in index order (a stable sort,
    where ``torch.topk`` promises no order among ties)."""
    m = block_mask.to(torch.int32)
    idx = torch.argsort(1 - m, dim=1, stable=True)[:, :n_masked]
    return torch.gather(m, 1, idx), idx


@register_recipe("dinov2")
class DINOv2Recipe:
    def __init__(
        self,
        backbone: str = "vit_small_patch16",
        img_size: int = 224,
        local_size: int = 96,
        n_local: int = 8,
        head_out: int = 65536,
        learning_rate: float = 1e-3,
        weight_decay: float = 0.04,
        betas=(0.9, 0.999),
        mask_ratio: float = 0.3,
        dtype: torch.dtype = torch.bfloat16,
        transform: Optional[MultiViewTransform] = None,
        epochs: int = 100,
        steps_per_epoch: int = 100,
        koleo_weight: float = 0.1,
        remat: Any = True,
        **_unused: Any,
    ):
        if backbone in ("resnet18", "resnet50", "vit_b_16"):
            backbone = "vit_small_patch16"   # the reference's DINOv2 is ViT-S
        self.backbone = backbone
        self.img_size = img_size
        self.n_local = n_local
        self.head_out = head_out
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.betas = tuple(betas)
        self.mask_ratio = mask_ratio
        self.dtype = dtype
        self.epochs = epochs
        self.steps_per_epoch = steps_per_epoch
        # KoLeo's nearest neighbour is degenerate at init (LayerScale 1e-5
        # leaves the cls tokens almost tied): parity tests set it to 0
        self.koleo_weight = koleo_weight
        self.remat = remat
        self.grid = img_size // VIT_CONFIGS[backbone][0]
        # the most tokens random_block_mask masks in an image: k coarse
        # blocks of block^2 patches, cropped to the grid
        block, coarse = block_grid(self.grid, 4)
        k_blocks = max(int(round(mask_ratio * coarse * coarse)), 1)
        self.n_masked = min(k_blocks * block * block, self.grid * self.grid)
        self.ibot_chunk_rows = 16
        self.transform = transform or dino_transform(img_size, local_size,
                                                     n_local)

    # the per-step schedules
    def teacher_temp(self, global_step: int) -> float:
        total = self.epochs * self.steps_per_epoch
        warmup = int(30 / max(self.epochs, 1) * total)
        return linear_warmup_schedule(global_step, warmup, 0.04, 0.07)

    def momentum(self, global_step: int) -> float:
        total = self.epochs * self.steps_per_epoch
        return cosine_schedule(global_step, total, 0.992, 1.0)

    def create_state(self, seed: int, batch_size: int,
                     device: torch.device) -> TrainState:
        """Seeded random weights; the teacher starts as a copy; zero
        centres."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            online = DINOv2Module(self.backbone, self.img_size,
                                  self.head_out, dtype=self.dtype,
                                  remat=self.remat)
        online = online.to(device)
        ema = copy.deepcopy(online).requires_grad_(False).eval()
        extra = {name: torch.zeros((1, self.head_out), device=device)
                 for name in ("dino_center", "ibot_center")}
        return TrainState(
            online=online, ema=ema,
            optimizer=make_optimizer(online, self.learning_rate,
                                     self.weight_decay, self.betas),
            extra=extra)

    def draw(self, gen: torch.Generator, B: int, H: int,
             W: int) -> Dict[str, Any]:
        return {"views": self.transform.draw(gen, B, H, W),
                "scores": draw_block_scores(gen, 2 * B, self.grid)}

    def train_step(self, state: TrainState, images: torch.Tensor,
                   gen: torch.Generator, teacher_temp: float = 0.04,
                   momentum: float = 0.992) -> Dict[str, torch.Tensor]:
        """One step on a uint8 (b, H, W, 3) batch on the training device
        (this rank's rows under data parallelism). Returns the loss terms
        as device tensors."""
        b, H, W, _ = images.shape
        B, lo = b * collectives.world(), collectives.rank() * b
        draws = self.draw(gen, B, H, W)
        views = self.transform.apply(
            images, [shard_draws(v, lo, lo + b) for v in draws["views"]])
        scores = draws["scores"]       # [view 1 of all B; view 2 of all B]
        scores = torch.cat([scores[lo:lo + b], scores[B + lo:B + lo + b]])
        block_mask = random_block_mask_from_scores(
            to_device(scores, images.device), self.grid, self.mask_ratio)
        return self.step_on_views(state, views, block_mask, teacher_temp,
                                  momentum)

    def step_on_views(self, state: TrainState,
                      views: Sequence[torch.Tensor],
                      block_mask: torch.Tensor, teacher_temp: float,
                      momentum: float) -> Dict[str, torch.Tensor]:
        online, teacher = state.online, state.ema
        online.train()
        teacher.eval()
        glob = torch.cat([views[0], views[1]], dim=0)      # (2B, ...)
        with torch.no_grad():
            t_tokens = teacher.forward_tokens(glob)
            t_cls_out = teacher.cls_logits(t_tokens[:, 0])
        s_tokens = online.forward_tokens(glob, token_mask=block_mask)
        s_cls_g = s_tokens[:, 0]
        s_cls_out_g = online.cls_logits(s_cls_g)
        # iBOT: the masked positions' tokens, gathered before the head
        w_m, idx = ibot_indices(block_mask, self.n_masked)
        gather = idx[..., None].expand(-1, -1, t_tokens.shape[-1])
        t_m = torch.gather(t_tokens[:, 1:], 1, gather)
        s_m = torch.gather(s_tokens[:, 1:], 1, gather)
        local = torch.cat(list(views[2:]), dim=0)
        s_cls_out_l = online.cls_logits(online.forward_tokens(local)[:, 0])

        d_loss, dino_center = dino_loss(
            t_cls_out.chunk(2), s_cls_out_g.chunk(2)
            + s_cls_out_l.chunk(len(views) - 2),
            state.extra["dino_center"], teacher_temp=teacher_temp)
        i_loss, ibot_center = self._ibot_loss_chunked(
            online, teacher, t_m, s_m, w_m.float(),
            state.extra["ibot_center"], teacher_temp)
        k_loss = self.koleo_weight * sum(koleo_loss(t)
                                         for t in s_cls_g.chunk(2))
        total = d_loss + i_loss + k_loss
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        all_reduce_grads_(state.optimizer)
        # the fixed position table takes no gradient and still decays
        fill_missing_grads_(state.optimizer)
        state.optimizer.step()
        state.step += 1
        state.extra = {"dino_center": dino_center, "ibot_center": ibot_center}
        # the teacher follows AFTER the optimizer step
        ema_update(teacher, online, momentum)
        return {"loss": total.detach(), "dino_loss": d_loss.detach(),
                "ibot_loss": i_loss.detach(), "koleo_loss": k_loss.detach()}

    def _ibot_loss_chunked(self, online: DINOv2Module, teacher: DINOv2Module,
                           t_m: torch.Tensor, s_m: torch.Tensor,
                           w: torch.Tensor, center: torch.Tensor,
                           teacher_temp: float, student_temp: float = 0.1,
                           center_momentum: float = 0.9
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """iBOT's masked-patch cross-entropy (lightly ``IBOTPatchLoss``) over
        chunks of ``ibot_chunk_rows`` rows. t_m / s_m (R, M, D) are the
        gathered backbone tokens, w (R, M) is 1 for a masked token, 0 for
        padding. Each chunk's head and cross-entropy are recomputed in the
        backward pass, so at most chunk x M x out_dim logits exist at once;
        the sums are those of the unchunked loss, in another order, and
        under data parallelism every rank's (one all-reduce of the
        cross-entropy sum, the weight and the teacher-logit sums before
        the divisions). Returns (loss, new centre)."""
        def chunk(t, s, wc):
            with torch.no_grad():
                t_out = teacher.patch_logits(t)
            s_out = online.patch_logits(s)
            tp = torch.softmax((t_out - center) / teacher_temp, dim=-1)
            sl = torch.log_softmax(s_out / student_temp, dim=-1)
            ce = -torch.sum(tp * sl, dim=-1)                  # (rows, M)
            return (torch.sum(ce * wc), torch.sum(wc),
                    torch.sum(t_out * wc[..., None], dim=(0, 1)))

        rows = self.ibot_chunk_rows
        parts = []
        for i in range(0, t_m.shape[0], rows):
            args = (t_m[i:i + rows], s_m[i:i + rows], w[i:i + rows])
            parts.append(checkpoint(chunk, *args, use_reentrant=False)
                         if torch.is_grad_enabled() else chunk(*args))
        ce_sum, w_sum, t_sum = (torch.stack(p) for p in zip(*parts))
        sums = collectives.all_reduce_sum(torch.cat([
            torch.sum(ce_sum)[None], torch.sum(w_sum)[None].detach(),
            torch.sum(t_sum, dim=0).detach()]))
        total_w = torch.clamp(sums[1], min=1.0)
        loss = sums[0] / total_w
        batch_center = (sums[2:] / total_w)[None]
        new_center = center * center_momentum + batch_center * (
            1 - center_momentum)
        return loss, new_center.detach()

    def extract_features(self, state: TrainState,
                         images: torch.Tensor) -> torch.Tensor:
        """The student's final-normed cls token of the kNN view."""
        return eval_features(state.online,
                             knn_transform(images, self.img_size))
