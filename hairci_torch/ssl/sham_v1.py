"""SHAM v1 recipe (port of ``hairci/ssl/sham_v1.py``): the ViT variant of
SHAM with a masked student and a full-view EMA teacher. The JAX package
reaches it through the recipe registry and the ``Trainer`` only (neither
CLI has the mode), and so does the port.

The module: a ViT-B/16 backbone (final-normed tokens, f32), a global
projector (pooled -> 1024 -> LayerNorm -> GELU -> 256) and a local one
(patch -> 1024 -> LayerNorm -> GELU), a ``CrossBlock`` that aligns the
student's patches with the teacher's (``pos_map`` on the position
embeddings), and for ``sham_mode="reconstruction"`` a depth-2 decoder
(8-head blocks at the backbone's width) with a pixel head. The projectors'
LayerNorms are flax's defaults (eps 1e-6, f32) and their GELU is
``nn.gelu``'s default, the tanh approximation, on f32 inputs. One step, as
in the JAX package:
  1. two ``simclr_transform`` views (student, teacher) and a
     ``random_token_mask`` of the student (ratio 0.75);
  2. the teacher follows the student BEFORE the step, parameters only, at a
     fixed momentum of 0.996;
  3. the teacher, without gradient, on its full view: pooled and patch
     projections; the student on its kept tokens: the pooled projection;
  4. reconstruction only: the decoder over the unshuffled grid, masked MSE
     against the student view's pixels (no per-patch normalisation);
  5. the student's visible patches scattered into a zero grid at their
     positions (both modes), aligned with the teacher's patches by the
     cross block with a zero position embedding (the JAX step passes
     zeros: ``pos_map`` adds only its bias to the student, nothing is
     added to the teacher), then the local projection;
  6. NT-Xent(global, T) + 0.5 patch-contrastive(local, T) + recon, then
     Adam(W) after clipping the global gradient norm at 1.0.

No BatchNorm, rotation, 3x3 conv or gallery search is on this path: it
launches none of the port's kernels. ``extract_features`` is the
student backbone's final-normed cls token of the kNN view. Weights are
f32, computed in ``dtype``.

The port updates the state in place. ``train_step`` draws the views' and
the mask's random parameters from one CPU generator (``draw``) and hands
them to ``step_on_views``, so a test can feed JAX's.

Under data parallelism (a process group, ``parallel.collectives``) the step
is the global batch's, as under JAX's sharding: ``images`` are this rank's
rows of the global batch, the views' draws and the mask's noise are taken
for the global batch and cut to those rows, NT-Xent's negatives span every
rank's views (``losses.contrastive``), the patch-contrastive loss stays
per sample with a global mean (``losses.dense``), the reconstruction is
the sum of every rank's masked-patch errors over the global mask count
(``losses.recon``), and the gradients are averaged over the ranks before
the clip (``train.optim.all_reduce_grads_``), so that the student and the
teacher stay equal bit for bit on every rank.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from hairci_torch.aug.ops import to_device
from hairci_torch.aug.pipelines import (
    MultiViewTransform,
    knn_transform,
    simclr_transform,
)
from hairci_torch.losses.contrastive import nt_xent_loss
from hairci_torch.losses.dense import patch_contrastive_loss
from hairci_torch.losses.recon import masked_mse_loss, patchify
from hairci_torch.models.masking import (
    draw_token_noise,
    random_token_mask_from_noise,
)
from hairci_torch.models.vit import (
    VIT_CONFIGS,
    Block,
    CrossBlock,
    LayerNorm,
    _dense,
    build_vit,
    flax_init_,
)
from hairci_torch.ssl.base import (
    eval_features,
    rank_draws,
    register_recipe,
)
from hairci_torch.ssl.mae import vit_backbone_name
from hairci_torch.train.optim import (
    all_reduce_grads_,
    clip_grad_global_norm_,
    fill_missing_grads_,
    make_optimizer,
)
from hairci_torch.train.state import TrainState, ema_update

SHAM_MODES = ("embedding", "reconstruction")


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class SHAMv1Module(nn.Module):
    """Backbone, dual projectors, cross alignment and the depth-2 decoder
    (created in both modes, as the JAX tree has it)."""

    def __init__(self, backbone_name: str = "vit_base_patch16",
                 img_size: int = 224, decoder_depth: int = 2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        # f32 weights cast per call, as Flax trains them
        self.backbone = build_vit(backbone_name, img_size=img_size,
                                  dtype=dtype, param_dtype=torch.float32)
        d, p = self.backbone.embed_dim, self.backbone.patch_size
        heads = VIT_CONFIGS[backbone_name][3]
        self.proj_global_fc1 = nn.Linear(d, 1024)
        self.proj_global_ln = LayerNorm(1024)
        self.proj_global_fc2 = nn.Linear(1024, 256)
        self.proj_local_fc = nn.Linear(d, 1024)
        self.proj_local_ln = LayerNorm(1024)
        self.cross_align = CrossBlock(d, heads, dtype)
        self.pos_map = nn.Linear(d, d)
        self.decoder_blocks = nn.ModuleList(Block(d, 8, dtype)
                                            for _ in range(decoder_depth))
        self.decoder_pred = nn.Linear(d, p * p * 3)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, d))
        flax_init_(self)

    def encode(self, x: torch.Tensor,
               ids_keep: Optional[torch.Tensor] = None):
        """(cls, mean of the patch tokens, patch tokens), f32."""
        tokens = self.backbone(x, ids_keep=ids_keep)
        patches = tokens[:, 1:]
        return tokens[:, 0], patches.mean(dim=1), patches

    def proj_global(self, pooled: torch.Tensor) -> torch.Tensor:
        h = _gelu_tanh(self.proj_global_ln(
            _dense(self.proj_global_fc1, pooled, self.dtype)))
        return _dense(self.proj_global_fc2, h, self.dtype).float()

    def proj_local(self, patches: torch.Tensor) -> torch.Tensor:
        return _gelu_tanh(self.proj_local_ln(
            _dense(self.proj_local_fc, patches, self.dtype))).float()

    def decode_masked(self, patches_vis: torch.Tensor,
                      ids_restore: torch.Tensor) -> torch.Tensor:
        """The kept patches and mask tokens unshuffled to the full grid,
        the decoder blocks and the pixel head: (B, N, p*p*3) f32."""
        B, N = ids_restore.shape
        mask_tokens = self.mask_token.expand(
            B, N - patches_vis.shape[1], -1).to(patches_vis.dtype)
        full = torch.cat([patches_vis, mask_tokens], dim=1)
        full = torch.gather(full, 1, ids_restore[..., None].expand(
            -1, -1, full.shape[-1]))
        for blk in self.decoder_blocks:
            full = blk(full)
        return _dense(self.decoder_pred, full, self.dtype).float()

    def align(self, student_patches: torch.Tensor,
              teacher_patches: torch.Tensor,
              pos_embed: torch.Tensor) -> torch.Tensor:
        s = student_patches + _dense(self.pos_map, pos_embed,
                                     self.dtype).to(student_patches.dtype)
        t = teacher_patches + pos_embed.to(teacher_patches.dtype)
        return self.cross_align(s, t)

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        return self.backbone(x, pool=True)


@register_recipe("SHAM_v1")
class SHAMv1Recipe:
    def __init__(
        self,
        backbone: str = "vit_base_patch16",
        img_size: int = 224,
        sham_mode: str = "embedding",
        mask_ratio: float = 0.75,
        temperature: float = 0.5,
        learning_rate: float = 1e-3,
        weight_decay: float = 0.0,
        betas=(0.9, 0.999),
        ema_momentum: float = 0.996,
        recon_weight: float = 1.0,
        local_weight: float = 0.5,
        dtype: torch.dtype = torch.bfloat16,
        transform: Optional[MultiViewTransform] = None,
        **_unused: Any,
    ):
        if sham_mode not in SHAM_MODES:
            raise ValueError(f"sham_mode must be one of {SHAM_MODES}, got "
                             f"{sham_mode!r}")
        self.backbone = vit_backbone_name(backbone)
        self.img_size = img_size
        self.mode = sham_mode
        self.mask_ratio = mask_ratio
        self.temperature = temperature
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.betas = tuple(betas)
        self.ema_momentum = ema_momentum
        self.recon_weight = recon_weight
        self.local_weight = local_weight
        self.dtype = dtype
        self.patch_size = VIT_CONFIGS[self.backbone][0]
        self.num_patches = (img_size // self.patch_size) ** 2
        self.transform = transform or simclr_transform(img_size)

    def create_state(self, seed: int, batch_size: int,
                     device: torch.device) -> TrainState:
        """Seeded random weights; the teacher starts as a copy."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            online = SHAMv1Module(self.backbone, self.img_size,
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
        Returns the metrics as device tensors."""
        draws = rank_draws(self.draw, gen, images)
        v_student, v_teacher = self.transform.apply(images, draws["views"])
        mask = random_token_mask_from_noise(
            to_device(draws["noise"], images.device), self.mask_ratio)
        return self.step_on_views(state, v_student, v_teacher, *mask)

    def step_on_views(self, state: TrainState, v_student: torch.Tensor,
                      v_teacher: torch.Tensor, ids_keep: torch.Tensor,
                      ids_restore: torch.Tensor, mask: torch.Tensor
                      ) -> Dict[str, torch.Tensor]:
        online, teacher = state.online, state.ema
        # the teacher follows BEFORE the step, parameters only
        ema_update(teacher, online, self.ema_momentum)
        online.train()
        teacher.eval()
        with torch.no_grad():
            _, t_pooled, t_patches = teacher.encode(v_teacher)
            t_global = teacher.proj_global(t_pooled)
            t_local = teacher.proj_local(t_patches)
        B, N, d = v_student.shape[0], self.num_patches, t_patches.shape[-1]
        pe = torch.zeros(1, N, d, device=t_patches.device)

        _, s_pooled, s_patches = online.encode(v_student, ids_keep)
        s_global = online.proj_global(s_pooled)
        metrics = {}
        recon = 0.0
        if self.mode == "reconstruction":
            pixels = online.decode_masked(s_patches, ids_restore)
            recon = masked_mse_loss(pixels,
                                    patchify(v_student, self.patch_size),
                                    mask)
            metrics["recon_loss"] = recon.detach()
        # the visible patches scattered into a zero grid at their slots
        s_pred = torch.zeros(B, N, d, dtype=s_patches.dtype,
                             device=s_patches.device).scatter(
            1, ids_keep[..., None].expand(-1, -1, d), s_patches)
        s_local = online.proj_local(online.align(s_pred, t_patches, pe))
        g_loss = nt_xent_loss(s_global, t_global, self.temperature)
        l_loss = patch_contrastive_loss(s_local, t_local, self.temperature)
        total = g_loss + self.local_weight * l_loss + self.recon_weight * recon
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        all_reduce_grads_(state.optimizer)
        # parameters without a gradient (the fixed position table, the
        # unused mask tokens, the decoder in embedding mode) as under optax
        fill_missing_grads_(state.optimizer)
        clip_grad_global_norm_(online.parameters(), 1.0)
        state.optimizer.step()
        state.step += 1
        return {"loss": total.detach(), "global_loss": g_loss.detach(),
                "local_loss": l_loss.detach(), **metrics}

    def extract_features(self, state: TrainState,
                         images: torch.Tensor) -> torch.Tensor:
        """The student backbone's final-normed cls token of the kNN view."""
        return eval_features(state.online,
                             knn_transform(images, self.img_size))
