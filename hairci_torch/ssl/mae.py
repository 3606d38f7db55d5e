"""MAE recipe (port of ``hairci/ssl/mae.py``).

One step, as in the JAX package: one view of the uint8 batch
(``mae_transform``: RandomResizedCrop(0.2, 1) and hflip), a shuffle mask
that keeps ``int(N * (1 - mask_ratio))`` tokens (49 of 196 at 224 px), the
encoder over the kept tokens only (the ViT's ``ids_keep``), then the
decoder over all N positions with the mask token in the masked ones, and
MSE on the masked patches' pixels, then Adam(W) with no gradient clipping.

The encoder is ``vit_base_patch16`` whatever backbone is asked for (a
ResNet name, or ``vit_b_16``, which the JAX package's ``VIT_CONFIGS`` lacks).
The decoder is lightly's MAEDecoderTIMM: width 512, depth 8, 16 heads
(``DECODER``), with a fixed sin-cos position table held as a non-persistent
buffer (a constant in JAX, so neither optimised nor decayed). Weights are
f32, computed in ``dtype``.

The port updates the state in place. ``train_step`` draws the view's
parameters and the mask's noise from one CPU generator (``draw``) and hands
the view and mask to ``step_on_view``, so a test can feed JAX's.

Under data parallelism (a process group, ``parallel.collectives``) the step
is the global batch's, as under JAX's sharding: ``images`` are this rank's
rows of the global batch, the view's draws and the mask's noise are taken
for the global batch and cut to those rows, the loss is the sum of every
rank's masked-patch errors over the global mask count
(``losses.recon``), and the gradients are averaged over the ranks
(``train.optim.all_reduce_grads_``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from hairci_torch.aug.ops import to_device
from hairci_torch.aug.pipelines import (
    MultiViewTransform,
    knn_transform,
    mae_transform,
)
from hairci_torch.losses.recon import masked_mse_loss, patchify
from hairci_torch.models.masking import (
    draw_token_noise,
    random_token_mask_from_noise,
)
from hairci_torch.models.vit import (
    VIT_CONFIGS,
    Block,
    LayerNorm,
    _dense,
    build_vit,
    flax_init_,
    get_2d_sincos_pos_embed,
)
from hairci_torch.ssl.base import (
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

# lightly MAEDecoderTIMM's defaults
DECODER = {"embed_dim": 512, "depth": 8, "num_heads": 16}
# names the masked-image recipes take for ViT-B/16
VIT_B_ALIASES = ("resnet18", "resnet50", "vit_b_16")


def vit_backbone_name(backbone: str) -> str:
    """The ViT a masked-image recipe builds for ``backbone``: ResNet names
    and ``vit_b_16`` mean ``vit_base_patch16``."""
    return "vit_base_patch16" if backbone in VIT_B_ALIASES else backbone


class MAEDecoder(nn.Module):
    """The visible tokens (cls first) -> pixel predictions of every patch."""

    def __init__(self, in_dim: int, patch_size: int = 16,
                 embed_dim: int = 512, depth: int = 8, num_heads: int = 16,
                 grid_size: int = 14, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.embed = nn.Linear(in_dim, embed_dim)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.register_buffer("pos_embed", torch.from_numpy(
            get_2d_sincos_pos_embed(embed_dim, grid_size, cls_token=True)
        )[None], persistent=False)
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, dtype)
                                    for _ in range(depth))
        self.norm = LayerNorm(embed_dim)
        self.pred = nn.Linear(embed_dim, patch_size ** 2 * 3)

    def forward(self, enc_tokens: torch.Tensor,
                ids_restore: torch.Tensor) -> torch.Tensor:
        """enc_tokens (B, K+1, D_enc); ids_restore (B, N). Returns
        (B, N, p*p*3) f32."""
        B, N = ids_restore.shape
        x = _dense(self.embed, enc_tokens, self.dtype)
        cls, vis = x[:, :1], x[:, 1:]
        # tiled, then cast, as in JAX
        mask_tokens = self.mask_token.expand(
            B, N - vis.shape[1], -1).to(x.dtype)
        full = torch.cat([vis, mask_tokens], dim=1)
        full = torch.gather(full, 1, ids_restore[..., None].expand(
            -1, -1, x.shape[-1]))
        pe = self.pos_embed.to(x.dtype)
        x = torch.cat([cls + pe[:, :1], full + pe[:, 1:]], dim=1)
        for blk in self.blocks:
            x = blk(x)
        x = _dense(self.pred, self.norm(x), self.dtype)
        return x[:, 1:].float()


class MAEModule(nn.Module):
    """``encoder`` (the ViT) + ``decoder``."""

    def __init__(self, backbone_name: str = "vit_base_patch16",
                 img_size: int = 224, dtype: torch.dtype = torch.float32):
        super().__init__()
        # f32 weights cast per call, as Flax trains them
        self.encoder = build_vit(backbone_name, img_size=img_size,
                                 dtype=dtype, param_dtype=torch.float32)
        self.decoder = MAEDecoder(
            self.encoder.embed_dim, self.encoder.patch_size,
            grid_size=self.encoder.grid_size, dtype=dtype, **DECODER)
        flax_init_(self.decoder)

    def forward(self, images: torch.Tensor, ids_keep: torch.Tensor,
                ids_restore: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.encoder(images, ids_keep=ids_keep),
                            ids_restore)

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x, pool=True)


@register_recipe("mae")
class MAERecipe:
    def __init__(
        self,
        backbone: str = "vit_base_patch16",
        img_size: int = 224,
        mask_ratio: float = 0.75,
        learning_rate: float = 1e-3,
        weight_decay: float = 0.0,
        betas=(0.9, 0.999),
        dtype: torch.dtype = torch.bfloat16,
        transform: Optional[MultiViewTransform] = None,
        norm_pix: bool = False,
        **_unused: Any,
    ):
        self.backbone = vit_backbone_name(backbone)
        self.img_size = img_size
        self.mask_ratio = mask_ratio
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.betas = tuple(betas)
        self.dtype = dtype
        self.norm_pix = norm_pix
        self.patch_size = VIT_CONFIGS[self.backbone][0]
        self.num_patches = (img_size // self.patch_size) ** 2
        self.transform = transform or mae_transform(img_size)

    def create_state(self, seed: int, batch_size: int,
                     device: torch.device) -> TrainState:
        """Seeded random weights; no EMA teacher."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            online = MAEModule(self.backbone, self.img_size, self.dtype)
        online = online.to(device)
        return TrainState(
            online=online,
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
        (view,) = self.transform.apply(images, draws["views"])
        ids_keep, ids_restore, mask = random_token_mask_from_noise(
            to_device(draws["noise"], view.device), self.mask_ratio)
        return self.step_on_view(state, view, ids_keep, ids_restore, mask)

    def step_on_view(self, state: TrainState, view: torch.Tensor,
                     ids_keep: torch.Tensor, ids_restore: torch.Tensor,
                     mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        online = state.online
        online.train()
        state.optimizer.zero_grad(set_to_none=True)
        pred = online(view, ids_keep, ids_restore)
        loss = masked_mse_loss(pred, patchify(view, self.patch_size), mask,
                               norm_pix=self.norm_pix)
        loss.backward()
        all_reduce_grads_(state.optimizer)
        # the encoder's fixed position table and unused mask token decay
        fill_missing_grads_(state.optimizer)
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach()}

    def extract_features(self, state: TrainState,
                         images: torch.Tensor) -> torch.Tensor:
        """The encoder's final-normed cls token of the kNN view."""
        return eval_features(state.online,
                             knn_transform(images, self.img_size))
