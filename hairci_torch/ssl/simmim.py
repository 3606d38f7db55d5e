"""SimMIM recipe (port of ``hairci/ssl/simmim.py``).

Unlike MAE, the encoder sees every position: the masked patch embeddings
are replaced by a learned mask token, a fixed sin-cos table without a cls
token is added (a non-persistent buffer: a constant in JAX), the blocks and
an f32 LayerNorm (eps 1e-6) follow, and a linear decoder predicts each
patch's pixels; the loss is L1 on the masked patches. The mask is the
shuffle mask at ratio 0.6 (78 of 196 tokens kept at 224 px), made boolean by
``> 0.5``. ``extract_features`` is the mean of the normed tokens. Adam(W),
no gradient clipping.

The ViT is ``vit_base_patch16`` whatever backbone is asked for (a ResNet
name, or ``vit_b_16``, which the JAX package's ``VIT_CONFIGS`` lacks).
Weights are f32, computed in ``dtype``. ``train_step`` draws from one CPU
generator (``draw``) and hands the view and mask to ``step_on_view``.

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
    simmim_transform,
)
from hairci_torch.losses.recon import masked_l1_loss, patchify
from hairci_torch.models.masking import (
    draw_token_noise,
    random_token_mask_from_noise,
)
from hairci_torch.models.vit import (
    VIT_CONFIGS,
    Block,
    LayerNorm,
    PatchEmbed,
    _dense,
    flax_init_,
    get_2d_sincos_pos_embed,
)
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
from hairci_torch.train.state import TrainState


class SimMIMModule(nn.Module):
    def __init__(self, backbone_name: str = "vit_base_patch16",
                 img_size: int = 224, dtype: torch.dtype = torch.float32):
        super().__init__()
        p, d, depth, heads = VIT_CONFIGS[backbone_name]
        self.dtype = dtype
        self.patch_size, self.embed_dim, self.depth = p, d, depth
        self.global_pool = False       # the torchvision reader asks
        grid = img_size // p
        self.patch_embed = PatchEmbed(p, d, dtype)
        self.blocks = nn.ModuleList(Block(d, heads, dtype)
                                    for _ in range(depth))
        self.mask_token = nn.Parameter(torch.zeros(1, 1, d))
        self.decoder = nn.Linear(d, p * p * 3)
        self.norm = LayerNorm(d)
        self.register_buffer("pos_embed", torch.from_numpy(
            get_2d_sincos_pos_embed(d, grid, cls_token=False))[None],
            persistent=False)
        flax_init_(self)

    def encode(self, x: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, N, D) f32 normed tokens; ``mask`` (B, N) bool, True = mask
        token in place of the patch embedding."""
        tokens = self.patch_embed(x.to(self.dtype))
        if mask is not None:
            tokens = torch.where(mask[..., None],
                                 self.mask_token.to(tokens.dtype), tokens)
        tokens = tokens + self.pos_embed.to(tokens.dtype)
        for blk in self.blocks:
            tokens = blk(tokens)
        return self.norm(tokens)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """(B, N, p*p*3) f32 pixel predictions."""
        return _dense(self.decoder, self.encode(x, mask), self.dtype).float()

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        return self.encode(x).mean(dim=1)


@register_recipe("simMIM")
class SimMIMRecipe:
    def __init__(
        self,
        backbone: str = "vit_base_patch16",
        img_size: int = 224,
        mask_ratio: float = 0.6,
        learning_rate: float = 1e-3,
        weight_decay: float = 0.0,
        betas=(0.9, 0.999),
        dtype: torch.dtype = torch.bfloat16,
        transform: Optional[MultiViewTransform] = None,
        **_unused: Any,
    ):
        self.backbone = vit_backbone_name(backbone)
        self.img_size = img_size
        self.mask_ratio = mask_ratio
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.betas = tuple(betas)
        self.dtype = dtype
        self.patch_size = VIT_CONFIGS[self.backbone][0]
        self.num_patches = (img_size // self.patch_size) ** 2
        self.transform = transform or simmim_transform(img_size)

    def create_state(self, seed: int, batch_size: int,
                     device: torch.device) -> TrainState:
        """Seeded random weights; no EMA teacher."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            online = SimMIMModule(self.backbone, self.img_size, self.dtype)
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
        _, _, maskf = random_token_mask_from_noise(
            to_device(draws["noise"], view.device), self.mask_ratio)
        return self.step_on_view(state, view, maskf > 0.5)

    def step_on_view(self, state: TrainState, view: torch.Tensor,
                     mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        online = state.online
        online.train()
        state.optimizer.zero_grad(set_to_none=True)
        pred = online(view, mask)
        loss = masked_l1_loss(pred, patchify(view, self.patch_size), mask)
        loss.backward()
        all_reduce_grads_(state.optimizer)
        fill_missing_grads_(state.optimizer)
        state.optimizer.step()
        state.step += 1
        return {"loss": loss.detach()}

    def extract_features(self, state: TrainState,
                         images: torch.Tensor) -> torch.Tensor:
        """Mean of the normed tokens of the kNN view."""
        return eval_features(state.online,
                             knn_transform(images, self.img_size))
