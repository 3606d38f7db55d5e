"""SiameseIM recipe (port of ``hairci/ssl/siameseim.py``).

The online branch is a ViT-B/16 encoder without a final LayerNorm, the
projector (``decoder_embed`` to the 512-wide decoder and 2 blocks) and the
predictor (4 blocks, ``decoder_pos_mlp``, ``decoder_pred``); the momentum
branch is its EMA copy, the whole module as JAX's ``ema_params`` is the
whole tree, of which the target uses the encoder and the projector. The
decoder blocks normalise with ``PermuteBN`` (``block_norm="permute_bn"``,
the reference's default) or LayerNorm (``"ln"``). One step, as in the JAX
package:
  1. ``sim_two_view_transform``: per view a RandomResizedCrop(0.2, 1) whose
     box (top, left, h, w in pixels of the raw image) is kept, colour
     jitter (0.4, 0.4, 0.2, 0.1, p 0.8), a 23-tap blur (p 0.5) and the
     normalisation; the draws in the order crop 1, crop 2, jitter 1,
     jitter 2, blur 1, blur 2 (no flip: the JAX code has none, whatever its
     docstring says);
  2. the mask of view 1: blockwise (``random_block_mask`` then the first
     ``int(N * 0.4)`` indices of a stable sort, 78 of 196 at 224 px) or,
     without ``with_blockwise_mask``, ``random_token_mask``;
  3. the momentum branch follows the online one BEFORE the forward, its
     parameters and its PermuteBN running statistics, at the epoch's
     momentum (``momentum_for_epoch``: a cosine 0.996 -> 1 over the run's
     epochs, which the engine passes);
  4. the target: the momentum branch's encoder + projector over all of
     view 2 in TRAINING mode without gradient, so its PermuteBNs
     normalise with the batch's statistics; their running statistics are
     put back afterwards (JAX discards that forward's updates);
  5. the prediction: the online encoder over view 1's kept tokens, the
     projector, then the predictor over [cls + pe[0], visible + pe of their
     positions, mask tokens + ``decoder_pos_mlp`` of view 2's patch centres
     in view 1's frame (``relative_pos_embed``)], its last N rows through
     ``decoder_pred`` in f32;
  6. UniGrad over the (B*N, 512) rows, then AdamW (no clipping).

A step of a train-mode PermuteBN model launches bn_stats 16 times at B=64
on a card: 2 projector blocks x 2 norms over B*79 rows and 4 predictor
blocks x 2 over B*275 online, 2 x 2 over B*197 in the target; ``"ln"``
launches none. ``extract_features`` is the online encoder's raw cls token
(no final norm) of the kNN view. Weights are f32, computed in ``dtype``.

The port updates the state in place. ``train_step`` draws every random
parameter from one CPU generator (``draw``) and hands views, mask and
relative embeddings to ``step_on_views``, so a test can feed JAX's.

Under data parallelism (a process group, ``parallel.collectives``) the step
is the global batch's, as under JAX's sharding: ``images`` are this rank's
rows of the global batch, every rank draws the views' crops, jitters and
blurs and the mask's scores or noise for the global batch and keeps its
rows (``shard_sim_draws``), so its boxes and relative position table are
the one-process run's. The PermuteBNs of both branches (the target's in
training mode without gradient too) normalise with the global batch's
statistics (``models.norm``), UniGrad's means and correlation are global
(``losses.recon``), and the gradients are averaged over the ranks
(``train.optim.all_reduce_grads_``): parameters and running statistics
stay equal bit for bit.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from hairci_torch.aug import ops
from hairci_torch.aug.pipelines import knn_transform
from hairci_torch.losses.recon import unigrad_loss
from hairci_torch.models.masking import (
    draw_block_scores,
    draw_token_noise,
    mask_to_ids_keep,
    random_block_mask_from_scores,
    random_token_mask_from_noise,
)
from hairci_torch.models.vit import (
    VIT_CONFIGS,
    Block,
    _dense,
    build_vit,
    flax_init_,
    get_2d_sincos_pos_embed,
)
from hairci_torch.parallel import collectives
from hairci_torch.ssl.base import eval_features, register_recipe
from hairci_torch.ssl.mae import vit_backbone_name
from hairci_torch.train.optim import (
    all_reduce_grads_,
    fill_missing_grads_,
    make_optimizer,
)
from hairci_torch.train.schedules import cosine_schedule
from hairci_torch.train.state import TrainState, ema_update

BLUR_KERNEL = 23


def draw_sim_views(gen: torch.Generator, B: int, H: int, W: int) -> Dict:
    """The draw half of ``sim_two_view_transform``: both crops, both
    jitters, both blurs, in that order."""
    return {"crops": [torch.stack(ops.draw_crop_params(gen, B, H, W,
                                                       scale=(0.2, 1.0)))
                      for _ in range(2)],
            "jitter": [ops.draw_color_jitter(gen, B, 0.4, 0.4, 0.2, 0.1,
                                             p=0.8) for _ in range(2)],
            "blur": [ops.draw_gaussian_blur(gen, B, (0.1, 2.0), 0.5)
                     for _ in range(2)]}


def shard_sim_draws(d: Dict, lo: int, hi: int) -> Dict:
    """Images ``[lo, hi)`` of ``draw_sim_views``' draws: the crops are
    (4, B), each jitter's factors and flag and each blur's sigma and flag
    lead with B; a jitter's one op order for the batch is kept whole."""
    return {"crops": [c[:, lo:hi] for c in d["crops"]],
            "jitter": [{k: v if k == "order" else v[lo:hi]
                        for k, v in j.items()} for j in d["jitter"]],
            "blur": [tuple(t[lo:hi] for t in bl) for bl in d["blur"]]}


def sim_two_view_transform(x: torch.Tensor, d: Dict, size: int = 224
                           ) -> Tuple[torch.Tensor, ...]:
    """The apply half: uint8 (B, H, W, 3) -> (v1, v2, boxes1, boxes2), the
    boxes (B, 4) f32 (top, left, h, w) on the images' device."""
    x = ops.to_float(x)
    out, boxes = [], []
    for crop, jitter, blur in zip(d["crops"], d["jitter"], d["blur"]):
        v = ops.resized_crop(x, *crop, size)
        v = ops.color_jitter(v, jitter)
        v = ops.gaussian_blur(v, BLUR_KERNEL, *blur)
        out.append(ops.normalize(v))
        boxes.append(ops.to_device(crop.T.contiguous(), x.device))
    return out[0], out[1], boxes[0], boxes[1]


def relative_pos_embed(boxes_src: torch.Tensor, boxes_tgt: torch.Tensor,
                       grid: int, dim: int) -> torch.Tensor:
    """Sin-cos embeddings (B, grid*grid, dim) of the TARGET view's patch
    centres, at (i + 0.5) / grid of its crop, in the SOURCE crop's frame in
    patches; each axis as [sin, cos] over ``dim // 4`` frequencies, y
    first."""
    centers = (torch.arange(grid, dtype=torch.float32,
                            device=boxes_src.device) + 0.5) / grid
    cy, cx = torch.meshgrid(centers, centers, indexing="ij")
    top_s, left_s, h_s, w_s = (t[:, None] for t in boxes_src.float().T)
    top_t, left_t, h_t, w_t = (t[:, None] for t in boxes_tgt.float().T)
    ry = (top_t + cy.reshape(-1) * h_t - top_s) / h_s * grid
    rx = (left_t + cx.reshape(-1) * w_t - left_s) / w_s * grid
    half = dim // 2
    omega = 1.0 / 10000 ** (torch.arange(
        half // 2, dtype=torch.float32, device=boxes_src.device)
        / (half / 2.0))

    def enc(v):
        out = v[..., None] * omega
        return torch.cat([torch.sin(out), torch.cos(out)], dim=-1)

    return torch.cat([enc(ry), enc(rx)], dim=-1)


class SiameseIMModule(nn.Module):
    """The encoder (no final norm), projector and predictor; one module
    serves both branches, with the momentum branch's parameters."""

    def __init__(self, backbone_name: str = "vit_base_patch16",
                 img_size: int = 224, decoder_dim: int = 512,
                 decoder_num_heads: int = 16, projector_depth: int = 2,
                 predictor_depth: int = 4, block_norm: str = "permute_bn",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        # f32 weights cast per call, as Flax trains them
        self.encoder = build_vit(backbone_name, img_size=img_size,
                                 dtype=dtype, param_dtype=torch.float32,
                                 final_norm=False)
        d = self.encoder.embed_dim
        self.decoder_embed = nn.Linear(d, decoder_dim)
        self.projector_blocks = nn.ModuleList(
            Block(decoder_dim, decoder_num_heads, dtype, norm=block_norm)
            for _ in range(projector_depth))
        self.predictor_blocks = nn.ModuleList(
            Block(decoder_dim, decoder_num_heads, dtype, norm=block_norm)
            for _ in range(predictor_depth))
        self.decoder_pred = nn.Linear(decoder_dim, decoder_dim)
        self.decoder_pos_mlp = nn.Linear(2 * decoder_dim, decoder_dim)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, decoder_dim))
        # the fixed sin-cos table at the decoder's width: a constant in JAX
        self.register_buffer("decoder_pos", torch.from_numpy(
            get_2d_sincos_pos_embed(decoder_dim, self.encoder.grid_size,
                                    cls_token=True)), persistent=False)
        flax_init_(self)

    def _project(self, tokens: torch.Tensor) -> torch.Tensor:
        t = _dense(self.decoder_embed, tokens, self.dtype)
        for blk in self.projector_blocks:
            t = blk(t)
        return t

    def online_forward(self, x: torch.Tensor, ids_keep: torch.Tensor,
                       rel_pos: torch.Tensor) -> torch.Tensor:
        """View 1's kept tokens -> projector -> predictor at view 2's
        positions. rel_pos (B, N, 2*decoder_dim); returns (B, N,
        decoder_dim) f32."""
        tokens = self._project(self.encoder(x, ids_keep=ids_keep))
        pe = self.decoder_pos.to(tokens.dtype)
        vis_pe = pe[1:][ids_keep]                           # (B, K, dec)
        x2_pe = _dense(self.decoder_pos_mlp, rel_pos, self.dtype)
        B, N = rel_pos.shape[:2]
        queries = self.mask_token.expand(B, N, -1).to(tokens.dtype)
        seq = torch.cat([tokens[:, :1] + pe[None, :1],
                         tokens[:, 1:] + vis_pe, queries + x2_pe], dim=1)
        for blk in self.predictor_blocks:
            seq = blk(seq)
        return _dense(self.decoder_pred, seq[:, -N:], self.dtype).float()

    def target_forward(self, x: torch.Tensor) -> torch.Tensor:
        """All of view 2 through the encoder and the projector; the patch
        tokens (cls dropped) in f32."""
        return self._project(self.encoder(x))[:, 1:].float()

    def extract_features(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder(x, pool=True)


@register_recipe("siameseim")
class SiameseIMRecipe:
    def __init__(
        self,
        backbone: str = "vit_base_patch16",
        img_size: int = 224,
        mask_ratio: float = 0.6,
        with_blockwise_mask: bool = True,
        learning_rate: float = 1e-3,
        weight_decay: float = 0.05,
        betas=(0.9, 0.999),
        neg_weight: float = 0.02,
        lamb: Optional[float] = None,   # the JAX recipe's alias of neg_weight
        decoder_dim: int = 512,
        decoder_num_heads: int = 16,
        projector_depth: int = 2,
        predictor_depth: int = 4,
        block_norm: str = "permute_bn",
        online_ln: bool = False,
        dtype: torch.dtype = torch.bfloat16,
        epochs: int = 100,
        **_unused: Any,
    ):
        # ResNet names and vit_b_16 mean ViT-B/16 (sim_vit_base_patch16)
        self.backbone = vit_backbone_name(backbone)
        self.img_size = img_size
        self.mask_ratio = mask_ratio
        self.with_blockwise_mask = with_blockwise_mask
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.betas = tuple(betas)
        self.neg_weight = neg_weight if lamb is None else lamb
        self.decoder = dict(decoder_dim=decoder_dim,
                            decoder_num_heads=decoder_num_heads,
                            projector_depth=projector_depth,
                            predictor_depth=predictor_depth)
        self.decoder_dim = decoder_dim
        self.block_norm = block_norm
        self.online_ln = online_ln
        self.dtype = dtype
        self.epochs = epochs
        self.grid = img_size // VIT_CONFIGS[self.backbone][0]
        self.num_keep = int(self.grid * self.grid * (1 - mask_ratio))

    def momentum_for_epoch(self, epoch: int) -> float:
        return cosine_schedule(epoch, self.epochs, 0.996, 1.0)

    def create_state(self, seed: int, batch_size: int,
                     device: torch.device) -> TrainState:
        """Seeded random weights; the momentum branch starts as a copy of
        the whole module, statistics included."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            online = SiameseIMModule(self.backbone, self.img_size,
                                     block_norm=self.block_norm,
                                     dtype=self.dtype, **self.decoder)
        online = online.to(device)
        ema = copy.deepcopy(online).requires_grad_(False)
        return TrainState(
            online=online, ema=ema,
            optimizer=make_optimizer(online, self.learning_rate,
                                     self.weight_decay, self.betas))

    def draw(self, gen: torch.Generator, B: int, H: int,
             W: int) -> Dict[str, Any]:
        """The views' draws, then the mask's: block scores, or token
        noise without ``with_blockwise_mask``."""
        d: Dict[str, Any] = {"views": draw_sim_views(gen, B, H, W)}
        if self.with_blockwise_mask:
            d["scores"] = draw_block_scores(gen, B, self.grid)
        else:
            d["noise"] = draw_token_noise(gen, B, self.grid * self.grid)
        return d

    def ids_keep(self, draws: Dict[str, Any],
                 device: torch.device) -> torch.Tensor:
        """(B, num_keep) kept token indices of view 1."""
        if self.with_blockwise_mask:
            mask = random_block_mask_from_scores(
                ops.to_device(draws["scores"], device), self.grid,
                self.mask_ratio)
            return mask_to_ids_keep(mask, self.num_keep)
        return random_token_mask_from_noise(
            ops.to_device(draws["noise"], device), self.mask_ratio)[0]

    def train_step(self, state: TrainState, images: torch.Tensor,
                   gen: torch.Generator, momentum: float = 0.996
                   ) -> Dict[str, torch.Tensor]:
        """One step on a uint8 (b, H, W, 3) batch on the training device
        (this rank's rows under data parallelism). Returns the loss as a
        device tensor."""
        b, H, W, _ = images.shape
        lo = collectives.rank() * b
        draws = self.draw(gen, b * collectives.world(), H, W)
        draws = {k: shard_sim_draws(v, lo, lo + b) if k == "views"
                 else v[lo:lo + b] for k, v in draws.items()}
        v1, v2, b1, b2 = sim_two_view_transform(images, draws["views"],
                                                self.img_size)
        rel = relative_pos_embed(b1, b2, self.grid, 2 * self.decoder_dim)
        return self.step_on_views(state, v1, v2,
                                  self.ids_keep(draws, images.device), rel,
                                  momentum)

    def step_on_views(self, state: TrainState, v1: torch.Tensor,
                      v2: torch.Tensor, ids_keep: torch.Tensor,
                      rel: torch.Tensor, momentum: float = 0.996
                      ) -> Dict[str, torch.Tensor]:
        online, target = state.online, state.ema
        # the momentum branch follows BEFORE the target forward
        ema_update(target, online, momentum)
        online.train()
        target.train()
        stats = [b.clone() for b in target.buffers()]
        with torch.no_grad():
            tgt = target.target_forward(v2)
        # the batch statistics normalised the target; its running
        # statistics stay the EMA of the online ones
        torch._foreach_copy_(list(target.buffers()), stats)
        pred = online.online_forward(v1, ids_keep, rel)
        B, N, D = pred.shape
        loss = unigrad_loss(pred.reshape(B * N, D), tgt.reshape(B * N, D),
                            self.neg_weight, online_ln=self.online_ln)
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
        """The online encoder's raw cls token (no final norm) of the kNN
        view."""
        return eval_features(state.online,
                             knn_transform(images, self.img_size))
