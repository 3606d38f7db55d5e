"""Vision Transformer (port of ``hairci/models/vit.py``): the eval forward
of the encoders and the training forward of SHAM.

State-dict keys follow timm's layout (``cls_token``, ``pos_embed``,
``patch_embed.proj``, ``blocks.N.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,
mlp.fc2}``, ``norm``, ``fc_norm``), the layout ``export_vit`` writes, so JAX
params load with ``strict=True`` through ``models.convert``.

Numerics follow the Flax modules:
  * Dense and conv layers compute in the module's ``dtype``; their weights
    are cast to it on every call, as Flax casts its f32 params. The weights
    are stored in ``param_dtype``: f32 for training (the optimizer updates
    f32 weights, as optax does), or ``dtype`` itself for serving, where the
    per-call cast is then a no-op.
  * LayerNorm is pinned to f32 (params and output), eps 1e-6, with the
    variance taken as E[x^2] - E[x]^2 like Flax.
  * The residual stream is in the module dtype; with LayerScale
    (``init_values``, DINOv2) it is f32 from block 0 on, as in JAX, where
    the f32 ``gamma`` promotes each branch before the residual add.
  * GELU is exact erf in f32 and the tanh approximation in bf16.
  * Attention is two matmuls and a softmax: scores come out in bf16 when the
    module runs in bf16 and are scaled in bf16; softmax runs in f32 and is
    cast back.
  * The sin-cos position table is fixed (Flax's ``stop_gradient``): it
    takes no gradient.
Input images are NHWC, as in the JAX package.

``remat`` recomputes activations in the backward pass instead of keeping
them, with the JAX package's modes, on ``torch.utils.checkpoint``:
``False`` keeps everything; ``True`` / ``"full"`` checkpoints every block;
``"selective"`` only the scores -> softmax -> .v core of each attention
(the (B, H, N, N) tensors JAX's policy drops); ``"half"`` the even blocks
0, 2, 4, ... and runs the odd ones plain. Only the blocks are checkpointed,
and only with grad mode on; the parameters and the results do not change.

Token masking, as in the JAX package: ``token_mask`` (B, N) bool puts the
learned ``mask_token`` in place of the masked patch embeddings, before the
position table is added (SimMIM, iBOT); ``ids_keep`` (B, K) gathers the kept
tokens after the table is added and before ``cls`` is prepended (MAE). An
input of another resolution gets the position table resized bilinearly
(``resize_pos_embed``, antialiased when it shrinks, as ``jax.image.resize``).

LayerScale (``init_values``) holds timm's ``blocks.N.ls1.gamma`` /
``ls2.gamma``, the keys ``export_vit`` writes. ``Block(norm="permute_bn")``
normalises with ``heads.PermuteBN`` (SiameseIM's decoder blocks) in place
of LayerNorm: batch statistics in training mode, running ones in eval mode.
``CrossAttention`` / ``CrossBlock`` (SHAM v1's alignment) take their scores
in f32 whatever the module dtype, as the JAX einsum's
``preferred_element_type`` does. ``final_norm=False`` (SiameseIM's encoder)
returns the tokens and the cls feature without the final LayerNorm, which
is kept in the state dict all the same, as the JAX tree keeps it.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from hairci_torch.models.heads import PermuteBN

REMAT_MODES = (False, True, "full", "selective", "half")


# ---------------------------------------------------------------------------
# positional embeddings
# ---------------------------------------------------------------------------

def get_2d_sincos_pos_embed(embed_dim: int, grid_size: int,
                            cls_token: bool = False) -> np.ndarray:
    """2-D sin-cos position embedding, (grid*grid [+1], D) float32."""
    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)  # w goes first
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_size, grid_size])
    emb_h = _sincos_1d(embed_dim // 2, grid[0])
    emb_w = _sincos_1d(embed_dim // 2, grid[1])
    pos_embed = np.concatenate([emb_h, emb_w], axis=1)
    if cls_token:
        pos_embed = np.concatenate(
            [np.zeros([1, embed_dim], dtype=np.float32), pos_embed], axis=0
        )
    return pos_embed


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    if embed_dim % 2:
        raise ValueError(f"sin-cos embedding needs an even width, got "
                         f"{embed_dim}")
    omega = np.arange(embed_dim // 2, dtype=np.float32) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    pos = pos.reshape(-1)
    out = np.einsum("m,d->md", pos, omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def resize_pos_embed(pos_embed: torch.Tensor, new_grid: int,
                     old_grid: int, num_prefix: int = 1) -> torch.Tensor:
    """Bilinear resize of (1, prefix + old_grid^2, D) position embeddings to
    ``new_grid`` (``hairci/models/vit.py:resize_pos_embed``). Half-pixel
    centres; shrinking widens the triangle kernel by the scale
    (``antialias=True``), as ``jax.image.resize(..., "bilinear")`` does.
    Computed in f32."""
    prefix = pos_embed[:, :num_prefix]
    d = pos_embed.shape[-1]
    grid = pos_embed[:, num_prefix:].float().reshape(1, old_grid, old_grid, d)
    grid = F.interpolate(grid.permute(0, 3, 1, 2), size=(new_grid, new_grid),
                         mode="bilinear", align_corners=False, antialias=True)
    patches = grid.permute(0, 2, 3, 1).reshape(1, new_grid * new_grid, d)
    return torch.cat([prefix.float(), patches], dim=1)


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact erf GELU in f32; the tanh approximation in bf16."""
    return F.gelu(x, approximate="tanh" if x.dtype == torch.bfloat16
                  else "none")


def _dense(layer: nn.Linear, x: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """Flax Dense(dtype=...): input, kernel and bias cast to ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


class LayerNorm(nn.Module):
    """Flax LayerNorm(epsilon=1e-6, dtype=float32): f32 params and output,
    var = E[x^2] - E[x]^2 clipped at 0."""

    eps = 1e-6

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean, min=0)
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) \
            + self.bias


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _dense(self.fc2, gelu(_dense(self.fc1, x, self.dtype)),
                      self.dtype)


def _attention_core(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v: scores in bf16 for bf16 inputs, else
    f32; the softmax in f32, cast back to v's dtype."""
    if q.dtype != torch.bfloat16:
        q, k = q.float(), k.float()
    attn = torch.matmul(q, k.transpose(-2, -1)) * q.shape[-1]**-0.5
    attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
    return torch.matmul(attn, v)


class Attention(nn.Module):
    """Multi-head self-attention with f32 softmax; scores in bf16 when the
    module computes in bf16 (``hairci/models/vit.py:Attention``)."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 remat_core: bool = False):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.remat_core = remat_core
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        head_dim = D // self.num_heads
        qkv = _dense(self.qkv, x, self.dtype).reshape(
            B, N, 3, self.num_heads, head_dim)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each (B, H, N, hd)
        if self.remat_core and torch.is_grad_enabled():
            out = checkpoint(_attention_core, q, k, v, use_reentrant=False)
        else:
            out = _attention_core(q, k, v)
        return _dense(self.proj, out.transpose(1, 2).reshape(B, N, D),
                      self.dtype)


class CrossAttention(nn.Module):
    """Query tokens attend to key/value tokens
    (``hairci/models/vit.py:CrossAttention``): ``kv`` packs k then v; the
    scores are f32 for every dtype, the probabilities are cast back to the
    module dtype for the product with v."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.num_heads = num_heads
        self.dtype = dtype
        self.q = nn.Linear(dim, dim)
        self.kv = nn.Linear(dim, 2 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, q_tokens: torch.Tensor,
                kv_tokens: torch.Tensor) -> torch.Tensor:
        B, Nq, D = q_tokens.shape
        Nk = kv_tokens.shape[1]
        head_dim = D // self.num_heads
        q = _dense(self.q, q_tokens, self.dtype).reshape(
            B, Nq, self.num_heads, head_dim).transpose(1, 2)
        k, v = _dense(self.kv, kv_tokens, self.dtype).reshape(
            B, Nk, 2, self.num_heads, head_dim).permute(2, 0, 3, 1, 4)
        out = _attention_core(q.float(), k.float(), v)
        return _dense(self.proj, out.transpose(1, 2).reshape(B, Nq, D),
                      self.dtype)


class LayerScale(nn.Module):
    """x * gamma with an f32 ``gamma`` (the reference pins LayerScale to
    f32), so a bf16 branch comes out in f32."""

    def __init__(self, dim: int, init_values: float):
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Block(nn.Module):
    """Pre-norm self-attention + MLP; ``norm`` is ``"ln"`` or
    ``"permute_bn"``."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype,
                 remat_core: bool = False,
                 init_values: Optional[float] = None, norm: str = "ln"):
        super().__init__()
        if norm not in ("ln", "permute_bn"):
            raise ValueError(f"unknown block norm {norm!r}")
        norm_cls = LayerNorm if norm == "ln" else PermuteBN
        self.norm1 = norm_cls(dim)
        self.attn = Attention(dim, num_heads, dtype, remat_core)
        self.norm2 = norm_cls(dim)
        self.mlp = Mlp(dim, 4 * dim, dtype)
        if init_values is not None:
            self.ls1 = LayerScale(dim, init_values)
            self.ls2 = LayerScale(dim, init_values)
        self.layer_scale = init_values is not None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.layer_scale:
            x = x + self.attn(self.norm1(x))
            return x + self.mlp(self.norm2(x))
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class CrossBlock(nn.Module):
    """Pre-norm cross-attention + MLP (``hairci/models/vit.py:CrossBlock``):
    ``norm_q`` and ``norm_kv`` before ``xattn``, ``norm2`` before ``mlp``."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype):
        super().__init__()
        self.norm_q = LayerNorm(dim)
        self.norm_kv = LayerNorm(dim)
        self.xattn = CrossAttention(dim, num_heads, dtype)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, 4 * dim, dtype)

    def forward(self, q_tokens: torch.Tensor,
                kv_tokens: torch.Tensor) -> torch.Tensor:
        q_tokens = q_tokens + self.xattn(self.norm_q(q_tokens),
                                         self.norm_kv(kv_tokens))
        return q_tokens + self.mlp(self.norm2(q_tokens))


class PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, embed_dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) -> (B, H*W/p^2, D), rows of patches in raster order."""
        x = self.proj._conv_forward(
            x.permute(0, 3, 1, 2).to(self.dtype),
            self.proj.weight.to(self.dtype), self.proj.bias.to(self.dtype))
        return x.flatten(2).transpose(1, 2)


@torch.no_grad()
def flax_init_(module: nn.Module,
               generator: Optional[torch.Generator] = None) -> None:
    """Flax's initialisers over ``module``'s parameters, in order: N(0, 0.02)
    for ``cls_token`` / ``mask_token``, lecun-normal for dense and conv
    kernels (truncated at 2 sigma and rescaled to unit variance over the
    truncation), zero biases; LayerNorm scales keep their ones."""
    for name, p in module.named_parameters():
        if name.split(".")[-1] in ("cls_token", "mask_token"):
            nn.init.normal_(p, std=0.02, generator=generator)
        elif name.endswith(".weight") and p.dim() > 1:
            fan_in = p[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
        elif name.endswith(".bias"):
            nn.init.zeros_(p)


# ---------------------------------------------------------------------------
# the transformer
# ---------------------------------------------------------------------------

class VisionTransformer(nn.Module):
    """ViT encoder. ``forward(x, ids_keep=None, pool=False,
    token_mask=None)`` takes NHWC images and returns the final-normed token
    sequence (B, K+1, D) in f32 with cls first (K = N, or the kept count of
    ``ids_keep``), or pooled (B, D) features when ``pool=True``: mean of
    patch tokens + fc_norm when ``global_pool``, else the final-normed cls
    token. With ``final_norm=False`` the tokens and the cls token are the
    last block's, in the module dtype.

    Parameters are drawn from ``generator`` (lecun-normal dense and conv
    kernels as in Flax, zero biases, N(0, 0.02) cls/mask tokens, fixed
    sin-cos position table, LayerScale ``gamma`` = ``init_values``) in f32
    on the CPU, then the dense and conv weights are cast to ``param_dtype``
    (default ``dtype``); so one seed gives the same weights in every dtype
    and on every device.
    """

    def __init__(self, patch_size: int = 16, embed_dim: int = 768,
                 depth: int = 12, num_heads: int = 12, img_size: int = 224,
                 dtype: torch.dtype = torch.float32,
                 global_pool: bool = False,
                 generator: Optional[torch.Generator] = None,
                 param_dtype: Optional[torch.dtype] = None,
                 remat: Any = False, init_values: Optional[float] = None,
                 final_norm: bool = True):
        super().__init__()
        if remat not in REMAT_MODES:
            raise ValueError(f"remat must be one of {REMAT_MODES}, got "
                             f"{remat!r}")
        self.embed_dim = self.num_features = embed_dim
        self.depth = depth
        self.dtype = dtype
        self.global_pool = global_pool
        self.final_norm = final_norm
        self.remat = remat
        self.patch_size = patch_size
        self.grid_size = grid = img_size // patch_size
        self.num_patches = grid * grid
        self.patch_embed = PatchEmbed(patch_size, embed_dim, dtype)
        # the mask token is used by ``token_mask`` only; it is always kept so
        # the key set matches the JAX tree (export_vit writes it)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.from_numpy(get_2d_sincos_pos_embed(
                embed_dim, grid, cls_token=True))[None],
            requires_grad=False)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, dtype, remat == "selective",
                  init_values)
            for _ in range(depth))
        self.norm = LayerNorm(embed_dim)
        if global_pool:
            self.fc_norm = LayerNorm(embed_dim)
        flax_init_(self, generator)
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                m.to(param_dtype or dtype)

    def _remat_block(self, i: int) -> bool:
        if self.remat == "half":
            return i % 2 == 0
        return self.remat in (True, "full")

    def forward(self, x: torch.Tensor,
                ids_keep: Optional[torch.Tensor] = None, pool: bool = False,
                token_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B = x.shape[0]
        tokens = self.patch_embed(x.to(self.dtype))
        if token_mask is not None:
            tokens = torch.where(token_mask[..., None],
                                 self.mask_token.to(tokens.dtype), tokens)
        pos_embed = self.pos_embed
        if tokens.shape[1] != self.num_patches:
            # another resolution (multi-crop views): resize the table
            pos_embed = resize_pos_embed(
                pos_embed, int(tokens.shape[1] ** 0.5), self.grid_size)
        tokens = tokens + pos_embed[:, 1:].to(tokens.dtype)
        if ids_keep is not None:
            # a permutation's rows: the backward scatters no index twice
            tokens = torch.gather(tokens, 1, ids_keep[..., None].expand(
                -1, -1, tokens.shape[-1]))
        cls = (self.cls_token + pos_embed[:, :1]).to(tokens.dtype)
        tokens = torch.cat([cls.expand(B, -1, -1), tokens], dim=1)
        for i, blk in enumerate(self.blocks):
            if self._remat_block(i) and torch.is_grad_enabled():
                tokens = checkpoint(blk, tokens, use_reentrant=False)
            else:
                tokens = blk(tokens)
        normed = self.norm(tokens) if self.final_norm else tokens
        if not pool:
            return normed
        if self.global_pool:
            return self.fc_norm(tokens[:, 1:].mean(dim=1))
        return normed[:, 0]


VIT_CONFIGS = {
    # name: (patch, dim, depth, heads)
    "vit_tiny_patch16": (16, 192, 12, 3),
    "vit_small_patch16": (16, 384, 12, 6),
    "vit_base_patch16": (16, 768, 12, 12),
    "vit_large_patch16": (16, 1024, 24, 16),
    "vit_huge_patch14": (14, 1280, 32, 16),
}


def build_vit(name: str, img_size: int = 224,
              dtype: torch.dtype = torch.float32, **kw) -> VisionTransformer:
    if name not in VIT_CONFIGS:
        raise ValueError(f"unknown vit {name!r}; choices: {sorted(VIT_CONFIGS)}")
    p, d, depth, h = VIT_CONFIGS[name]
    return VisionTransformer(patch_size=p, embed_dim=d, depth=depth,
                             num_heads=h, img_size=img_size, dtype=dtype, **kw)
