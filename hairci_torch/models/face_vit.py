"""Face-recognition ViT family (port of ``hairci/models/face_vit.py``):

  * ``ViTFace``: the reference's einops-style ``ViT_face`` (a Dense layer on
    flattened patches, learned cls token and position table, pre-norm
    blocks; dim 512, depth 20, 8 heads x 64, mlp 2048 at 112 px, patch 8)
    and, with ``overlapping=True``, ``ViTs_face`` (12 x 12 windows at stride
    8, pad 4, as ``nn.Unfold`` cuts them: 196 patches at 112 px as well);
  * ``margin_logits``: the Softmax / CosFace / ArcFace / SFace heads on the
    (num_class, dim) classifier weight, and ``sface_loss``;
  * ``tp_margin_logits``: the same head with the weight's class rows split
    over the ``model`` group of a mesh (tensor parallelism).

Numerics follow the Flax modules:
  * the residual stream is in the module's ``dtype``; each Dense layer casts
    its input, kernel and bias to it, as Flax casts its f32 params;
  * every LayerNorm is Flax's default (f32 params and output, eps 1e-6), not
    torch's 1e-5;
  * attention scales by the MODEL width, ``dim ** -0.5``, not the head width
    (the reference's ``self.scale = dim ** -0.5``, kept for its
    checkpoints); the qkv projection has no bias and ``heads * dim_head``
    need not equal ``dim``. The scores and ``attn @ v`` take the module's
    dtype in and sum in f32 (``preferred_element_type=float32``); the
    softmax is f32 and its output is cast back to v's dtype;
  * GELU is ``models.vit.gelu``: exact in f32, tanh in bf16;
  * the cls token and the position table are cast to the stream's dtype.

The classifier weight ``loss_weight`` (num_class, dim) and, for Softmax only,
``loss_bias`` exist on every path (the reference builds its margin head in
``__init__``), so a reference checkpoint loads with ``strict=True``
(``models.convert.face_vit_state_dict``). They stay in f32. Input images are
NHWC, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from hairci_torch.models.vit import LayerNorm, _dense, gelu
from hairci_torch.parallel import collectives

LOSS_TYPES = ("Softmax", "CosFace", "ArcFace", "SFace")


# ---------------------------------------------------------------------------
# margin heads
# ---------------------------------------------------------------------------

def _norm(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def margin_logits(w: torch.Tensor, emb: torch.Tensor,
                  label: Optional[torch.Tensor], loss_type: str,
                  s: float = 64.0, m: float = 0.35, arc_m: float = 0.5,
                  bias: Optional[torch.Tensor] = None,
                  class_offset: int = 0) -> torch.Tensor:
    """Margin-softmax logits (B, num_class) in f32 from the (num_class, dim)
    classifier weight ``w``; ``label=None`` gives the scaled cosines. ``w``
    may be a block of the classes that starts at ``class_offset``: the
    one-hot then marks the labels in that block."""
    if loss_type == "Softmax":
        out = torch.matmul(emb.float(), w.float().T)
        return out + bias if bias is not None else out
    cos = torch.matmul(_norm(emb.float()), _norm(w.float()).T)
    cos = torch.clamp(cos, -1.0, 1.0)
    if label is None:
        return s * cos
    cls = torch.arange(class_offset, class_offset + w.shape[0],
                       device=cos.device)
    onehot = (label.long()[:, None] == cls).to(cos.dtype)
    if loss_type == "CosFace":
        phi = cos - m
    elif loss_type == "ArcFace":
        sine = torch.sqrt(torch.clamp(1.0 - cos**2, min=0.0))
        phi = cos * math.cos(arc_m) - sine * math.sin(arc_m)
        # the easy-margin guard (the reference's `vit_face.py:113-118`)
        phi = torch.where(cos > math.cos(math.pi - arc_m), phi,
                          cos - math.sin(math.pi - arc_m) * arc_m)
    elif loss_type == "SFace":
        # SFace returns the scaled cosines; its gating lives in sface_loss
        phi = cos
    else:
        raise ValueError(f"unknown loss_type {loss_type!r}")
    return s * (onehot * phi + (1.0 - onehot) * cos)


def tp_margin_logits(w_shard: torch.Tensor, emb: torch.Tensor,
                     label: Optional[torch.Tensor], loss_type: str, group,
                     s: float = 64.0, m: float = 0.35, arc_m: float = 0.5,
                     bias_shard: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """``margin_logits`` with the classifier's class rows split over
    ``group`` (the ``model`` axis: ``Mesh.group(MODEL_AXIS)``, the split
    ``parallel.model_sharding(mesh, axis=0, ndim=2)`` describes):
    ``w_shard`` (and, for Softmax, ``bias_shard``) is this rank's
    contiguous block of rows, in group-rank order. Each rank computes its
    classes' logits and the (B, num_class) logits are gathered over the
    group. The embeddings enter through ``copy_to_group`` (their gradient
    is the sum of every shard's) and the logits leave through
    ``gather_from_group`` (the weight's gradient is the loss's, not the
    group size's multiple of it). The ranks of the group must hold the
    same ``emb`` rows. Without a process group, ``margin_logits`` on the
    one shard."""
    lo = dist.get_rank(group) * w_shard.shape[0] \
        if collectives.active() else 0
    out = margin_logits(w_shard, collectives.copy_to_group(emb, group),
                        label, loss_type, s, m, arc_m, bias_shard, lo)
    # the (rows, B) blocks of every shard, stacked in class order
    return collectives.gather_from_group(out.T.contiguous(), group).T


def sface_loss(cos: torch.Tensor, label: torch.Tensor, s: float = 64.0,
               k: float = 80.0, a: float = 0.90, b: float = 1.2
               ) -> torch.Tensor:
    """SFace: a sigmoid-weighted intra-class pull and inter-class push on the
    cosine logits; the sigmoid gates take no gradient (the reference
    detaches them)."""
    onehot = F.one_hot(label.long(), cos.shape[1]).to(cos.dtype)
    cos_target = torch.sum(cos * onehot, dim=1)
    w_intra = torch.sigmoid(-k * (cos_target - a)).detach()
    cos_others = torch.where(onehot > 0, -1.0, cos)
    w_inter = torch.sigmoid(k * (cos_others - (b - 1.0))).detach()
    intra = -torch.mean(s * w_intra * cos_target)
    inter = torch.mean(torch.sum(
        s * w_inter * torch.clamp(cos_others, min=0.0), dim=1))
    return intra + inter


# ---------------------------------------------------------------------------
# transformer (einops-ViT style: pre-norm, learned position table)
# ---------------------------------------------------------------------------

def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of inputs in their own dtype, summed in f32."""
    return torch.matmul(a.float(), b.float())


class PreNormAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int,
                 dtype: torch.dtype):
        super().__init__()
        self.heads, self.dim_head, self.dtype = heads, dim_head, dtype
        inner = heads * dim_head
        self.norm = LayerNorm(dim)
        self.to_qkv = nn.Linear(dim, 3 * inner, bias=False)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, D = x.shape
        y = self.norm(x).to(self.dtype)
        qkv = F.linear(y, self.to_qkv.weight.to(self.dtype)).reshape(
            B, N, 3, self.heads, self.dim_head)
        q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each (B, H, N, dh)
        attn = torch.softmax(_mm_f32(q, k.transpose(-2, -1))
                             * float(D) ** -0.5, dim=-1)
        out = _mm_f32(attn.to(v.dtype), v)
        out = out.transpose(1, 2).reshape(B, N, -1).to(x.dtype)
        return x + _dense(self.to_out, out, self.dtype)


class PreNormFF(nn.Module):
    def __init__(self, dim: int, mlp_dim: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.norm = LayerNorm(dim)
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = gelu(_dense(self.fc1, self.norm(x), self.dtype))
        return x + _dense(self.fc2, y, self.dtype)


class FaceBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int, mlp_dim: int,
                 dtype: torch.dtype):
        super().__init__()
        self.attn = PreNormAttention(dim, heads, dim_head, dtype)
        self.ff = PreNormFF(dim, mlp_dim, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ff(self.attn(x))


class ViTFace(nn.Module):
    """``ViT_face`` / ``ViTs_face``. ``forward(img, label=None)`` takes NHWC
    images and returns the f32 embeddings (B, dim), or with labels
    ``(margin_logits, embeddings)``.

    Parameters are drawn from ``generator`` in f32 on the CPU as Flax
    initialises them (lecun-normal Dense kernels, zero biases, N(0, 1) cls
    token and position table, a Xavier-uniform classifier weight), then the
    Dense weights are cast to ``dtype``; so one seed gives the same weights
    in every dtype and on every device.
    """

    def __init__(self, image_size: int = 112, patch_size: int = 8,
                 dim: int = 512, depth: int = 20, heads: int = 8,
                 dim_head: int = 64, mlp_dim: int = 2048, pool: str = "cls",
                 num_class: int = 93431, loss_type: str = "CosFace",
                 overlapping: bool = False, ac_patch_size: int = 12,
                 pad: int = 4, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if loss_type not in LOSS_TYPES:
            raise ValueError(f"unknown loss_type {loss_type!r}")
        self.patch_size, self.dim, self.depth = patch_size, dim, depth
        self.pool, self.loss_type, self.dtype = pool, loss_type, dtype
        self.overlapping, self.ac_patch_size, self.pad = (
            overlapping, ac_patch_size, pad)
        if overlapping:
            grid = (image_size + 2 * pad - ac_patch_size) // patch_size + 1
            patch_dim = 3 * ac_patch_size**2
        else:
            grid = image_size // patch_size
            patch_dim = 3 * patch_size**2
        self.patch_to_embedding = nn.Linear(patch_dim, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, grid * grid + 1, dim))
        self.blocks = nn.ModuleList(
            FaceBlock(dim, heads, dim_head, mlp_dim, dtype)
            for _ in range(depth))
        self.mlp_head = LayerNorm(dim)
        self.loss_weight = nn.Parameter(torch.zeros(num_class, dim))
        self.loss_bias = (nn.Parameter(torch.zeros(num_class))
                          if loss_type == "Softmax" else None)
        self._init_weights(generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                m.to(dtype)

    @torch.no_grad()
    def _init_weights(self, generator: Optional[torch.Generator]) -> None:
        for name, p in self.named_parameters():
            if name in ("cls_token", "pos_embedding"):
                nn.init.normal_(p, std=1.0, generator=generator)
            elif name == "loss_weight":
                nn.init.xavier_uniform_(p, generator=generator)
            elif name.endswith(".weight") and p.dim() > 1:
                # Flax lecun_normal: truncated at 2 sigma, rescaled to unit
                # variance over the truncation
                std = (1.0 / p.shape[1]) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(p, std=std, a=-2 * std, b=2 * std,
                                      generator=generator)
            elif name.endswith(".bias"):
                nn.init.zeros_(p)

    def patchify(self, img: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, patches, features): each patch flattened as
        (p, q, c), or with ``overlapping`` each window channel-major as
        (c, kh, kw), ``F.unfold``'s order."""
        B, H, W, C = img.shape
        p = self.patch_size
        if not self.overlapping:
            x = img.reshape(B, H // p, p, W // p, p, C).permute(0, 1, 3, 2, 4, 5)
            return x.reshape(B, (H // p) * (W // p), p * p * C)
        cols = F.unfold(img.permute(0, 3, 1, 2), self.ac_patch_size,
                        padding=self.pad, stride=p)
        return cols.transpose(1, 2)

    def forward(self, img: torch.Tensor,
                label: Optional[torch.Tensor] = None):
        x = self.patchify(img.float()).to(self.dtype)
        x = _dense(self.patch_to_embedding, x, self.dtype)
        B = x.shape[0]
        x = torch.cat([self.cls_token.to(x.dtype).expand(B, -1, -1), x], 1)
        x = x + self.pos_embedding.to(x.dtype)
        for blk in self.blocks:
            x = blk(x)
        x = x.mean(dim=1) if self.pool == "mean" else x[:, 0]
        emb = self.mlp_head(x)
        if label is None:
            return emb
        return margin_logits(self.loss_weight, emb, label, self.loss_type,
                             bias=self.loss_bias), emb


def build_vit_face(model_name: str = "VIT", loss_type: str = "CosFace",
                   num_class: int = 93431, dtype: torch.dtype = torch.float32,
                   **kw) -> ViTFace:
    """``VIT`` (``ViT_face``) or ``VITs`` (``ViTs_face``) at the reference's
    widths (``face_encoder.py:52-87``)."""
    if model_name not in ("VIT", "VITs"):
        raise ValueError(f"unknown face model {model_name!r}")
    return ViTFace(loss_type=loss_type, num_class=num_class,
                   overlapping=model_name == "VITs", dtype=dtype, **kw)
