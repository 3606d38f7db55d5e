"""Enhanced dual-view encoders (port of
``hairci/experiments/dualview/enhanced.py``):

  - ``SpatialAttention``: a 7x7 SAME conv with a bias, 2 -> 1 channel, on
    the channel-last ``concat([mean, max])`` over the channels (the mean
    first); the map is scaled by its sigmoid;
  - ``MultiScaleHairEncoder``: the ResNet's last map (``ResNetFeatures``)
    through the attention, its global mean and max pooled and fused by a
    Dense + ReLU (the embedding), then Dense + ReLU + Dense (the
    projection);
  - ``PartBasedHairEncoder``: four horizontal strips of the last map, each
    mean-pooled through its own Dense + ReLU (the embedding is their
    concatenation), then a Dense projection. A strip is ``max(H // 4, 1)``
    rows and the last takes the rest: for H < 4 (under 128 px on a stride-32
    trunk) some strips are empty and their mean NaN, as in JAX;
  - ``CrossViewAlignment``: the student embedding attending to the
    teacher's through the port's ``CrossAttention``, added back;
  - ``ENCODERS`` (by the CLI's ``--encoder`` name) and ``hybrid_loss``
    (InfoNCE + cosine alignment + uniformity).

The enhanced heads have no BatchNorm: a train-mode forward launches the
bn_stats kernel 53 times on a card, the ResNet-50 trunk's. Dense layers and
the attention conv compute in ``dtype`` with f32 weights; the outputs are
f32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hairci_torch.eval.features import l2_normalize
from hairci_torch.models.heads import Linear
from hairci_torch.models.resnet import MODEL_DICT, build_resnet, lecun_normal_
from hairci_torch.models.vit import CrossAttention


class SpatialAttention(nn.Module):
    """``feat * sigmoid(conv7x7(concat([mean_c(feat), max_c(feat)])))`` on a
    (B, H, W, C) map; the conv (flax ``nn.Conv(1, (7, 7), padding="SAME")``)
    is an ordinary ``F.conv2d``."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = nn.Conv2d(2, 1, 7, padding=3, bias=True)
        with torch.no_grad():
            lecun_normal_(self.conv.weight, 2 * 7 * 7)
            self.conv.bias.zero_()

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        pooled = torch.cat([feat.mean(-1, keepdim=True),
                            feat.amax(-1, keepdim=True)], -1)
        attn = F.conv2d(pooled.to(self.dtype).permute(0, 3, 1, 2),
                        self.conv.weight.to(self.dtype),
                        self.conv.bias.to(self.dtype), padding=3)
        return feat * torch.sigmoid(attn.permute(0, 2, 3, 1))


class MultiScaleHairEncoder(nn.Module):
    """ResNet trunk with spatial attention + mean- and max-pooled fusion."""

    def __init__(self, backbone_name: str = "resnet50",
                 embedding_dim: int = 256, projection_dim: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.projection_dim = projection_dim
        self.backbone = build_resnet(backbone_name, dtype=dtype,
                                     with_spatial=True)
        self.attn = SpatialAttention(dtype)
        feat = MODEL_DICT[backbone_name]
        self.emb = Linear(2 * feat, embedding_dim, bias=True, dtype=dtype)
        self.proj1 = Linear(embedding_dim, embedding_dim, bias=True,
                            dtype=dtype)
        self.proj2 = Linear(embedding_dim, projection_dim, bias=True,
                            dtype=dtype)

    def forward(self, x: torch.Tensor,
                return_embedding: bool = False) -> torch.Tensor:
        spatial = self.attn(self.backbone(x)[1])
        gap = spatial.mean(dim=(1, 2))
        gmp = spatial.amax(dim=(1, 2))
        e = F.relu(self.emb(torch.cat([gap, gmp], -1)))
        if return_embedding:
            return e.float()
        return self.proj2(F.relu(self.proj1(e))).float()


class PartBasedHairEncoder(nn.Module):
    """Horizontal-strip part pooling, a Dense + ReLU per part."""

    def __init__(self, backbone_name: str = "resnet50", num_parts: int = 4,
                 embedding_dim: int = 256, projection_dim: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.projection_dim = projection_dim
        self.num_parts = num_parts
        self.backbone = build_resnet(backbone_name, dtype=dtype,
                                     with_spatial=True)
        feat = MODEL_DICT[backbone_name]
        self.part_heads = nn.ModuleList(
            Linear(feat, embedding_dim // num_parts, bias=True, dtype=dtype)
            for _ in range(num_parts))
        self.proj = Linear(embedding_dim, projection_dim, bias=True,
                           dtype=dtype)

    def forward(self, x: torch.Tensor,
                return_embedding: bool = False) -> torch.Tensor:
        spatial = self.backbone(x)[1]                      # (B, H, W, C)
        H = spatial.shape[1]
        strip = max(H // self.num_parts, 1)
        parts = []
        for i, head in enumerate(self.part_heads):
            end = (i + 1) * strip if i < self.num_parts - 1 else H
            band = spatial[:, i * strip:end]
            parts.append(F.relu(head(band.mean(dim=(1, 2)))))
        e = torch.cat(parts, -1)
        if return_embedding:
            return e.float()
        return self.proj(e).float()


class CrossViewAlignment(nn.Module):
    """Cross-attention aligning student embeddings (B, D) to the teacher's:
    ``student + CrossAttention(student, teacher)``, each a one-token
    sequence."""

    def __init__(self, dim: int = 256, heads: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.attn = CrossAttention(dim, heads, dtype)

    def forward(self, student_e: torch.Tensor,
                teacher_e: torch.Tensor) -> torch.Tensor:
        aligned = self.attn(student_e[:, None, :], teacher_e[:, None, :])
        return (student_e + aligned[:, 0]).float()


ENCODERS = {
    "multiscale": MultiScaleHairEncoder,
    "partbased": PartBasedHairEncoder,
}


def hybrid_loss(student_proj: torch.Tensor, teacher_proj: torch.Tensor,
                temperature: float = 0.07, w_contrastive: float = 1.0,
                w_align: float = 0.5, w_uniform: float = 0.1
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The reference's ``HybridLoss``: InfoNCE + the mean cosine distance of
    the pairs + uniformity, the log of the mean of exp(-2 |s_i - s_j|^2)
    over the off-diagonal pairs (a mask, as in JAX)."""
    from hairci_torch.experiments.dualview.models import contrastive_loss

    c = contrastive_loss(student_proj, teacher_proj, temperature)
    s = l2_normalize(student_proj.float())
    t = l2_normalize(teacher_proj.float())
    align = torch.mean(1.0 - torch.sum(s * t, dim=-1))
    d2 = torch.sum((s[:, None] - s[None]) ** 2, dim=-1)
    off = 1.0 - torch.eye(s.shape[0], dtype=d2.dtype, device=d2.device)
    uniform = torch.log(torch.sum(torch.exp(-2.0 * d2) * off)
                        / torch.clamp(off.sum(), min=1.0) + 1e-12)
    total = w_contrastive * c + w_align * align + w_uniform * uniform
    return total, {"contrastive": c, "align": align, "uniform": uniform}
