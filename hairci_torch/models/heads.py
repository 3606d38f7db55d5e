"""Projection heads (port of ``hairci/models/heads.py``): ``MLPHead`` (ReLU,
or exact-erf GELU as in lightly's MSN head), the SimCLR projection head
with its widths by backbone (``_PROJ_DIMS`` of ``hairci/ssl/simclr.py``),
SupCon's ``mlp`` and ``linear`` heads (``hairci/ssl/supcon.py:SupConModule``),
the DINO head over weight-normalised prototypes (``DINOHead``), BYOL's
projection and prediction heads, DenseCL's global and local heads, the
token-axis BatchNorm of SiameseIM's decoder blocks (``PermuteBN``), and two
heads no recipe calls: MSN's learnable ``Prototypes`` and the reference's
pairwise ``RankingHeadMLP``."""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from hairci_torch.models.norm import BatchNorm
from hairci_torch.models.resnet import lecun_normal_


class Linear(nn.Linear):
    """Dense layer computing in ``dtype`` (flax ``nn.Dense(dtype=...)``)."""

    def __init__(self, cin: int, cout: int, bias: bool,
                 dtype: torch.dtype = torch.float32):
        super().__init__(cin, cout, bias=bias)
        self.dtype = dtype
        with torch.no_grad():
            lecun_normal_(self.weight, cin)
            if bias:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype),
                        None if self.bias is None else self.bias.to(self.dtype))


class MLPHead(nn.Module):
    """Stack of (Dense [BN] [act]) blocks, ``layers`` = (out_dim, use_bn,
    use_act) each, in ``self.layers`` as the lightly head orders them
    (Linear, BN, act, ...): the SimCLR head's keys are
    ``layers.{0,1,3,4}``, as in ``export_sham2``, and the MSN head's
    ``layers.{0,1,3,4,6}``. ``act`` is ``relu`` or ``gelu`` (exact erf, in
    the module dtype, as ``nn.gelu(approximate=False)``). Its BN is the
    port's ``BatchNorm`` on the (B, D) input, so the stats kernel covers it
    too, in the centred form of the ``flax.linen.BatchNorm`` the JAX head
    uses."""

    def __init__(self, in_dim: int, layers: Sequence[Tuple[int, bool, bool]],
                 dtype: torch.dtype = torch.float32, act: str = "relu"):
        super().__init__()
        if act not in ("relu", "gelu"):
            raise ValueError(f"unknown activation {act!r}")
        self.dtype = dtype
        mods = []
        for dim, use_bn, use_act in layers:
            mods.append(Linear(in_dim, dim, bias=not use_bn, dtype=dtype))
            if use_bn:
                mods.append(BatchNorm(dim, dtype=dtype, centered=True))
            if use_act:
                mods.append(nn.ReLU() if act == "relu" else nn.GELU())
            in_dim = dim
        self.layers = nn.Sequential(*mods)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers(x.to(self.dtype)).float()


# the reference SimCLR head, SimCLRProjectionHead(D, hidden, out), by
# backbone: (hidden, out)
SIMCLR_PROJ_DIMS = {
    "resnet18": (512, 128),
    "resnet34": (512, 128),
    "resnet50": (2048, 1024),
    "resnet101": (2048, 1024),
    "vit_b_16": (768, 512),
    "vit_base_patch16": (768, 512),
}


def simclr_projection_head(in_dim: int, hidden: int = 2048, out: int = 128,
                           dtype: torch.dtype = torch.float32) -> MLPHead:
    """lightly SimCLRProjectionHead: Dense+BN+ReLU, Dense+BN."""
    return MLPHead(in_dim, [(hidden, True, True), (out, True, False)],
                   dtype=dtype)


def byol_projection_head(in_dim: int, hidden: int = 4096, out: int = 256,
                         dtype: torch.dtype = torch.float32) -> MLPHead:
    """lightly BYOLProjectionHead: Dense+BN+ReLU, Dense with a bias (keys
    ``layers.{0,1,3}``)."""
    return MLPHead(in_dim, [(hidden, True, True), (out, False, False)],
                   dtype=dtype)


def byol_prediction_head(in_dim: int = 256, hidden: int = 4096,
                         out: int = 256,
                         dtype: torch.dtype = torch.float32) -> MLPHead:
    """lightly BYOLPredictionHead: the projection head's layout."""
    return byol_projection_head(in_dim, hidden, out, dtype)


def densecl_global_head(in_dim: int, hidden: int = 2048, out: int = 128,
                        dtype: torch.dtype = torch.float32) -> MLPHead:
    """lightly DenseCLProjectionHead: Dense+ReLU, Dense, both with a bias
    (keys ``layers.{0,2}``)."""
    return MLPHead(in_dim, [(hidden, False, True), (out, False, False)],
                   dtype=dtype)


class DenseCLLocalHead(MLPHead):
    """The DenseCL head over every position of a (B, H, W, C) map: two
    Dense layers with a bias and a ReLU between them, on the (B, H*W, C)
    view in ``dtype``; returns (B, H*W, out) f32 (``hairci/models/heads.py:
    DenseCLLocalHead``, its ``fc1`` / ``fc2`` as ``layers.{0,2}``)."""

    def __init__(self, in_dim: int, hidden: int = 2048, out: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_dim, [(hidden, False, True), (out, False, False)],
                         dtype=dtype)

    def forward(self, spatial: torch.Tensor) -> torch.Tensor:
        B, H, W, C = spatial.shape
        return super().forward(spatial.reshape(B, H * W, C))


def supcon_head(in_dim: int, head: str = "mlp", feat_dim: int = 128,
                dtype: torch.dtype = torch.float32) -> nn.Module:
    """SupConResNet's head in the reference's key layout: ``mlp`` is
    Linear(D, D), ReLU, Linear(D, feat_dim) (keys ``0`` and ``2``),
    ``linear`` one Linear(D, feat_dim); every layer has a bias and computes
    in ``dtype``."""
    if head == "linear":
        return Linear(in_dim, feat_dim, bias=True, dtype=dtype)
    if head == "mlp":
        return nn.Sequential(Linear(in_dim, in_dim, bias=True, dtype=dtype),
                             nn.ReLU(),
                             Linear(in_dim, feat_dim, bias=True, dtype=dtype))
    raise ValueError(f"unknown SupCon head {head!r}")


class DINOHead(nn.Module):
    """MLP -> L2-normalised bottleneck -> weight-normalised prototypes
    (``hairci/models/heads.py:DINOHead``): fc1, fc2 (2048 wide, exact GELU
    after each) and fc3 (256) in ``dtype``, then in f32 the bottleneck over
    its norm + 1e-12 against the rows of ``prototypes`` (out_dim, 256) over
    theirs. Takes (B, D) cls tokens or (B, N, D) patch tokens; returns f32
    logits over ``out_dim`` prototypes."""

    hidden, bottleneck = 2048, 256

    def __init__(self, in_dim: int, out_dim: int = 65536,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = Linear(in_dim, self.hidden, bias=True, dtype=dtype)
        self.fc2 = Linear(self.hidden, self.hidden, bias=True, dtype=dtype)
        self.fc3 = Linear(self.hidden, self.bottleneck, bias=True, dtype=dtype)
        self.prototypes = nn.Parameter(
            torch.randn(out_dim, self.bottleneck) * 0.02)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.gelu(self.fc1(x.to(self.dtype)))
        x = self.fc3(F.gelu(self.fc2(x))).float()
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-12)
        w = self.prototypes.float()
        w = w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-12)
        return torch.matmul(x, w.T)


class PermuteBN(nn.Module):
    """BatchNorm over the (batch, token) axes of a (B, L, C) input
    (``hairci/models/heads.py:PermuteBN``, the reference's PermuteBN with
    its ``bn`` child): the port's ``BatchNorm`` in the centred flax form
    (momentum 0.9, eps 1e-5, biased variance clamped at 0) on the f32
    (B*L, C) view, so a train-mode call takes its statistics from the
    bn_stats kernel on a card; the output is cast back to the input's
    dtype."""

    def __init__(self, dim: int):
        super().__init__()
        self.bn = BatchNorm(dim, momentum=0.9, eps=1e-5, centered=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn(x.reshape(-1, x.shape[-1]).float())
        return y.reshape(x.shape).to(x.dtype)


class Prototypes(nn.Module):
    """A learnable prototype bank (``protos``, N(0, 0.02)) returning the f32
    cosine logits of ``z`` (B, dim) against it, each side over its norm +
    1e-12 (``hairci/models/heads.py:Prototypes``, MSN's ``backbone.py:
    99-104``)."""

    def __init__(self, num_prototypes: int = 1024, dim: int = 256):
        super().__init__()
        self.protos = nn.Parameter(torch.randn(num_prototypes, dim) * 0.02)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        w = self.protos.float()
        w = w / (torch.linalg.vector_norm(w, dim=-1, keepdim=True) + 1e-12)
        z = z.float()
        z = z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-12)
        return z @ w.T


class RankingHeadMLP(nn.Module):
    """Scores an (anchor, candidate) pair of (B, dim) embeddings: fc1 over
    ``[a, b, |a - b|, a * b]`` to ``hidden``, ReLU, fc2 to one f32 score a
    row (the reference's ``main_backbone.py:166-196``)."""

    def __init__(self, dim: int, hidden: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(4 * dim, hidden, bias=True, dtype=dtype)
        self.fc2 = Linear(hidden, 1, bias=True, dtype=dtype)

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        x = torch.cat([a, b, torch.abs(a - b), a * b], dim=-1)
        return self.fc2(F.relu(self.fc1(x)))[..., 0].float()
