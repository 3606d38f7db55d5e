"""Plain ViT (Dosovitskiy et al. 2020, arXiv:2010.11929) in float32, on a
dict of tensors named as timm names them (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.{i}.{norm1,attn.qkv,attn.proj,
norm2,mlp.fc1,mlp.fc2}``, ``norm``).

As the configuration states it: a fixed 2-D sin-cos position table (MAE's),
LayerNorm eps 1e-6, exact-erf GELU, the feature the final-normed class
token. The port also holds an unused ``mask_token`` and, for serving, an
``fc_norm``: their leaves are made too, so that both sides load the same
state, and the forward does not read them.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from harness.data import Leaf, fan_in_leaf
from reference.nn import Params, Precision, layer_norm, maybe_checkpoint


def sincos_pos_embed(dim: int, grid: int) -> np.ndarray:
    """(grid * grid + 1, dim) f32, a zero row for the class token first."""
    gh = np.arange(grid, dtype=np.float32)
    gw = np.arange(grid, dtype=np.float32)
    g = np.stack(np.meshgrid(gw, gh), axis=0).reshape(2, 1, grid, grid)

    def one_d(d, pos):
        omega = 1.0 / 10000 ** (np.arange(d // 2, dtype=np.float32)
                                / (d / 2.0))
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    emb = np.concatenate([one_d(dim // 2, g[0]), one_d(dim // 2, g[1])], 1)
    return np.concatenate([np.zeros((1, dim), np.float32), emb], 0)


def _ln(name: str, d: int) -> List[Leaf]:
    return [Leaf(name + ".weight", (d,), "ones"),
            Leaf(name + ".bias", (d,), "zeros")]


def _dense(name: str, cout: int, cin: int) -> List[Leaf]:
    return [fan_in_leaf(name + ".weight", (cout, cin)),
            Leaf(name + ".bias", (cout,), "zeros")]


def spec(arch, img: int, prefix: str = "backbone.",
         fc_norm: bool = False) -> List[Leaf]:
    d, p = arch["width"], arch["patch"]
    grid = img // p
    leaves = [fan_in_leaf(prefix + "patch_embed.proj.weight", (d, 3, p, p)),
              Leaf(prefix + "patch_embed.proj.bias", (d,), "zeros"),
              Leaf(prefix + "mask_token", (1, 1, d), "normal", 0.02),
              Leaf(prefix + "pos_embed", (1, grid * grid + 1, d), "fixed",
                   value=sincos_pos_embed(d, grid)),
              Leaf(prefix + "cls_token", (1, 1, d), "normal", 0.02)]
    for i in range(arch["depth"]):
        b = f"{prefix}blocks.{i}."
        leaves += (_ln(b + "norm1", d) + _dense(b + "attn.qkv", 3 * d, d)
                   + _dense(b + "attn.proj", d, d) + _ln(b + "norm2", d)
                   + _dense(b + "mlp.fc1", arch["mlp"], d)
                   + _dense(b + "mlp.fc2", d, arch["mlp"]))
    leaves += _ln(prefix + "norm", d)
    if fc_norm:
        leaves += _ln(prefix + "fc_norm", d)
    return leaves


def _block(P: Precision, p: Params, b: str, heads: int,
           x: torch.Tensor) -> torch.Tensor:
    B, N, D = x.shape
    hd = D // heads
    qkv = P.linear(layer_norm(x, p, b + "norm1"), p[b + "attn.qkv.weight"],
                   p[b + "attn.qkv.bias"]).reshape(B, N, 3, heads, hd)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    attn = torch.softmax(P.matmul(q, k.transpose(-2, -1)) * hd ** -0.5, -1)
    o = P.matmul(attn, v).transpose(1, 2).reshape(B, N, D)
    x = P.act(x + P.linear(o, p[b + "attn.proj.weight"],
                           p[b + "attn.proj.bias"]))
    h = F.gelu(P.linear(layer_norm(x, p, b + "norm2"),
                        p[b + "mlp.fc1.weight"], p[b + "mlp.fc1.bias"]))
    return P.act(x + P.linear(h, p[b + "mlp.fc2.weight"],
                              p[b + "mlp.fc2.bias"]))


def features(arch, P: Precision, p: Params, x: torch.Tensor,
             prefix: str = "backbone.") -> torch.Tensor:
    """(B, H, W, 3) f32 -> the final-normed class token (B, D) f32."""
    B = x.shape[0]
    t = P.conv(x.permute(0, 3, 1, 2), p[prefix + "patch_embed.proj.weight"],
               p[prefix + "patch_embed.proj.bias"], stride=arch["patch"])
    t = t.flatten(2).transpose(1, 2)
    pos = p[prefix + "pos_embed"]
    t = t + pos[:, 1:]
    cls = (p[prefix + "cls_token"] + pos[:, :1]).expand(B, -1, -1)
    t = torch.cat([cls, t], 1)
    for i in range(arch["depth"]):
        t = maybe_checkpoint(
            lambda y, i=i: _block(P, p, f"{prefix}blocks.{i}.",
                                  arch["heads"], y), t)
    return layer_norm(t[:, 0], p, prefix + "norm")


def forward_flops(arch, img: int) -> Dict[str, float]:
    """Multiply-add FLOPs of one image's forward: the patch embedding
    (``first``, whose input takes no gradient), and in every block the
    four dense layers and the two attention products."""
    d, n_p = arch["width"], (img // arch["patch"]) ** 2
    first = 2.0 * 3 * arch["patch"] ** 2 * d * n_p
    n = n_p + 1
    block = (2.0 * n * d * 3 * d + 2.0 * n * n * d * 2 + 2.0 * n * d * d
             + 2.0 * n * d * arch["mlp"] * 2)
    return {"total": first + arch["depth"] * block, "first": first}
