"""Checkpoint conversion into the port's timm-layout ViT.

``vit_state_dict_from_jax`` maps a JAX ``VisionTransformer`` param tree
(nested dicts of numpy arrays) with the key mapping of
``hairci/retrieval/torch_import.py:export_vit``: dense kernels are
transposed, the patch conv goes HWIO -> OIHW. ``timm_vit_state_dict`` fills a
timm/reference ViT state dict up to the port's key set the way
``convert_vit`` + ``merge_params`` do, so a ``.pth`` written by
``save_torch_state_dict(export_vit(...))`` and a timm ViT ``.pth`` load alike.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from hairci_torch.models.vit import VisionTransformer


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def vit_state_dict_from_jax(params: Mapping, depth: int
                            ) -> Dict[str, torch.Tensor]:
    """JAX ViT params -> the port's state dict (load with ``strict=True``)."""
    sd = {
        "cls_token": _t(params["cls_token"]),
        "pos_embed": _t(params["pos_embed"]),
        "mask_token": _t(params["mask_token"]),
        "patch_embed.proj.weight": _t(np.transpose(
            np.asarray(params["patch_embed"]["proj"]["kernel"]), (3, 2, 0, 1))),
        "patch_embed.proj.bias": _t(params["patch_embed"]["proj"]["bias"]),
    }
    for i in range(depth):
        bp = params[f"block{i}"]
        t = f"blocks.{i}"
        for norm in ("norm1", "norm2"):
            sd[f"{t}.{norm}.weight"] = _t(bp[norm]["scale"])
            sd[f"{t}.{norm}.bias"] = _t(bp[norm]["bias"])
        for mod, dense in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"),
                           ("mlp", "fc2")):
            sd[f"{t}.{mod}.{dense}.weight"] = _t(
                np.asarray(bp[mod][dense]["kernel"]).T)
            sd[f"{t}.{mod}.{dense}.bias"] = _t(bp[mod][dense]["bias"])
    for n in ("norm", "fc_norm"):
        if n in params:
            sd[f"{n}.weight"] = _t(params[n]["scale"])
            sd[f"{n}.bias"] = _t(params[n]["bias"])
    return sd


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Tensors of a .pth, unwrapping the reference's nested checkpoints
    ({'model_state_dict': ...}, {'model': ...}, {'state_dict': ...}).
    Reference checkpoints pickle non-tensor objects (args, optimizer), so
    this unpickles in full: load only files you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("model_state_dict", "model", "state_dict"):
        if isinstance(obj, dict) and key in obj:
            obj = obj[key]
            break
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def timm_vit_state_dict(sd: Mapping[str, torch.Tensor],
                        model: VisionTransformer) -> Dict[str, torch.Tensor]:
    """A timm-layout ViT state dict completed to ``model``'s key set: every
    block must be present; a missing mask token becomes zeros and a missing
    ``norm``/``fc_norm`` the identity, as ``convert_vit`` fills them; keys the
    model lacks (heads, LayerScale) are dropped."""
    d = model.embed_dim
    out = {
        "cls_token": sd["cls_token"].reshape(1, 1, d),
        "pos_embed": sd["pos_embed"],
        "mask_token": sd.get("mask_token", torch.zeros(1, 1, d)
                             ).reshape(1, 1, d),
        "patch_embed.proj.weight": sd["patch_embed.proj.weight"],
        "patch_embed.proj.bias": sd["patch_embed.proj.bias"],
    }
    for i in range(model.depth):
        t = f"blocks.{i}"
        for name in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1",
                     "mlp.fc2"):
            for p in ("weight", "bias"):
                out[f"{t}.{name}.{p}"] = sd[f"{t}.{name}.{p}"]
    for n in ("norm", "fc_norm") if model.global_pool else ("norm",):
        out[f"{n}.weight"] = sd.get(f"{n}.weight", torch.ones(d))
        out[f"{n}.bias"] = sd.get(f"{n}.bias", torch.zeros(d))
    return out
