"""Checkpoint conversion into the port's modules.

``vit_state_dict_from_jax`` maps a JAX ``VisionTransformer`` param tree
(nested dicts of numpy arrays) with the key mapping of
``hairci/retrieval/torch_import.py:export_vit``: dense kernels are
transposed, the patch conv goes HWIO -> OIHW. ``timm_vit_state_dict`` fills a
timm/reference ViT state dict up to the port's key set the way
``convert_vit`` + ``merge_params`` do, so a ``.pth`` written by
``save_torch_state_dict(export_vit(...))`` and a timm ViT ``.pth`` load alike.

``resnet_state_dict_from_jax``, ``sham_state_dict_from_jax`` and
``simclr_state_dict_from_jax`` map a JAX ``ResNet`` / ``SHAMModule`` /
``SimCLRModule`` (params and batch stats) with the key mapping of
``export_resnet`` and ``export_sham2`` (torchvision layout; the projection
head as ``projection_head.layers.{0,1,3,4}``), with the backbone under
``backbone.`` rather than the reference's ``nn.Sequential`` indices; a ViT
backbone maps as ``vit_state_dict_from_jax`` does. ``sham2_state_dict``
renames a reference-trained ResNet SHAM or SimCLR ``.pth`` in that
``nn.Sequential`` layout. ``supcon_state_dict_from_jax`` maps a JAX
``SupConModule`` and ``supcon_state_dict`` a reference ``SupConResNet``
``.pth`` (``convert_supcon``) onto the port's ``SupConModule``.

``torchvision_vit_state_dict`` reads a torchvision-layout ViT (the backbone
of the reference's SimCLR on ``vit_b_16``) as ``convert_torchvision_vit``
does. ``face_vit_state_dict_from_jax`` maps a JAX ``ViTFace`` and
``face_vit_state_dict`` a reference ``ViT_face`` / ``ViTs_face`` ``.pth``
(``convert_vit_face``) onto the port's ``ViTFace``.

``mae_state_dict_from_jax`` / ``simmim_state_dict_from_jax`` map a JAX
``MAEModule`` / ``SimMIMModule``; ``mae_state_dict`` reads a reference MAE
``.pth`` (the timm encoder under ``backbone.vit.``, lightly's decoder under
``decoder.``) as ``convert_mae`` does, and ``simmim_state_dict`` a reference
SimMIM ``.pth`` (a torchvision ViT under ``backbone.vit.``, a linear
``decoder``) as ``convert_simmim`` does.

``dinov2_state_dict_from_jax`` / ``msn_state_dict_from_jax`` map one branch
of a JAX ``DINOv2Module`` / ``MSNModule`` (params, and MSN's batch stats):
the online branch from ``params``, the EMA (teacher, target) from
``ema_params`` the same way. ``dinov2_state_dict`` reads a reference DINOv2
``.pth`` (timm ViTs with LayerScale under ``student_backbone.vit.`` /
``teacher_backbone.vit.``, lightly's DINO heads with a weight-normalised
``last_layer``) as ``convert_dinov2`` does, and ``msn_state_dict`` a
reference MSN ``.pth`` (torchvision ViTs under ``anchor_backbone.vit.`` /
``backbone.vit.``, lightly's MSN heads) as ``convert_msn`` does; each
returns the online and the EMA branch.

``byol_state_dict_from_jax`` / ``densecl_state_dict_from_jax`` map one
branch of a JAX ``BYOLModule`` / ``DenseCLModule`` (params, batch stats).
``densecl_state_dict`` reads a reference DenseCL ``.pth`` (ResNet-50
``nn.Sequential`` trunks under ``backbone.`` / ``backbone_momentum.``,
lightly's heads under ``projection_head_{global,local}{,_momentum}.``) as
``convert_densecl`` does, into the online and the EMA branch. The JAX
package has no BYOL reader, and neither has the port.

``siameseim_state_dict_from_jax`` / ``sham_v1_state_dict_from_jax`` map
one branch of a JAX ``SiameseIMModule`` (params and the PermuteBN blocks'
batch stats) / ``SHAMv1Module``. ``siameseim_state_dict`` reads a
reference ``SiameseIMViT`` ``.pth`` (the online encoder at the top level,
its momentum copy under ``mm_``, the decoder stack where present) as
``convert_siameseim`` + ``merge_params`` do, and ``siameseim_block_norm``
tells its decoder blocks' norm layout.

``dualview_state_dict_from_jax`` maps one tower of a JAX DualViewHair
encoder (the ``HairstyleEncoder`` or an enhanced one) and
``cross_view_alignment_state_dict_from_jax`` a ``CrossViewAlignment``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from hairci_torch.models import resnet
from hairci_torch.models.face_vit import ViTFace
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
        _block_from_jax(sd, f"blocks.{i}", params[f"block{i}"])
    for n in ("norm", "fc_norm"):
        if n in params:
            _put_norm(sd, n, params[n])
    return sd


def _block_from_jax(sd: Dict[str, torch.Tensor], t: str,
                    bp: Mapping) -> None:
    """A JAX ViT ``Block``'s params as the port's ``Block`` under ``t``."""
    for norm in ("norm1", "norm2"):
        _put_norm(sd, f"{t}.{norm}", bp[norm])
    for mod, dense in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"),
                       ("mlp", "fc2")):
        _put_dense(sd, f"{t}.{mod}.{dense}", bp[mod][dense])
    for ls in ("ls1", "ls2"):
        if ls in bp:
            sd[f"{t}.{ls}.gamma"] = _t(bp[ls]["gamma"])


def _put_norm(sd: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])


def _put_dense(sd: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{name}.bias"] = _t(p["bias"])


def _put_bn(sd: Dict[str, torch.Tensor], name: str, p: Mapping,
            s: Mapping) -> None:
    sd[f"{name}.weight"] = _t(p["scale"])
    sd[f"{name}.bias"] = _t(p["bias"])
    sd[f"{name}.running_mean"] = _t(s["mean"])
    sd[f"{name}.running_var"] = _t(s["var"])


def _put_conv(sd: Dict[str, torch.Tensor], name: str, p: Mapping) -> None:
    sd[f"{name}.weight"] = _t(np.transpose(np.asarray(p["kernel"]),
                                           (3, 2, 0, 1)))  # HWIO -> OIHW


def resnet_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                               stage_sizes: Sequence[int] = (2, 2, 2, 2),
                               bottleneck: bool = False
                               ) -> Dict[str, torch.Tensor]:
    """JAX ResNet (params, batch_stats) -> the port's ``ResNet`` state dict
    (load with ``strict=True``)."""
    sd: Dict[str, torch.Tensor] = {}
    _put_conv(sd, "conv1", params["conv_init"])
    _put_bn(sd, "bn1", params["bn_init"], batch_stats["bn_init"])
    block = "BottleneckBlock" if bottleneck else "BasicBlock"
    gi = 0
    for stage, n_blocks in enumerate(stage_sizes, start=1):
        for b in range(n_blocks):
            t = f"layer{stage}.{b}"
            bp, bs = params[f"{block}_{gi}"], batch_stats[f"{block}_{gi}"]
            for c in range(3 if bottleneck else 2):
                _put_conv(sd, f"{t}.conv{c + 1}", bp[f"Conv_{c}"])
                _put_bn(sd, f"{t}.bn{c + 1}", bp[f"BatchNorm_{c}"],
                        bs[f"BatchNorm_{c}"])
            if "conv_proj" in bp:
                _put_conv(sd, f"{t}.downsample.0", bp["conv_proj"])
                _put_bn(sd, f"{t}.downsample.1", bp["norm_proj"],
                        bs["norm_proj"])
            gi += 1
    return sd


def _backbone_from_jax(params: Mapping, batch_stats: Mapping, model: str,
                       prefix: str) -> Dict[str, torch.Tensor]:
    """A JAX ResNet or ViT backbone's trees under ``prefix``."""
    if model.startswith("vit"):
        depth = sum(1 for k in params if k.startswith("block"))
        backbone = vit_state_dict_from_jax(params, depth)
    else:
        stages, block = resnet._STAGES[model]
        backbone = resnet_state_dict_from_jax(
            params, batch_stats, stages, block is resnet.BottleneckBlock)
    return {f"{prefix}{k}": v for k, v in backbone.items()}


def _projection_head_from_jax(sd: Dict[str, torch.Tensor], hp: Mapping,
                              hs: Mapping) -> None:
    """A JAX ``simclr_projection_head`` (dense0, bn0, dense1, bn1) as
    ``projection_head.layers.{0,1,3,4}``."""
    for i, (lin, bn) in enumerate((("0", "1"), ("3", "4"))):
        sd[f"projection_head.layers.{lin}.weight"] = _t(
            np.asarray(hp[f"dense{i}"]["kernel"]).T)
        _put_bn(sd, f"projection_head.layers.{bn}", hp[f"bn{i}"], hs[f"bn{i}"])


def sham_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                             model: str = "resnet18"
                             ) -> Dict[str, torch.Tensor]:
    """JAX ``SHAMModule`` (params, batch_stats) -> the port's ``SHAMModule``
    state dict (load with ``strict=True``). ``model`` is the backbone's name:
    a ResNet, or ``vit_b_16`` / ``vit_base_patch16``."""
    sd = _backbone_from_jax(params["backbone"],
                            batch_stats.get("backbone", {}), model,
                            "backbone.")
    _projection_head_from_jax(sd, params["projection_head"],
                              batch_stats["projection_head"])
    return sd


def simclr_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                               model: str = "resnet50"
                               ) -> Dict[str, torch.Tensor]:
    """JAX ``SimCLRModule`` (params, batch_stats; its head is ``head``) ->
    the port's ``SimCLRModule`` state dict (load with ``strict=True``)."""
    sd = _backbone_from_jax(params["backbone"],
                            batch_stats.get("backbone", {}), model,
                            "backbone.")
    _projection_head_from_jax(sd, params["head"], batch_stats["head"])
    return sd


def supcon_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                               model: str = "resnet18"
                               ) -> Dict[str, torch.Tensor]:
    """JAX ``SupConModule`` (params, batch_stats) -> the port's
    ``SupConModule`` state dict (load with ``strict=True``): the encoder,
    and ``head_fc1``/``head_fc2`` as ``head.0``/``head.2`` (``mlp``) or
    ``head_fc`` as ``head`` (``linear``)."""
    sd = _backbone_from_jax(params["encoder"], batch_stats["encoder"], model,
                            "encoder.")
    names = ({"head_fc": "head"} if "head_fc" in params
             else {"head_fc1": "head.0", "head_fc2": "head.2"})
    for jax_name, name in names.items():
        sd[f"{name}.weight"] = _t(np.asarray(params[jax_name]["kernel"]).T)
        sd[f"{name}.bias"] = _t(params[jax_name]["bias"])
    return sd


_SEQUENTIAL_RESNET = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
                      "6": "layer3", "7": "layer4"}


def sham2_state_dict(sd: Mapping[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """A reference-trained SHAM checkpoint (the layout that
    ``hairci/retrieval/torch_import.py:convert_sham2`` reads: the backbone
    as ``nn.Sequential(*resnet.children())`` under ``backbone.<int>.``, the
    lightly head under ``projection_head.layers.``) -> the port's
    ``SHAMModule`` state dict. ``num_batches_tracked`` counters and keys of
    other modules are dropped; load with ``strict=True``."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.startswith("projection_head."):
            out[key] = value
        elif key.startswith("backbone."):
            head, _, tail = key[len("backbone."):].partition(".")
            if head in _SEQUENTIAL_RESNET and tail:
                out[f"backbone.{_SEQUENTIAL_RESNET[head]}.{tail}"] = value
    return out


def supcon_state_dict(sd: Mapping[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """A reference ``SupConResNet`` checkpoint (``encoder.`` with
    ``shortcut.{0,1}`` for torchvision's ``downsample.{0,1}``, the head as
    ``head.0``/``head.2`` or ``head``) -> the port's ``SupConModule`` state
    dict, as ``hairci/retrieval/torch_import.py:convert_supcon`` reads it.
    ``num_batches_tracked`` counters and keys of other modules are dropped;
    load with ``strict=True``."""
    out: Dict[str, torch.Tensor] = {}
    for key, value in sd.items():
        if key.endswith("num_batches_tracked"):
            continue
        if key.startswith("encoder."):
            out[key.replace(".shortcut.", ".downsample.")] = value
        elif key.startswith("head."):
            out[key] = value
    return out


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
    block must be present, with its LayerScale ``ls1``/``ls2.gamma`` where
    ``model`` has LayerScale; a missing mask token becomes zeros and a
    missing ``norm``/``fc_norm`` the identity, as ``convert_vit`` fills them;
    keys the model lacks (heads, LayerScale) are dropped."""
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
        if model.blocks[i].layer_scale:
            for ls in ("ls1", "ls2"):
                out[f"{t}.{ls}.gamma"] = sd[f"{t}.{ls}.gamma"]
    for n in ("norm", "fc_norm") if model.global_pool else ("norm",):
        out[f"{n}.weight"] = sd.get(f"{n}.weight", torch.ones(d))
        out[f"{n}.bias"] = sd.get(f"{n}.bias", torch.zeros(d))
    return out


def torchvision_vit_state_dict(sd: Mapping[str, torch.Tensor],
                               model: VisionTransformer
                               ) -> Dict[str, torch.Tensor]:
    """A torchvision-layout ViT state dict (``class_token`` or
    ``cls_token``, ``encoder.pos_embedding``, ``conv_proj``,
    ``encoder.layers.encoder_layer_{i}.{ln_1, ln_2,
    self_attention.in_proj_*, self_attention.out_proj, mlp.{0,3} or
    mlp.linear_{1,2}}``, ``encoder.ln``) -> ``model``'s key set, as
    ``hairci/retrieval/torch_import.py:convert_torchvision_vit`` reads it:
    ``nn.MultiheadAttention`` packs its [q|k|v] rows as timm's qkv does; a
    missing mask token becomes zeros and ``fc_norm`` the identity, as the
    JAX package's merge over its init leaves them. Raises ``KeyError`` where
    a tensor of the layout is missing."""
    if "conv_proj.weight" not in sd:
        raise KeyError("conv_proj.weight: not a torchvision ViT state dict")
    d = model.embed_dim
    out = {
        "cls_token": sd.get("class_token", sd.get("cls_token")
                            ).reshape(1, 1, d),
        "pos_embed": sd.get("encoder.pos_embedding", sd.get("pos_embedding")),
        "mask_token": sd.get("mask_token", torch.zeros(1, 1, d)
                             ).reshape(1, 1, d),
        "patch_embed.proj.weight": sd["conv_proj.weight"],
        "patch_embed.proj.bias": sd["conv_proj.bias"],
    }
    for i in range(model.depth):
        t = f"encoder.layers.encoder_layer_{i}"
        fc1 = f"{t}.mlp.0" if f"{t}.mlp.0.weight" in sd else f"{t}.mlp.linear_1"
        fc2 = f"{t}.mlp.3" if f"{t}.mlp.3.weight" in sd else f"{t}.mlp.linear_2"
        for ours, theirs in (
                ("norm1", f"{t}.ln_1"), ("norm2", f"{t}.ln_2"),
                ("attn.proj", f"{t}.self_attention.out_proj"),
                ("mlp.fc1", fc1), ("mlp.fc2", fc2)):
            for p in ("weight", "bias"):
                out[f"blocks.{i}.{ours}.{p}"] = sd[f"{theirs}.{p}"]
        for p in ("weight", "bias"):
            out[f"blocks.{i}.attn.qkv.{p}"] = sd[
                f"{t}.self_attention.in_proj_{p}"]
    out["norm.weight"] = sd["encoder.ln.weight"]
    out["norm.bias"] = sd["encoder.ln.bias"]
    if model.global_pool:
        out["fc_norm.weight"] = torch.ones(d)
        out["fc_norm.bias"] = torch.zeros(d)
    return out


def face_vit_state_dict_from_jax(params: Mapping, depth: int
                                 ) -> Dict[str, torch.Tensor]:
    """JAX ``ViTFace`` params -> the port's ``ViTFace`` state dict (load
    with ``strict=True``): Dense kernels transposed, the classifier weight
    (and the Softmax head's bias) as they are."""
    def dense(name: str, p: Mapping, bias: bool = True) -> None:
        sd[f"{name}.weight"] = _t(np.asarray(p["kernel"]).T)
        if bias:
            sd[f"{name}.bias"] = _t(p["bias"])

    def norm(name: str, p: Mapping) -> None:
        sd[f"{name}.weight"] = _t(p["scale"])
        sd[f"{name}.bias"] = _t(p["bias"])

    sd: Dict[str, torch.Tensor] = {"cls_token": _t(params["cls_token"]),
                                   "pos_embedding": _t(params["pos_embedding"]),
                                   "loss_weight": _t(params["loss_weight"])}
    if "loss_bias" in params:
        sd["loss_bias"] = _t(params["loss_bias"])
    dense("patch_to_embedding", params["patch_to_embedding"])
    norm("mlp_head", params["mlp_head"])
    for i in range(depth):
        attn, ff = params[f"_PreNormAttention_{i}"], params[f"_PreNormFF_{i}"]
        t = f"blocks.{i}"
        norm(f"{t}.attn.norm", attn["LayerNorm_0"])
        dense(f"{t}.attn.to_qkv", attn["Dense_0"], bias=False)
        dense(f"{t}.attn.to_out", attn["Dense_1"])
        norm(f"{t}.ff.norm", ff["LayerNorm_0"])
        dense(f"{t}.ff.fc1", ff["Dense_0"])
        dense(f"{t}.ff.fc2", ff["Dense_1"])
    return sd


def face_vit_state_dict(sd: Mapping[str, torch.Tensor], model: ViTFace
                        ) -> Dict[str, torch.Tensor]:
    """A reference ``ViT_face`` / ``ViTs_face`` state dict -> ``model``'s key
    set, as ``hairci/retrieval/torch_import.py:convert_vit_face`` reads it:
    ``transformer.layers.{i}.0.fn`` is the attention (``norm``,
    ``fn.to_qkv``, ``fn.to_out.0``), ``transformer.layers.{i}.1.fn`` the
    feed-forward (``norm``, ``fn.net.0``, ``fn.net.3``), ``mlp_head.0`` the
    final LayerNorm, ``loss.weight`` (``loss.bias``) the margin head. Where
    the file holds no margin head, ``model``'s own stays (the JAX package
    merges over its init the same way). Raises ``KeyError`` where a tensor
    of the trunk is missing."""
    own = model.state_dict()
    out = {"cls_token": sd["cls_token"],
           "pos_embedding": sd["pos_embedding"],
           "mlp_head.weight": sd["mlp_head.0.weight"],
           "mlp_head.bias": sd["mlp_head.0.bias"]}
    pairs = [("patch_to_embedding", "patch_to_embedding")]
    for i in range(model.depth):
        attn, ff = f"transformer.layers.{i}.0.fn", f"transformer.layers.{i}.1.fn"
        t = f"blocks.{i}"
        pairs += [(f"{t}.attn.norm", f"{attn}.norm"),
                  (f"{t}.attn.to_out", f"{attn}.fn.to_out.0"),
                  (f"{t}.ff.norm", f"{ff}.norm"),
                  (f"{t}.ff.fc1", f"{ff}.fn.net.0"),
                  (f"{t}.ff.fc2", f"{ff}.fn.net.3")]
        out[f"{t}.attn.to_qkv.weight"] = sd[f"{attn}.fn.to_qkv.weight"]
    for ours, theirs in pairs:
        for p in ("weight", "bias"):
            out[f"{ours}.{p}"] = sd[f"{theirs}.{p}"]
    for ours, theirs in (("loss_weight", "loss.weight"),
                         ("loss_bias", "loss.bias")):
        if ours in own:
            out[ours] = sd.get(theirs, own[ours])
    return out


# ---------------------------------------------------------------------------
# the masked-image recipes
# ---------------------------------------------------------------------------

def mae_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``MAEModule`` params ({encoder, decoder}) -> the port's
    ``MAEModule`` state dict (load with ``strict=True``)."""
    enc = params["encoder"]
    depth = sum(1 for k in enc if k.startswith("block"))
    sd = {f"encoder.{k}": v
          for k, v in vit_state_dict_from_jax(enc, depth).items()}
    dec = params["decoder"]
    _put_dense(sd, "decoder.embed", dec["embed"])
    sd["decoder.mask_token"] = _t(dec["mask_token"])
    for i in range(sum(1 for k in dec if k.startswith("block"))):
        _block_from_jax(sd, f"decoder.blocks.{i}", dec[f"block{i}"])
    _put_norm(sd, "decoder.norm", dec["norm"])
    _put_dense(sd, "decoder.pred", dec["pred"])
    return sd


def simmim_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX ``SimMIMModule`` params -> the port's ``SimMIMModule`` state dict
    (load with ``strict=True``; the position table is a buffer of neither)."""
    sd = {"mask_token": _t(params["mask_token"])}
    sd["patch_embed.proj.weight"] = _t(np.transpose(
        np.asarray(params["patch_embed"]["proj"]["kernel"]), (3, 2, 0, 1)))
    sd["patch_embed.proj.bias"] = _t(params["patch_embed"]["proj"]["bias"])
    for i in range(sum(1 for k in params if k.startswith("blocks_"))):
        _block_from_jax(sd, f"blocks.{i}", params[f"blocks_{i}"])
    _put_norm(sd, "norm", params["norm"])
    _put_dense(sd, "decoder", params["decoder"])
    return sd


def _sub(sd: Mapping[str, torch.Tensor], prefix: str
         ) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def mae_state_dict(sd: Mapping[str, torch.Tensor], model: nn.Module
                   ) -> Dict[str, torch.Tensor]:
    """A reference MAE checkpoint (lightly's MaskedVisionTransformerTIMM
    with its timm ViT under ``backbone.vit.``; MAEDecoderTIMM under
    ``decoder.``: ``decoder_embed``, ``mask_token``, ``decoder_blocks.{i}``,
    ``decoder_norm``, ``decoder_pred``) -> the key set of ``model`` (the
    port's ``MAEModule``), as ``convert_mae`` reads it. A file without the
    decoder keeps ``model``'s own decoder (the JAX package converts only the
    encoder then). Raises ``KeyError`` where an encoder tensor is missing."""
    out = {f"encoder.{k}": v for k, v in
           timm_vit_state_dict(_sub(sd, "backbone.vit."),
                               model.encoder).items()}
    dec = _sub(sd, "decoder.")
    if "decoder_embed.weight" not in dec:
        out.update({k: v for k, v in model.state_dict().items()
                    if k.startswith("decoder.")})
        return out
    d = model.decoder.embed.out_features
    pairs = [("embed", "decoder_embed"), ("norm", "decoder_norm"),
             ("pred", "decoder_pred")]
    for i in range(len(model.decoder.blocks)):
        for name in ("norm1", "norm2", "attn.qkv", "attn.proj", "mlp.fc1",
                     "mlp.fc2"):
            pairs.append((f"blocks.{i}.{name}", f"decoder_blocks.{i}.{name}"))
    for ours, theirs in pairs:
        for p in ("weight", "bias"):
            out[f"decoder.{ours}.{p}"] = dec[f"{theirs}.{p}"]
    out["decoder.mask_token"] = dec["mask_token"].reshape(1, 1, d)
    return out


def simmim_state_dict(sd: Mapping[str, torch.Tensor], model: nn.Module
                      ) -> Dict[str, torch.Tensor]:
    """A reference SimMIM checkpoint (a torchvision ViT under
    ``backbone.vit.``, a linear ``decoder``) -> the key set of ``model``
    (the port's ``SimMIMModule``), as ``convert_simmim`` reads it: the patch
    embedding, blocks and final LayerNorm carry over; ``class_token`` and
    ``pos_embedding`` are dropped (the module has no cls token and a fixed
    sin-cos table); the mask token is the one under ``backbone.vit.``, else
    zeros, as JAX reads it. Raises ``KeyError`` where a tensor is missing."""
    vit = torchvision_vit_state_dict(_sub(sd, "backbone.vit."), model)
    out = {k: v for k, v in vit.items()
           if k.startswith(("patch_embed.", "blocks.", "norm."))
           or k == "mask_token"}
    out["decoder.weight"] = sd["decoder.weight"]
    out["decoder.bias"] = sd["decoder.bias"]
    return out


# ---------------------------------------------------------------------------
# DINOv2 and MSN
# ---------------------------------------------------------------------------

def dinov2_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """One branch of a JAX ``DINOv2Module`` ({backbone, dino_head}) -> the
    port's ``DINOv2Module`` state dict (load with ``strict=True``)."""
    sd = _backbone_from_jax(params["backbone"], {}, "vit", "backbone.")
    head = params["dino_head"]
    for fc in ("fc1", "fc2", "fc3"):
        _put_dense(sd, f"dino_head.{fc}", head[fc])
    sd["dino_head.prototypes"] = _t(head["prototypes"])
    return sd


def _mlp_head_from_jax(sd: Dict[str, torch.Tensor], name: str,
                       hp: Mapping, hs: Mapping, layout: Sequence,
                       dense: Sequence[str] = ()) -> None:
    """A JAX ``MLPHead`` (``dense{i}`` with its bias where it has one,
    ``bn{i}``) as lightly's ``{name}.layers.*``: ``layout`` holds the
    (Linear, BN or None) indices of each layer, ``dense`` other names of
    the Dense layers (DenseCL's local head: ``fc1``, ``fc2``)."""
    for i, (lin, bn) in enumerate(layout):
        p = hp[dense[i] if dense else f"dense{i}"]
        sd[f"{name}.layers.{lin}.weight"] = _t(np.asarray(p["kernel"]).T)
        if "bias" in p:
            sd[f"{name}.layers.{lin}.bias"] = _t(p["bias"])
        if bn is not None:
            _put_bn(sd, f"{name}.layers.{bn}", hp[f"bn{i}"], hs[f"bn{i}"])


def msn_state_dict_from_jax(params: Mapping, batch_stats: Mapping
                            ) -> Dict[str, torch.Tensor]:
    """One branch of a JAX ``MSNModule`` (params, batch_stats) -> the port's
    ``MSNModule`` state dict (load with ``strict=True``): the head's
    dense0 / bn0 / dense1 / bn1 / dense2 as ``projection_head.layers.{0,1,3,
    4,6}``."""
    sd = _backbone_from_jax(params["backbone"], {}, "vit", "backbone.")
    _mlp_head_from_jax(sd, "projection_head", params["projection_head"],
                       batch_stats["projection_head"],
                       ((0, 1), (3, 4), (6, None)))
    sd["prototypes"] = _t(params["prototypes"])
    return sd


def _weight_norm_v(sd: Mapping[str, torch.Tensor],
                   prefix: str) -> torch.Tensor:
    """The direction matrix of a weight-normalised Linear, in any of its
    three layouts: ``weight_v`` (``torch.nn.utils.weight_norm``),
    ``parametrizations.weight.original1`` (its parametrization), or a plain
    ``weight``. The gain is dropped: the head normalises the rows."""
    for key in (f"{prefix}.weight_v",
                f"{prefix}.parametrizations.weight.original1",
                f"{prefix}.weight"):
        if key in sd:
            return sd[key]
    raise KeyError(f"no weight-norm weight under {prefix}")


def dinov2_state_dict(sd: Mapping[str, torch.Tensor], model: nn.Module
                      ) -> Tuple[Dict[str, torch.Tensor],
                                 Dict[str, torch.Tensor]]:
    """A reference DINOv2 checkpoint -> (student, teacher) state dicts in the
    key set of ``model`` (the port's ``DINOv2Module``), as ``convert_dinov2``
    reads it: each timm ViT with its LayerScale (a missing mask token
    becomes zeros), each head's ``layers.{0,2,4}`` as ``fc1..fc3`` and
    ``last_layer``'s direction as ``prototypes``. Raises ``KeyError`` where a
    tensor is missing."""
    def branch(bprefix: str, hprefix: str) -> Dict[str, torch.Tensor]:
        out = {f"backbone.{k}": v for k, v in timm_vit_state_dict(
            _sub(sd, bprefix), model.backbone).items()}
        for fc, i in (("fc1", 0), ("fc2", 2), ("fc3", 4)):
            for p in ("weight", "bias"):
                out[f"dino_head.{fc}.{p}"] = sd[f"{hprefix}layers.{i}.{p}"]
        out["dino_head.prototypes"] = _weight_norm_v(
            sd, f"{hprefix}last_layer")
        return out

    return (branch("student_backbone.vit.", "student_head.dino_head."),
            branch("teacher_backbone.vit.", "teacher_head.dino_head."))


def msn_state_dict(sd: Mapping[str, torch.Tensor], model: nn.Module
                   ) -> Tuple[Dict[str, torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """A reference MSN checkpoint -> (anchor, target) state dicts in the key
    set of ``model`` (the port's ``MSNModule``), as ``convert_msn`` reads
    it: the anchor branch from ``anchor_backbone.vit.`` (a torchvision ViT)
    and ``anchor_projection_head.``, the target from ``backbone.vit.`` and
    ``projection_head.`` (lightly's MLP: linears ``layers.{0,3,6}``, BNs
    ``layers.{1,4}`` with their running statistics), ``prototypes`` in both.
    Raises ``KeyError`` where a tensor is missing."""
    head_keys = list(model.projection_head.state_dict())

    def branch(bprefix: str, hprefix: str) -> Dict[str, torch.Tensor]:
        out = {f"backbone.{k}": v for k, v in torchvision_vit_state_dict(
            _sub(sd, bprefix), model.backbone).items()}
        for key in head_keys:
            out[f"projection_head.{key}"] = sd[f"{hprefix}{key}"]
        out["prototypes"] = sd["prototypes"]
        return out

    return (branch("anchor_backbone.vit.", "anchor_projection_head."),
            branch("backbone.vit.", "projection_head."))


# ---------------------------------------------------------------------------
# BYOL and DenseCL
# ---------------------------------------------------------------------------

def byol_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                             model: str = "resnet50"
                             ) -> Dict[str, torch.Tensor]:
    """One branch of a JAX ``BYOLModule`` (params, batch_stats) -> the
    port's ``BYOLModule`` state dict (load with ``strict=True``): each
    head's dense0 / bn0 / dense1 as ``layers.{0,1,3}``."""
    sd = _backbone_from_jax(params["backbone"],
                            batch_stats.get("backbone", {}), model,
                            "backbone.")
    for head in ("projection_head", "prediction_head"):
        _mlp_head_from_jax(sd, head, params[head], batch_stats[head],
                           ((0, 1), (3, None)))
    return sd


def densecl_state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                                model: str = "resnet50"
                                ) -> Dict[str, torch.Tensor]:
    """One branch of a JAX ``DenseCLModule`` (params, batch_stats) -> the
    port's ``DenseCLModule`` state dict (load with ``strict=True``): the
    global head's dense0 / dense1 and the local head's fc1 / fc2 as
    ``layers.{0,2}``."""
    sd = _backbone_from_jax(params["backbone"], batch_stats["backbone"],
                            model, "backbone.")
    _mlp_head_from_jax(sd, "projection_head_global",
                       params["projection_head_global"], {},
                       ((0, None), (2, None)))
    _mlp_head_from_jax(sd, "projection_head_local",
                       params["projection_head_local"], {},
                       ((0, None), (2, None)), dense=("fc1", "fc2"))
    return sd


def densecl_state_dict(sd: Mapping[str, torch.Tensor], model: nn.Module
                       ) -> Tuple[Dict[str, torch.Tensor],
                                  Dict[str, torch.Tensor]]:
    """A reference DenseCL checkpoint -> (online, momentum) state dicts in
    the key set of ``model`` (the port's ``DenseCLModule``), as
    ``convert_densecl`` reads it: each trunk is
    ``nn.Sequential(*resnet50.children())[:-2]`` under ``backbone.<int>.``
    / ``backbone_momentum.<int>.``, each head lightly's
    ``projection_head_{global,local}{,_momentum}.layers.{0,2}``.
    ``num_batches_tracked`` counters are not read. Raises ``KeyError``
    where a tensor is missing."""
    seq = {name: index for index, name in _SEQUENTIAL_RESNET.items()}

    def branch(suffix: str) -> Dict[str, torch.Tensor]:
        out = {}
        for key in model.state_dict():
            top, _, rest = key.partition(".")
            if top == "backbone":
                child, _, tail = rest.partition(".")
                out[key] = sd[f"backbone{suffix}.{seq[child]}.{tail}"]
            else:
                out[key] = sd[f"{top}{suffix}.{rest}"]
        return out

    return branch(""), branch("_momentum")


# ---------------------------------------------------------------------------
# SiameseIM and SHAM v1
# ---------------------------------------------------------------------------

def _siam_block_from_jax(sd: Dict[str, torch.Tensor], t: str, bp: Mapping,
                         bs: Optional[Mapping]) -> None:
    """A JAX decoder ``Block``: LayerNorm, or PermuteBN (``normN.
    BatchNorm_0`` params and stats) as the port's ``normN.bn.*``."""
    if "BatchNorm_0" not in bp["norm1"]:
        _block_from_jax(sd, t, bp)
        return
    for mod, dense in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"),
                       ("mlp", "fc2")):
        _put_dense(sd, f"{t}.{mod}.{dense}", bp[mod][dense])
    for norm in ("norm1", "norm2"):
        _put_bn(sd, f"{t}.{norm}.bn", bp[norm]["BatchNorm_0"],
                bs[norm]["BatchNorm_0"])


def _cross_block_from_jax(sd: Dict[str, torch.Tensor], t: str,
                          xb: Mapping) -> None:
    """A JAX ``CrossBlock``'s params as the port's ``CrossBlock`` under
    ``t``."""
    for norm in ("norm_q", "norm_kv", "norm2"):
        _put_norm(sd, f"{t}.{norm}", xb[norm])
    for mod, dense in (("xattn", "q"), ("xattn", "kv"), ("xattn", "proj"),
                       ("mlp", "fc1"), ("mlp", "fc2")):
        _put_dense(sd, f"{t}.{mod}.{dense}", xb[mod][dense])


def siameseim_state_dict_from_jax(params: Mapping, batch_stats: Mapping
                                  ) -> Dict[str, torch.Tensor]:
    """One branch of a JAX ``SiameseIMModule`` (params, batch_stats) -> the
    port's ``SiameseIMModule`` state dict (load with ``strict=True``):
    ``projector_blocks_{i}`` / ``predictor_blocks_{i}`` as
    ``projector_blocks.{i}`` / ``predictor_blocks.{i}``."""
    enc = params["encoder"]
    depth = sum(1 for k in enc if k.startswith("block"))
    sd = {f"encoder.{k}": v
          for k, v in vit_state_dict_from_jax(enc, depth).items()}
    for name in ("decoder_embed", "decoder_pred", "decoder_pos_mlp"):
        _put_dense(sd, name, params[name])
    sd["mask_token"] = _t(params["mask_token"])
    for stack in ("projector_blocks", "predictor_blocks"):
        i = 0
        while f"{stack}_{i}" in params:
            _siam_block_from_jax(sd, f"{stack}.{i}", params[f"{stack}_{i}"],
                                 batch_stats.get(f"{stack}_{i}"))
            i += 1
    return sd


def sham_v1_state_dict_from_jax(params: Mapping
                                ) -> Dict[str, torch.Tensor]:
    """JAX ``SHAMv1Module`` params -> the port's ``SHAMv1Module`` state dict
    (load with ``strict=True``): ``decoder_blocks_{i}`` as
    ``decoder_blocks.{i}``, the cross block's ``xattn`` / ``norm_q`` /
    ``norm_kv`` / ``norm2`` / ``mlp`` under ``cross_align``."""
    sd = _backbone_from_jax(params["backbone"], {}, "vit", "backbone.")
    for name in ("proj_global_fc1", "proj_global_fc2", "proj_local_fc",
                 "pos_map", "decoder_pred"):
        _put_dense(sd, name, params[name])
    for name in ("proj_global_ln", "proj_local_ln"):
        _put_norm(sd, name, params[name])
    _cross_block_from_jax(sd, "cross_align", params["cross_align"])
    i = 0
    while f"decoder_blocks_{i}" in params:
        _block_from_jax(sd, f"decoder_blocks.{i}",
                        params[f"decoder_blocks_{i}"])
        i += 1
    sd["mask_token"] = _t(params["mask_token"])
    return sd


def siameseim_block_norm(sd: Mapping[str, torch.Tensor]) -> str:
    """The decoder blocks' norm layout of a reference SiameseIM checkpoint
    (``torch_import.siameseim_block_norm``): ``"ln"`` (the ``use_proj_ln``
    / ``use_pred_ln`` variant) or ``"permute_bn"`` (``normN.bn.*`` keys,
    the default, also when the file has no decoder blocks). Raises
    ``ValueError`` on a file that mixes the two: the module uses one norm
    for the projector and the predictor."""
    kinds = set()
    for k in sd:
        if "decoder_blocks." in k and ".norm1." in k:
            kinds.add("permute_bn" if ".norm1.bn." in k else "ln")
    if len(kinds) > 1:
        raise ValueError(
            "checkpoint mixes LayerNorm and PermuteBN decoder blocks "
            "(use_proj_ln != use_pred_ln); SiameseIM here uses one "
            "block_norm for both")
    return kinds.pop() if kinds else "permute_bn"


def siameseim_state_dict(sd: Mapping[str, torch.Tensor], model: nn.Module
                         ) -> Tuple[Dict[str, torch.Tensor],
                                    Dict[str, torch.Tensor]]:
    """A reference ``SiameseIMViT`` checkpoint -> (online, momentum) state
    dicts in the key set of ``model`` (the port's ``SiameseIMModule``, built
    with the file's ``siameseim_block_norm``), as ``convert_siameseim`` +
    ``merge_params`` read it over an initial state:
      * each encoder is a timm ViT, the online one at the top level, the
        momentum one under ``mm_`` with the shared ``pos_embed``; neither
        has a final norm (identity) nor an encoder mask token (zeros: the
        top-level ``mask_token`` is the decoder's);
      * where ``decoder_embed`` is present: it, the decoder-width
        ``mask_token`` and the ``projector_decoder_blocks.{i}``, and for
        the online branch the ``predictor_decoder_blocks.{i}``,
        ``decoder_pred`` and ``decoder_pos_mlp`` where present; a block's
        norms are LayerNorms or PermuteBNs (``normN.bn.*`` with running
        statistics);
      * everything the file lacks keeps ``model``'s own value (both
        branches start from the same initial state).
    Raises ``KeyError`` where a tensor of an encoder or of a present block
    is missing."""
    own = model.state_dict()

    def branch(src: Mapping[str, torch.Tensor],
               online: bool) -> Dict[str, torch.Tensor]:
        out = dict(own)
        # the top-level mask token is the decoder's: the encoder's is zeros
        enc = {k: v for k, v in src.items() if k != "mask_token"}
        out.update({f"encoder.{k}": v for k, v in timm_vit_state_dict(
            enc, model.encoder).items()})
        if "decoder_embed.weight" not in src:
            return out
        names = ["decoder_embed"]
        if online:
            names += [n for n in ("decoder_pred", "decoder_pos_mlp")
                      if f"{n}.weight" in src]
        for name in names:
            for p in ("weight", "bias"):
                out[f"{name}.{p}"] = src[f"{name}.{p}"]
        out["mask_token"] = src["mask_token"].reshape(own["mask_token"].shape)
        stacks = [("projector_blocks", "projector_decoder_blocks")]
        if online:
            stacks.append(("predictor_blocks", "predictor_decoder_blocks"))
        for ours, theirs in stacks:
            for i in range(len(getattr(model, ours))):
                if f"{theirs}.{i}.attn.qkv.weight" not in src:
                    break
                prefix = f"{ours}.{i}."
                for key in own:
                    if key.startswith(prefix):
                        out[key] = src[f"{theirs}.{i}.{key[len(prefix):]}"]
        return out

    mm = {k[3:]: v for k, v in sd.items() if k.startswith("mm_")}
    mm["pos_embed"] = sd["pos_embed"]
    return branch(sd, True), branch(mm, False)


# ---------------------------------------------------------------------------
# DualViewHair
# ---------------------------------------------------------------------------

def dualview_state_dict_from_jax(variables: Mapping, encoder: str = "resnet",
                                 backbone: str = "resnet50"
                                 ) -> Dict[str, torch.Tensor]:
    """One tower of a JAX DualViewHair encoder (``{"params": ...,
    "batch_stats": ...}``: a ``HairstyleEncoder`` for ``encoder="resnet"``,
    else ``MultiScaleHairEncoder`` / ``PartBasedHairEncoder``) -> the port's
    encoder's state dict (load with ``strict=True``). The trunk goes
    through ``resnet_state_dict_from_jax`` under ``backbone.``; the
    attention conv's HWIO kernel becomes OIHW; ``part_heads_{i}`` become
    ``part_heads.{i}``."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd = _backbone_from_jax(params["backbone"], stats["backbone"], backbone,
                            "backbone.")
    if encoder == "resnet":
        for fc, bn in (("emb_fc", "emb_bn"), ("proj_fc1", "proj_bn1"),
                       ("proj_fc2", "proj_bn2")):
            _put_dense(sd, fc, params[fc])
            _put_bn(sd, bn, params[bn], stats[bn])
    elif encoder == "multiscale":
        conv = params["attn"]["Conv_0"]
        _put_conv(sd, "attn.conv", conv)
        sd["attn.conv.bias"] = _t(conv["bias"])
        for name in ("emb", "proj1", "proj2"):
            _put_dense(sd, name, params[name])
    elif encoder == "partbased":
        i = 0
        while f"part_heads_{i}" in params:
            _put_dense(sd, f"part_heads.{i}", params[f"part_heads_{i}"])
            i += 1
        _put_dense(sd, "proj", params["proj"])
    else:
        raise ValueError(f"unknown encoder {encoder!r}")
    return sd


def cross_view_alignment_state_dict_from_jax(params: Mapping
                                             ) -> Dict[str, torch.Tensor]:
    """JAX ``CrossViewAlignment`` params -> the port's (its
    ``CrossAttention_0`` as ``attn``; load with ``strict=True``)."""
    sd: Dict[str, torch.Tensor] = {}
    for dense in ("q", "kv", "proj"):
        _put_dense(sd, f"attn.{dense}", params["CrossAttention_0"][dense])
    return sd
