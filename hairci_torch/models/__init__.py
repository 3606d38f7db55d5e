"""Models (port of hairci.models): ``build_backbone`` and
``backbone_feature_dim`` by name, as ``hairci/models/__init__.py`` has
them. The submodules are imported inside the functions: ``heads`` imports
``resnet``, which would otherwise come back here half-initialised."""


def backbone_feature_dim(name: str) -> int:
    """Feature width of a backbone by name (resnet* or a ``VIT_CONFIGS``
    name)."""
    from hairci_torch.models.resnet import MODEL_DICT
    from hairci_torch.models.vit import VIT_CONFIGS

    if name in MODEL_DICT:
        return MODEL_DICT[name]
    if name in VIT_CONFIGS:
        return VIT_CONFIGS[name][1]
    raise ValueError(f"unknown backbone {name!r}")


def build_backbone(name: str, img_size: int = 224, dtype=None, **kw):
    """A ResNet through ``build_resnet`` or a ViT through ``build_vit``,
    f32 weights computed in ``dtype`` (default f32), as flax builds both;
    ``ValueError`` for any other name."""
    import torch

    from hairci_torch.models.resnet import MODEL_DICT, build_resnet
    from hairci_torch.models.vit import VIT_CONFIGS, build_vit

    dtype = dtype or torch.float32
    if name in MODEL_DICT:
        return build_resnet(name, dtype=dtype, **kw)
    if name in VIT_CONFIGS:
        kw.setdefault("param_dtype", torch.float32)
        return build_vit(name, img_size=img_size, dtype=dtype, **kw)
    raise ValueError(f"unknown backbone {name!r}")
