"""Dual-view models (port of ``hairci/experiments/dualview/models.py``).

  - ``HairstyleEncoder``: a ResNet trunk -> Linear 256 + BN + ReLU (the
    embedding) -> Linear 256 + BN + ReLU -> Linear 128 + BN (the
    projection). The head's BNs are the port's ``BatchNorm`` in the centred
    form of ``flax.linen.BatchNorm`` (momentum 0.9, eps 1e-5, the biased
    variance), so in train mode all 56 BNs of a ResNet-50 encoder take their
    statistics from the bn_stats kernel on a card.
  - ``contrastive_loss``: InfoNCE with the positives on the diagonal.
  - ``DualViewHairModel``: the student (online encoder) sees the full image,
    the teacher (its EMA copy, parameters and BN statistics) the hair-only
    crop. One step: the EMA update first, then the teacher's projection in
    eval mode under ``torch.no_grad()`` (so a ResNet-50 teacher's three
    layer1 3x3 convs go to the conv3x3 kernel on a card), then the
    student's forward in train mode, the loss and Adam (no decay, no
    clipping).
  - ``HairstyleRetrievalModel``: the embeddings of a database of images in
    the port's ``GalleryIndex``, searched by cosine similarity.

The port updates the train state in place (the JAX step returns a new one).
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from hairci_torch.eval.features import l2_normalize
from hairci_torch.models.heads import Linear
from hairci_torch.models.norm import BatchNorm
from hairci_torch.models.resnet import MODEL_DICT, build_resnet
from hairci_torch.retrieval.index import GalleryIndex
from hairci_torch.train.optim import fill_missing_grads_, make_optimizer
from hairci_torch.train.state import TrainState, ema_update
from hairci_torch.utils.device import DeviceLike, resolve_device


class HairstyleEncoder(nn.Module):
    """ResNet trunk + embedding head + projection head; ``forward`` maps
    (B, H, W, 3) to the f32 projection (B, 128), or with
    ``return_embedding`` to the f32 embedding (B, 256). Train or eval mode
    is the module's own."""

    def __init__(self, backbone_name: str = "resnet50",
                 embedding_dim: int = 256, projection_dim: int = 128,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.projection_dim = projection_dim
        self.backbone = build_resnet(backbone_name, dtype=dtype)
        feat = MODEL_DICT[backbone_name]
        self.emb_fc = Linear(feat, embedding_dim, bias=True, dtype=dtype)
        self.emb_bn = BatchNorm(embedding_dim, dtype=dtype, centered=True)
        self.proj_fc1 = Linear(embedding_dim, embedding_dim, bias=True,
                               dtype=dtype)
        self.proj_bn1 = BatchNorm(embedding_dim, dtype=dtype, centered=True)
        self.proj_fc2 = Linear(embedding_dim, projection_dim, bias=True,
                               dtype=dtype)
        self.proj_bn2 = BatchNorm(projection_dim, dtype=dtype, centered=True)

    def forward(self, x: torch.Tensor,
                return_embedding: bool = False) -> torch.Tensor:
        e = F.relu(self.emb_bn(self.emb_fc(self.backbone(x))))
        if return_embedding:
            return e.float()
        z = F.relu(self.proj_bn1(self.proj_fc1(e)))
        return self.proj_bn2(self.proj_fc2(z)).float()


def contrastive_loss(student_proj: torch.Tensor, teacher_proj: torch.Tensor,
                     temperature: float = 0.07) -> torch.Tensor:
    """InfoNCE of the normalised projections, the positives on the
    diagonal (the reference's ``ContrastiveLoss``)."""
    s = l2_normalize(student_proj.float())
    t = l2_normalize(teacher_proj.float())
    labels = torch.arange(s.shape[0], device=s.device)
    return F.cross_entropy((s @ t.T) / temperature, labels)


def _module_device(module: nn.Module) -> torch.device:
    return next(module.parameters()).device


class DualViewHairModel:
    """The teacher-student recipe: the student sees the full image, the
    teacher (the student's EMA) the hair-only crop."""

    def __init__(self, backbone: str = "resnet50", embedding_dim: int = 256,
                 projection_dim: int = 128, momentum: float = 0.999,
                 temperature: float = 0.07, learning_rate: float = 1e-3,
                 dtype: torch.dtype = torch.float32, encoder: str = "resnet"):
        if encoder != "resnet":
            from hairci_torch.experiments.dualview.enhanced import ENCODERS

            if encoder not in ENCODERS:
                raise ValueError(f"unknown encoder {encoder!r}")
        self.backbone = backbone
        self.embedding_dim = embedding_dim
        self.projection_dim = projection_dim
        self.dtype = dtype
        self.encoder_type = encoder
        self.momentum = momentum
        self.temperature = temperature
        self.learning_rate = learning_rate

    def build_encoder(self) -> nn.Module:
        """A new encoder with weights from torch's global generator: the
        ``HairstyleEncoder``, or an enhanced one by name
        (``enhanced.ENCODERS``)."""
        if self.encoder_type == "resnet":
            cls = HairstyleEncoder
        else:
            from hairci_torch.experiments.dualview.enhanced import ENCODERS

            cls = ENCODERS[self.encoder_type]
        return cls(backbone_name=self.backbone,
                   embedding_dim=self.embedding_dim,
                   projection_dim=self.projection_dim, dtype=self.dtype)

    def create_state(self, seed: int, device: DeviceLike = None
                     ) -> TrainState:
        """Seeded random weights on ``device``; the EMA teacher starts as
        a copy of them; Adam (``optax.adam``: no decay, eps 1e-8)."""
        device = resolve_device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            online = self.build_encoder()
        online = online.to(device).to(memory_format=torch.channels_last)
        ema = copy.deepcopy(online).requires_grad_(False).eval()
        return TrainState(online=online, ema=ema, optimizer=make_optimizer(
            online, self.learning_rate, 0.0))

    def update(self, state: TrainState, full: torch.Tensor,
               hair: torch.Tensor,
               loss_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step on normalised views (B, H, W, 3) on the state's device,
        in JAX's order: the EMA of parameters and BN statistics, the
        teacher's projection of ``hair`` (eval mode, no gradient), the
        student's of ``full`` (train mode), ``loss_fn(student, teacher)``,
        Adam. Returns (the loss, the teacher's projection), both detached."""
        online, ema = state.online, state.ema
        ema_update(ema, online, self.momentum)
        ema.eval()
        with torch.no_grad():
            teacher = ema(hair)
        online.train()
        loss = loss_fn(online(full), teacher)
        state.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        fill_missing_grads_(state.optimizer)
        state.optimizer.step()
        state.step += 1
        return loss.detach(), teacher

    def train_step(self, state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
        """``batch``: the student's ``full`` and the teacher's ``hair``
        views, normalised; the loss is ``contrastive_loss``."""
        loss, _ = self.update(
            state, batch["full"], batch["hair"],
            lambda s, t: contrastive_loss(s, t, self.temperature))
        return {"loss": loss}

    @torch.no_grad()
    def get_embeddings(self, state: TrainState, images: torch.Tensor,
                       use_teacher: bool = False) -> torch.Tensor:
        """The f32 embeddings (before the projection head) of normalised
        images, in eval mode: the student's, or the teacher's."""
        module = state.ema if use_teacher else state.online
        was_training = module.training
        module.eval()
        try:
            x = torch.as_tensor(images).to(_module_device(module))
            return module(x, return_embedding=True)
        finally:
            module.train(was_training)


class HairstyleRetrievalModel:
    """Stores the L2-normalised embeddings of a database and retrieves by
    cosine similarity (``GalleryIndex`` on the state's device: for k <= 8
    on a card, the top-k kernel)."""

    def __init__(self, model: DualViewHairModel, state: TrainState,
                 use_teacher: bool = True):
        self.model = model
        self.state = state
        self.use_teacher = use_teacher
        self.index: Optional[GalleryIndex] = None

    def _embed(self, images: Any) -> np.ndarray:
        return self.model.get_embeddings(
            self.state, torch.as_tensor(np.asarray(images)),
            self.use_teacher).cpu().numpy()

    def build_database(self, images: Any, paths: Sequence[str]
                       ) -> GalleryIndex:
        self.index = GalleryIndex(self._embed(images), paths,
                                  device=_module_device(self.state.online))
        return self.index

    def retrieve(self, query_images: Any, k: int = 10):
        assert self.index is not None, "call build_database first"
        return self.index.search_paths(self._embed(query_images), k)
