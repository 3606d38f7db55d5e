"""DualViewHair (port of hairci.experiments.dualview): teacher (hair-only
crop) / student (full image) dual-view contrastive learning, the enhanced
encoders, and the quantitative and qualitative retrieval evaluations."""

from hairci_torch.experiments.dualview.models import (
    HairstyleEncoder,
    DualViewHairModel,
    contrastive_loss,
    HairstyleRetrievalModel,
)
from hairci_torch.experiments.dualview.losses import (
    ntxent_loss_symmetric,
    asymmetric_ntxent_loss,
    MomentumQueue,
)
