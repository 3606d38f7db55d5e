"""Distillation losses (port of ``hairci/losses/distill.py``): BYOL's
negative cosine, cosine distillation, DINO with its EMA centre, the iBOT
patch loss, KoLeo and MSN.

All are functions of their inputs; what the JAX package carries in the
train state (the DINO and iBOT centres) comes back as a new tensor, without
a gradient. The products over prototypes and KoLeo's similarities are f32,
as ``preferred_element_type=f32`` makes them in JAX.

Under data parallelism (``parallel.collectives``) DINO's and KoLeo's batch
quantities are the global batch's, as under JAX's sharding: DINO's
cross-entropy terms and its centre are global means (the centre comes out
bitwise equal on every rank), and KoLeo takes each rank's rows' nearest
neighbours among every rank's rows; BYOL's negative cosine is a global
mean; MSN's Sinkhorn sums over every rank's targets, and its cross-entropy
and mean probabilities are global means. The iBOT loss of the DINOv2 step
is global in ``ssl.dinov2``; the others here are per-rank functions.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from hairci_torch.parallel import collectives


def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) over the last axis."""
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)


def negative_cosine_similarity(p: torch.Tensor,
                               z: torch.Tensor) -> torch.Tensor:
    """BYOL / SimSiam: -cos(p, z) with no gradient through ``z``, mean over
    the batch (every rank's rows under data parallelism)."""
    return -collectives.global_mean(torch.sum(
        _normalize(p) * _normalize(z.detach()), dim=-1))


def distillation_loss(z_student: torch.Tensor, z_teacher: torch.Tensor,
                      reduction: str = "mean") -> torch.Tensor:
    """1 - cos(student, teacher), reduced by ``mean``, ``sum`` or not."""
    loss = 1.0 - torch.sum(_normalize(z_student) * _normalize(z_teacher),
                           dim=-1)
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    return loss


# ---------------------------------------------------------------------------
# DINO and iBOT
# ---------------------------------------------------------------------------

def dino_loss(teacher_out: Sequence[torch.Tensor],
              student_out: Sequence[torch.Tensor], center: torch.Tensor,
              teacher_temp: float = 0.04, student_temp: float = 0.1,
              center_momentum: float = 0.9
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy of the centred, sharpened teacher distributions (the
    global views) against the student's log-softmax (all views), skipping
    the pairs of one view with itself. Returns (loss, new centre); the
    centre moves toward the mean teacher logit of the batch."""
    t_probs = [torch.softmax((t - center) / teacher_temp, dim=-1).detach()
               for t in teacher_out]
    s_logp = [torch.log_softmax(s / student_temp, dim=-1)
              for s in student_out]
    total, n_terms = 0.0, 0
    for it, tp in enumerate(t_probs):
        for is_, sl in enumerate(s_logp):
            if it == is_:
                continue
            total = total + collectives.global_mean(
                -torch.sum(tp * sl, dim=-1))
            n_terms += 1
    loss = total / max(n_terms, 1)
    batch_center = collectives.all_reduce_mean(torch.mean(
        torch.cat(list(teacher_out), dim=0), dim=0, keepdim=True))
    new_center = center * center_momentum + batch_center * (
        1 - center_momentum)
    return loss, new_center.detach()


def ibot_patch_loss(teacher_patch_out: torch.Tensor,
                    student_patch_out: torch.Tensor, mask: torch.Tensor,
                    center: torch.Tensor, teacher_temp: float = 0.04,
                    student_temp: float = 0.1, center_momentum: float = 0.9
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """iBOT's masked-patch cross-entropy (lightly ``IBOTPatchLoss``) over
    (B, N, K) logits where ``mask`` (B, N) is set; the centre moves toward
    the mean teacher logit of the masked patches. Returns (loss, new
    centre)."""
    tp = torch.softmax((teacher_patch_out - center) / teacher_temp,
                       dim=-1).detach()
    sl = torch.log_softmax(student_patch_out / student_temp, dim=-1)
    ce = -torch.sum(tp * sl, dim=-1)
    m = mask.to(ce.dtype)
    count = torch.clamp(torch.sum(m), min=1.0)
    loss = torch.sum(ce * m) / count
    batch_center = (torch.sum(teacher_patch_out * m[..., None], dim=(0, 1))
                    / count)[None]
    new_center = center * center_momentum + batch_center * (
        1 - center_momentum)
    return loss, new_center.detach()


def koleo_loss(z: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """KoLeo (DINOv2): -mean(log(distance to the nearest other row)) of the
    normalised rows, as -0.5 * mean(log(d^2 + eps)), which stays finite
    where two rows coincide (the square root's gradient would not). Under
    data parallelism ``z`` is this rank's rows: their neighbours are sought
    among every rank's rows (gathered with their gradient), self excluded
    at the global row, and the mean is the global batch's."""
    z = _normalize(z, eps)
    b = z.shape[0]
    # without a process group the same steps and no collective
    keys = collectives.all_gather(z).float()
    own = collectives.rank() * b + torch.arange(b, device=z.device)
    sim = torch.matmul(keys[own], keys.T)
    sim = sim - 2.0 * torch.nn.functional.one_hot(
        own, keys.shape[0]).to(sim.dtype)                 # exclude self
    nn_sim = torch.max(sim, dim=1).values
    d2 = torch.clamp(2.0 - 2.0 * nn_sim, min=0.0)
    return -0.5 * collectives.global_mean(torch.log(d2 + eps))


# ---------------------------------------------------------------------------
# MSN
# ---------------------------------------------------------------------------

def msn_loss(anchors: torch.Tensor, targets: torch.Tensor,
             prototypes: torch.Tensor, temperature: float = 0.1,
             sinkhorn_iterations: int = 3,
             me_max_weight: float = 1.0) -> torch.Tensor:
    """lightly ``MSNLoss``: cross-entropy of the anchors' prototype
    probabilities against the Sinkhorn-balanced target probabilities (no
    gradient through ``targets``), plus the mean-entropy maximisation term.
    ``anchors`` holds A = T * views rows, view-major. Under data
    parallelism both are this rank's rows: Sinkhorn balances the global
    batch's targets, and the cross-entropy and the anchors' mean
    probabilities are means over every rank's anchors."""
    a = _normalize(anchors)
    t = _normalize(targets.detach())
    p = _normalize(prototypes)
    a_probs = torch.softmax(torch.matmul(a.float(), p.float().T)
                            / temperature, dim=-1)
    t_probs = torch.softmax(torch.matmul(t.float(), p.float().T)
                            / temperature, dim=-1)
    t_probs = _sinkhorn(t_probs, sinkhorn_iterations)
    t_probs = t_probs.repeat(anchors.shape[0] // targets.shape[0], 1)
    ce = -collectives.global_mean(torch.sum(
        t_probs * torch.log(a_probs + 1e-12), dim=-1))
    mean_probs = collectives.all_reduce_mean(torch.mean(a_probs, dim=0))
    me_max = torch.sum(mean_probs * torch.log(mean_probs + 1e-12)) \
        + math.log(a_probs.shape[1])
    return ce + me_max_weight * me_max


def _sinkhorn(probs: torch.Tensor, iterations: int) -> torch.Tensor:
    """Sinkhorn-Knopp over (rows = samples, cols = prototypes): ``iterations``
    row and column normalisations of the transposed matrix (the JAX
    package's ``lax.scan``), without a gradient. Under data parallelism
    ``probs`` is this rank's samples: the total and each prototype's sum
    over the samples are summed over the ranks, and T is the global sample
    count."""
    if iterations == 0:
        return probs
    q = probs.detach().T
    q = q / collectives.all_reduce_sum(torch.sum(q))
    K = q.shape[0]
    T = q.shape[1] * collectives.world()
    for _ in range(iterations):
        q = q / torch.clamp(collectives.all_reduce_sum(
            torch.sum(q, dim=1, keepdim=True)), min=1e-12) / K
        q = q / torch.clamp(torch.sum(q, dim=0, keepdim=True), min=1e-12) / T
    return (q * T).T
