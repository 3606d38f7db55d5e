"""Plain SHAM (HSimCLR) steps in float32, from the seed or from a state the
program reached: the reference the training cells' ``correct`` is decided
against.

One step, as the configuration states it (the paper's recipe, as
``configs/pretrain_sham.yaml`` sets it):
  1. two SimCLR views of the uint8 batch (anchor, pos1), from the step's
     CPU generator (``reference.aug``, a frozen copy);
  2. the EMA teacher <- m * EMA + (1 - m) * online, parameters and BN
     statistics, before the forward;
  3. negatives: in the ``mine`` stage the k-th most cosine-similar pos1
     view by the EMA's eval-mode trunk features (k = 1 is the row itself,
     ties to the lower index), cached per batch; ``mined`` reads the cache;
  4. positives: pos1 rotated (3-shear, nearest) and 3-tap blurred, then
     hair patches masked;
  5. one train-mode forward over [negatives; positives; anchors] and an
     eval-mode EMA forward of the masked positives;
  6. NT-Xent(positives, anchors) + w_t * triplet + w_m * MSE(positives,
     masked EMA positives) (+ w_s * Smooth-AP over [anchors; positives;
     negatives]); the gradient clipped at global norm 1 (no eps), AdamW
     with decay on every leaf of two or more axes but biases; leaves that
     take no gradient get a zero one and still decay.

What it returns: the loss of every step, the norm of each leaf's first
gradient as the optimiser takes it (after the clip), and the norm of each
leaf's change over the steps run; and, for a ``mine`` step, the similarity
its negatives are picked by.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from harness import data
from reference import aug, resnet, vit
from reference.nn import Params, Precision, maybe_checkpoint

BUFFERS = (".running_mean", ".running_var")


def l2n(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


def nt_xent(z0, z1, temperature):
    z = torch.cat([l2n(z0), l2n(z1)], 0)
    n = z.shape[0]
    sim = (z @ z.T) / temperature
    sim = sim.masked_fill(torch.eye(n, dtype=torch.bool, device=z.device),
                          float("-inf"))
    pos = (torch.arange(n, device=z.device) + n // 2) % n
    return -F.log_softmax(sim, 1).gather(1, pos[:, None]).mean()


def triplet(a, p, n, margin, eps=1e-6):
    d_ap = torch.linalg.vector_norm(a - p + eps, dim=-1)
    d_an = torch.linalg.vector_norm(a - n + eps, dim=-1)
    return torch.clamp(d_ap - d_an + margin, min=0.0).mean()


def smooth_ap(e: torch.Tensor, tau: float, views: int,
              chunk: int = 64) -> torch.Tensor:
    """1 - mean AP, the ranks relaxed by a sigmoid of the score
    differences over ``tau`` (Brown et al. 2020); the positives of a row
    are its other views."""
    z = l2n(e)
    n = z.shape[0]
    t = torch.arange(n // views, device=z.device).repeat(views)
    sim = z @ z.T
    eye = torch.eye(n, device=z.device)
    pos = (t[:, None] == t[None, :]).float() - eye
    every = 1.0 - eye

    def ap(s, pm, am):
        sig = torch.sigmoid((s[:, None, :] - s[:, :, None]) / tau)
        rank_pos = 1.0 + (sig * pm[:, None, :]).sum(2)
        rank_all = 1.0 + (sig * am[:, None, :]).sum(2)
        return ((rank_pos / (rank_all + 1e-8)) * pm).sum(1) / (pm.sum(1)
                                                               + 1e-8)

    aps = [maybe_checkpoint(ap, sim[i:i + chunk], pos[i:i + chunk],
                            every[i:i + chunk]) for i in range(0, n, chunk)]
    return 1.0 - torch.cat(aps).mean()


def pieces(name: str, t: torch.Tensor):
    """A leaf as the published architecture has it: a fused query-key-value
    projection is three (the key's bias takes no gradient under the
    softmax, the query's and value's do)."""
    if ".attn.qkv." in name:
        return list(zip((name + ".q", name + ".k", name + ".v"),
                        t.chunk(3, dim=0)))
    return [(name, t)]


def norms(named) -> Dict[str, float]:
    """Norm of every piece of every leaf, ``named`` (name, tensor) pairs."""
    return {n: float(torch.linalg.vector_norm(t.float()))
            for name, tensor in named for n, t in pieces(name, tensor)}


def decays(name: str, shape) -> bool:
    return not (name.split(".")[-1] == "bias" or len(shape) <= 1)


class ShamReference:
    """The SHAM model of one configuration, in plain float32 (or, as the
    control, with every product's inputs rounded to fp8)."""

    def __init__(self, config, device, precision: str = "f32"):
        self.cfg = config
        self.model = config["model"]
        self.recipe = config["sham"]
        self.img = config["img_size"]
        self.device = torch.device(device)
        self.P = Precision(precision)
        arch = self.model["arch"]
        if self.model["kind"] == "resnet":
            trunk = resnet.spec(arch)
            d = resnet.num_features(arch)
        else:
            trunk = vit.spec(arch, self.img)
            d = arch["width"]
        hidden, out = self.model["proj"]
        self.leaves = trunk + resnet.head_spec(d, hidden, out)

    # -- the model -----------------------------------------------------------
    def trunk(self, p: Params, x, train: bool):
        if self.model["kind"] == "resnet":
            return resnet.features(self.model["arch"], self.P, p, x, train)
        return vit.features(self.model["arch"], self.P, p, x), {}

    def forward(self, p: Params, x, train: bool):
        f, new = self.trunk(p, x, train)
        y, new_head = resnet.head(self.P, p, f, train)
        return y, {**new, **new_head}

    # -- state and steps -----------------------------------------------------
    def init_state(self, seed: int) -> Dict[str, object]:
        """The state of step 0: the seed's weights, the EMA a copy of them,
        Adam's moments at nought."""
        leaves = data.make_params(self.leaves, seed, self.device)
        return self._state(leaves, dict(leaves), {}, {}, 0)

    def load_state(self, snap: Dict[str, object]) -> Dict[str, object]:
        """A state the program reached (``snapshot`` of its ``TrainState``:
        the online and EMA state, Adam's moments and step count), moved to
        this reference's device in float32."""
        dev = lambda d: {n: t.to(self.device, torch.float32)
                         for n, t in d.items()}
        return self._state(dev(snap["online"]), dev(snap["ema"]),
                           dev(snap["m"]), dev(snap["v"]), int(snap["t"]))

    def _state(self, online, ema, m, v, t) -> Dict[str, object]:
        fixed = {leaf.name for leaf in self.leaves if leaf.init == "fixed"}
        trainable = [n for n in online if not n.endswith(BUFFERS)]
        # a fixed leaf (the ViT's sin-cos table) takes no gradient; it still
        # decays, as every leaf of the optimiser does
        params = {n: online[n].clone().requires_grad_(n not in fixed)
                  for n in trainable}
        return {"params": params,
                "bufs": {n: t_.clone() for n, t_ in online.items()
                         if n.endswith(BUFFERS)},
                "ema": {n: t_.clone() for n, t_ in ema.items()},
                "m": {n: (m[n].clone() if n in m else torch.zeros_like(p))
                      for n, p in params.items()},
                "v": {n: (v[n].clone() if n in v else torch.zeros_like(p))
                      for n, p in params.items()},
                "t": t, "cache": {}}

    def run(self, seed: int, batch_size: int, steps: int, stage: str,
            k: int) -> Dict[str, object]:
        """``steps`` steps from the seed's weights, on batch ids 0, 1, ...
        (one batch each, all rows different), step ``s`` drawing from
        generator ``s``; returns the readings."""
        return self.steps(self.init_state(seed), seed, batch_size,
                          [(stage, s, s) for s in range(steps)], k)

    def steps(self, st: Dict[str, object], seed: int, batch_size: int,
              plan: Sequence, k: int) -> Dict[str, object]:
        """The steps of ``plan`` ((stage, batch id, generator) each) from
        state ``st``, which they advance; returns the loss of every step,
        the norm of each leaf's first gradient as the optimiser took it
        (after the clip), and the norm of each leaf's change over them."""
        r = self.recipe
        params, bufs, m, v = st["params"], st["bufs"], st["m"], st["v"]
        start = {n: t.detach().clone() for n, t in params.items()}
        losses: List[float] = []
        grad_norms: Dict[str, float] = {}
        b1, b2 = r["betas"]
        for s, (stage, batch_id, counter) in enumerate(plan):
            images = data.make_images(batch_size, self.img, seed,
                                      (data.IMAGES, batch_id), self.device)
            gen = data.step_generator(seed, counter)
            loss, grads, new_stats = self._loss_and_grads(
                params, bufs, st["ema"], images, gen, stage, batch_id, k,
                st["cache"])
            losses.append(float(loss))
            with torch.no_grad():
                total = math.sqrt(sum(float((g * g).sum())
                                      for g in grads.values()))
                scale = 1.0 if total < 1.0 else 1.0 / total
                st["t"] += 1
                t = st["t"]
                if s == 0:
                    grad_norms = norms((n, g * scale)
                                       for n, g in grads.items())
                for n, p in params.items():
                    g = grads[n] * scale
                    if decays(n, p.shape):
                        p.mul_(1.0 - r["lr"] * r["weight_decay"])
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(1e-8)
                    p.addcdiv_(m[n], denom, value=-r["lr"] / (1 - b1 ** t))
                bufs.update(new_stats)
        delta = norms((n, params[n].detach() - start[n]) for n in params)
        return {"loss": losses, "grad": grad_norms, "delta": delta}

    def similarity(self, st: Dict[str, object], seed: int, batch_size: int,
                   batch_id: int, counter: int) -> torch.Tensor:
        """What a ``mine`` step from state ``st`` ranks: the cosine
        similarity of every pair of the batch's pos1 views by the EMA's
        eval-mode trunk features, the EMA first moved towards the online
        weights (``st`` is left as it is)."""
        images = data.make_images(batch_size, self.img, seed,
                                  (data.IMAGES, batch_id), self.device)
        B, H, W, _ = images.shape
        d = aug.sham_draw(data.step_generator(seed, counter), B, H, W,
                          self.img, tuple(self.recipe["mask_ratio_range"]))
        _, x_pos1 = aug.sham_views(images, d, self.img)
        online = {**st["params"], **st["bufs"]}
        mom = self.recipe["ema"]
        with torch.no_grad():
            ema = {n: t * mom + online[n].detach() * (1.0 - mom)
                   for n, t in st["ema"].items()}
            z = l2n(self.trunk(ema, x_pos1, train=False)[0], eps=1e-8)
            return z @ z.T

    def _loss_and_grads(self, params, bufs, ema, images, gen, stage, batch_id,
                        k, cache):
        r = self.recipe
        B, H, W, _ = images.shape
        d = aug.sham_draw(gen, B, H, W, self.img, tuple(r["mask_ratio_range"]))
        x_anchor, x_pos1 = aug.sham_views(images, d, self.img)
        online = {**params, **bufs}
        with torch.no_grad():
            mom = r["ema"]
            for n in ema:
                ema[n] = ema[n] * mom + online[n].detach() * (1.0 - mom)
            if stage == "mine":
                feats, _ = self.trunk(ema, x_pos1, train=False)
                z = l2n(feats, eps=1e-8)
                cache[batch_id] = picks(z @ z.T, k)
            elif stage == "warmup":
                perm = d["perm"].to(self.device)
                idx = torch.arange(B, device=self.device)
                cache[batch_id] = torch.where(perm == idx, (perm + 1) % B,
                                              perm)
            neg_idx = cache[batch_id]
            margin = r["margin_stage1"] if stage == "warmup" \
                else r["margin_stage2"]
            negative = x_pos1[neg_idx]
            pos = aug.positive_transform(x_pos1, d["positive"])
            masked = aug.positive_masking(pos, d["mask"])
            masked_b = l2n(self.forward(ema, masked, train=False)[0])
        out, new_stats = self.forward(online, torch.cat([negative, pos,
                                                         x_anchor]), True)
        neg_b, pos_b, anc_b = (l2n(t) for t in out.chunk(3))
        loss = (nt_xent(pos_b, anc_b, r["temperature"])
                + r["triplet_w"] * triplet(anc_b, pos_b, neg_b, margin)
                + r["mse_w"] * torch.square(pos_b - masked_b).mean())
        if r.get("s2r2_weight", 0.0) > 0:
            loss = loss + r["s2r2_weight"] * smooth_ap(
                torch.cat([anc_b, pos_b, neg_b]), 0.01, 3)
        names = [n for n, t in params.items() if t.requires_grad]
        grads = torch.autograd.grad(loss, [params[n] for n in names],
                                    allow_unused=True)
        grads = dict(zip(names, grads))
        grads = {n: (torch.zeros_like(t) if grads.get(n) is None
                     else grads[n]) for n, t in params.items()}
        return loss.detach(), grads, new_stats


def picks(sims: torch.Tensor, k: int) -> torch.Tensor:
    """Each row's k-th most similar row (k = 1 is the row itself, ties to
    the lower index): the negatives a ``mine`` step caches."""
    order = torch.sort(-sims, dim=1, stable=True).indices
    return order[:, min(max(k - 1, 0), sims.shape[0] - 1)]


def pick_gap(sims: torch.Tensor, picked, k: int) -> float:
    """How far the picked negatives lie from each row's k-th neighbour by
    the reference's similarity ``sims``: the widest gap, over rows, between
    the similarity of the row's pick and of its k-th best. A near-tied pick
    reads small; an index out of range reads infinite."""
    B = sims.shape[0]
    j = torch.as_tensor(picked).long().to(sims.device).view(-1)
    if j.numel() != B or bool((j < 0).any()) or bool((j >= B).any()):
        return float("inf")
    kth = torch.sort(sims, dim=1, descending=True).values[
        :, min(max(k - 1, 0), B - 1)]
    got = sims.gather(1, j[:, None])[:, 0]
    return float((got - kth).abs().max())


def step_flops(config, batch_size: int) -> float:
    """Model FLOPs of one SHAM step, without recomputation: the online
    forward and backward over 3B rows (the backward twice the forward,
    less the first layer's input gradient, which no one takes) and the
    EMA forward over B rows. The loss terms are left out (under 0.1 %)."""
    model, img = config["model"], config["img_size"]
    arch = model["arch"]
    if model["kind"] == "resnet":
        f = resnet.forward_flops(arch, img)
        d = resnet.num_features(arch)
    else:
        f = vit.forward_flops(arch, img)
        d = arch["width"]
    hidden, out = model["proj"]
    head = 2.0 * (d * hidden + hidden * out)
    fwd = f["total"] + head
    bwd = 2.0 * fwd - f["first"]
    return 3 * batch_size * (fwd + bwd) + batch_size * fwd


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Sequence[str]) -> List[float]:
    """Each kept leaf's gap between the program's norm and the reference's,
    against the larger of the reference's norm of that leaf and the median
    leaf's."""
    vals = sorted(ref[n] for n in keep)
    med = vals[len(vals) // 2] if vals else 0.0
    return sorted(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
                  for n in keep)


def kept_leaves(grads: Dict[str, float]) -> List[str]:
    """The leaves the leaf numbers compare: a reference gradient of at
    least a thousandth of the median leaf's, the median taken over the
    leaves that have one (the zero-initialised last BN scale of a ResNet
    block keeps every other leaf of its branch at nought in the first
    step)."""
    some = sorted(g for g in grads.values() if g > 0)
    med = some[len(some) // 2] if some else 0.0
    return [n for n, g in grads.items() if g > 0 and g >= 1e-3 * med]


def worst_leaves(prog, ref, n: int = 5) -> Dict[str, list]:
    """The leaves that set the leaf numbers of the ``start`` and ``mined``
    steps: a look at where a gap lies, printed beside the readings by
    ``control.py``."""
    out = {}
    for part in ("start", "mined"):
        p, r = prog[part], ref[part]
        keep = kept_leaves(r["grad"])
        for key in ("grad", "delta"):
            m = sorted(r[key][k] for k in keep)[len(keep) // 2]
            gaps = sorted(((abs(p[key][k] - r[key][k])
                            / max(r[key][k], m, 1e-30), k, p[key][k],
                            r[key][k]) for k in keep), reverse=True)
            out[f"{part}.{key}"] = [[name, gap, a, b]
                                    for gap, name, a, b in gaps[:n]]
    return out


def _steps_numbers(prog, ref, pre: str = "") -> Dict[str, float]:
    keep = kept_leaves(ref["grad"])
    losses = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    g = leaf_gaps(prog["grad"], ref["grad"], keep)
    d = leaf_gaps(prog["delta"], ref["delta"], keep)
    return {pre + "loss": max(losses), pre + "loss1": losses[0],
            pre + "grad": g[-1], pre + "grad_med": g[len(g) // 2],
            pre + "delta": d[-1], pre + "delta_med": d[len(d) // 2]}


def compare(prog: Dict[str, object], ref: Dict[str, object],
            k: int) -> Dict[str, float]:
    """The numbers a run can compare. Of the first steps from the seed
    (``start``) and of the ``mined`` steps from the program's state:
    ``loss`` (the worst step's relative gap) and ``loss1`` (the first
    step's), ``grad`` and ``delta`` (the worst leaf's gap), ``grad_med``
    and ``delta_med`` (the median leaf's), the mined ones under the prefix
    ``mined_``; and ``mine``, the gap of the cached negatives of the first
    batch mined (``pick_gap``). A configuration's limits say which of them
    its cells compare. Leaves whose reference gradient is under a
    thousandth of the median leaf's (the ViT's fixed position table, its
    unused mask token, the key's bias under the softmax) are left out of
    the leaf numbers, by that rule and not by name."""
    return {**_steps_numbers(prog["start"], ref["start"]),
            "mine": pick_gap(ref["sims"], prog["picks"], k),
            **_steps_numbers(prog["mined"], ref["mined"], "mined_")}
