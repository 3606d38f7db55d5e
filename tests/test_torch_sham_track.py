"""The 36-step SHAM loss track of the port against the JAX package's
``SHAMRecipe.train_step``: ResNet-18 cut to one block per stage, at 64 px,
where the hair masking of the positives zeroes 32 px patches (at the one-step
tests' 32 px no patch is masked). 4 batches of 8 images an epoch over 9
epochs: 8 warmup steps (derangement negatives), 4 mine steps (the EMA's
k-th neighbours, cached per batch) and 24 mined steps (the cached ones).

Both start from identical weights, EMA teacher and negative cache; every
step gets the same views (SimCLR views of the committed hair crops, made by
the port's aug from a seeded generator) and the draws of JAX's keys
(derangement permutation, rotation, blur, mask ratio and scores). Three
checks:
  * re-synced: each step of the port starts from JAX's state before that
    step (weights, BN statistics, EMA teacher, negative cache: everything
    the loss reads), and its loss and mined indices must equal JAX's at the
    one-step tests' tolerance (rtol 1e-4);
  * the optimizer's track: the port's clipping and AdamW, fed JAX's
    gradients of every step, must follow JAX's weights through all 36
    steps (rtol ``OPT_RTOL``): Adam's moments, bias correction and the
    decay over many steps, which one step does not show;
  * free-running: the port and JAX each run the 36 steps from their own
    state; the two loss tracks are printed side by side and their largest
    relative gap must stay below a stated bound. This bound is loose by
    nature: Adam's first update is lr * sign(g), so every weight whose
    gradient is rounding noise (XLA:CPU's BN statistics alone sit ~1e-4
    from f64 at 64 px, tests/test_torch_sham.py) moves +-lr on the sign of
    that noise, 2e-3 apart after one step; the two runs then draw apart as
    two seeds would. The per-stage mean losses are held closer
    (``STAGE_RTOL``).

One XLA compile per stage. ``python tests/test_torch_sham_track.py`` prints
the track."""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

import hairci.models.resnet as jax_resnet
import hairci_torch.models.resnet as port_resnet
from hairci.ssl.sham import SHAMRecipe as JaxSHAMRecipe
from hairci.train.state import TrainState as JaxTrainState
from hairci_torch.aug.pipelines import (
    positive_masking_transform,
    positive_transform,
    simclr_transform,
)
from hairci_torch.models.convert import sham_state_dict_from_jax
from hairci_torch.ssl.sham import SHAMRecipe

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_resnet import random_variables  # noqa: E402

torch.set_num_threads(1)
IMG_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "HairPretraining", "data", "hair_regions")
B, S, NUM_BATCHES, EPOCHS, WARM = 8, 64, 4, 9, 3
K = 3
STEP_RTOL = 1e-4
OPT_RTOL, OPT_ATOL = 1e-5, 1e-6
# the free-running tracks: the largest relative loss gap of a step (0.237
# measured for this ResNet, whose every layer feeds a BN; the ViT file
# states its own), and of a stage's mean loss
FREE_RTOL = 0.35
STAGE_RTOL = 0.1


def _t(a):
    return torch.from_numpy(np.array(a))


def stages(rec):
    """(epoch, batch_id, stage) of the 36 steps, by the recipe's schedule."""
    return [(e, b, rec.stage_for_epoch(e)) for e in range(EPOCHS)
            for b in range(NUM_BATCHES)]


def hair_views(size, seed=0):
    """Each step's two SimCLR views (anchor, pos1) of its batch of hair
    crops, by the port's aug from a seeded generator."""
    names = sorted(n for n in os.listdir(IMG_DIR) if n.endswith("_hair.png"))
    raw = int(size * 256 / 224)
    images = np.stack([np.asarray(Image.open(os.path.join(IMG_DIR, n))
                                  .convert("RGB").resize((raw, raw),
                                                         Image.BILINEAR))
                       for n in names[:NUM_BATCHES * B]])
    tf = simclr_transform(size)
    gen = torch.Generator().manual_seed(seed)
    views = []
    for step in range(EPOCHS * NUM_BATCHES):
        batch = torch.from_numpy(images[(step % NUM_BATCHES) * B:][:B])
        views.append([v.numpy() for v in tf(gen, batch)])
    return views


def jax_draws(key, size):
    """The step's draws from JAX's key, as the port's draw dict (the split
    of ``hairci.ssl.sham.SHAMRecipe.train_step``)."""
    _, k_neg, k_pt, k_mask = jax.random.split(key, 4)
    k1, k2 = jax.random.split(k_pt)
    k_ratio, k_score = jax.random.split(k_mask)
    patches = (size // 32) ** 2
    return {
        "perm": _t(jax.random.permutation(k_neg, B)).long(),
        "positive": {
            "theta": _t(jax.random.uniform(k1, (B,), minval=-15.0,
                                           maxval=15.0) * (np.pi / 180)),
            "sigma": _t(jax.random.uniform(
                jax.random.split(k2)[1], (B,), minval=0.1, maxval=0.5))},
        "mask": {"ratio": _t(jax.random.uniform(k_ratio, (B,), minval=0.1,
                                                maxval=0.5)),
                 "scores": _t(jax.random.uniform(k_score, (B, patches)))},
    }


def masked_patches(view, draws):
    """Patches the hair masking zeroes in this step's positives."""
    pos = positive_transform(_t(view), draws["positive"])
    masked = positive_masking_transform(pos, draws["mask"])
    zeroed = (masked == 0) & (pos != 0)
    Bn, H, W, C = zeroed.shape
    per_patch = zeroed.reshape(Bn, H // 32, 32, W // 32, 32, C).all(
        dim=(2, 4, 5))
    return int(per_patch.sum())


def load_jax_state(state, jstate, model):
    """The port's state set to JAX's: online and EMA weights and BN
    statistics, and the negative cache."""
    state.online.load_state_dict(sham_state_dict_from_jax(
        jstate.params, jstate.batch_stats, model), strict=True)
    state.ema.load_state_dict(sham_state_dict_from_jax(
        jstate.ema_params, jstate.ema_batch_stats, model), strict=True)
    state.neg_indices.copy_(_t(jstate.neg_indices).long())


def _clipped(grads):
    return optax.clip_by_global_norm(1.0).update(grads,
                                                 optax.EmptyState())[0]


def run_track(jrec, rec, model, start, views, size):
    """The 36 steps, re-synced, on JAX's gradients and free-running.
    Returns (rows of (step, stage, JAX loss, re-synced port loss,
    free-running port loss, masked patches), the optimizer track's largest
    parameter error over the steps, relative to the parameter's scale)."""
    params, stats, ema_params, ema_stats = start
    neg = np.stack([np.roll(np.arange(B), i + 1)
                    for i in range(NUM_BATCHES)])
    jstate = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=jrec.tx.init(params), tx=jrec.tx, ema_params=ema_params,
        ema_batch_stats=ema_stats, neg_indices=jnp.asarray(neg, jnp.int32))
    # the step's two views reach the jitted step as its batch, side by side
    # in the channel axis (a view captured by the transform would be frozen
    # into the compiled step)
    jrec.transform = lambda key, images: [images[..., :3], images[..., 3:]]
    step_fn = jax.jit(jrec.train_step, static_argnames="stage")
    synced = rec.create_state(0, B, torch.device("cpu"))
    free = rec.create_state(0, B, torch.device("cpu"))
    opt = rec.create_state(0, B, torch.device("cpu"))
    load_jax_state(free, jstate, model)
    load_jax_state(opt, jstate, model)
    rows, opt_err = [], 0.0
    for step, (_, batch_id, stage) in enumerate(stages(rec)):
        key = jax.random.fold_in(jax.random.key(123), step)
        draws = jax_draws(key, size)
        a, p = (_t(v) for v in views[step])
        load_jax_state(synced, jstate, model)
        m_sync = rec.step_on_views(synced, a, p, draws, stage, batch_id, K)
        jstate, aux = step_fn(
            jstate, {"image": jnp.concatenate(views[step], axis=-1)}, key,
            stage=stage, batch_id=batch_id, k=K)
        m_free = rec.step_on_views(free, a, p, draws, stage, batch_id, K)
        # the optimizer alone on JAX's clipped gradients of this step
        g = sham_state_dict_from_jax(jax.device_get(_clipped(jstate.extra)),
                                     jstate.batch_stats, model)
        jstate = jstate.replace(extra=None)
        for name, param in opt.online.named_parameters():
            param.grad = g[name].clone()
        opt.optimizer.step()
        want = sham_state_dict_from_jax(jstate.params, jstate.batch_stats,
                                        model)
        for name, param in opt.online.named_parameters():
            err = (param.detach() - want[name]).abs() - OPT_RTOL * \
                want[name].abs()
            opt_err = max(opt_err, float(err.max()))
        if stage == "mine":
            assert torch.equal(synced.neg_indices[batch_id],
                               _t(jstate.neg_indices[batch_id]).long()), step
        rows.append((step, stage, float(aux["loss"]),
                     float(m_sync["loss"]), float(m_free["loss"]),
                     masked_patches(views[step][1], draws)))
    return rows, opt_err


def check_track(track, title, free_rtol=FREE_RTOL):
    rows, opt_err = track
    print(f"\n{title}\nstep stage   jax        re-synced  free-run   "
          "free gap  masked")
    for step, stage, lj, ls, lf, nm in rows:
        print(f"{step:4d} {stage:7s} {lj:.7f}  {ls:.7f}  {lf:.7f}  "
              f"{abs(lf - lj) / abs(lj):.2e}  {nm}")
    assert [r[1] for r in rows] == ["warmup"] * 8 + ["mine"] * 4 + \
        ["mined"] * 24
    assert sum(r[5] for r in rows) > 0, "no hair patch was masked"
    np.testing.assert_allclose([r[3] for r in rows], [r[2] for r in rows],
                               rtol=STEP_RTOL, err_msg="re-synced")
    print(f"largest re-synced gap "
          f"{max(abs(ls - lj) / abs(lj) for _, _, lj, ls, _, _ in rows):.3e}"
          f" (bound {STEP_RTOL:g})")
    print(f"optimizer on JAX's gradients: largest |error| beyond "
          f"{OPT_RTOL:g} x |weight| over 36 steps {opt_err:.3g} (bound "
          f"{OPT_ATOL:g})")
    assert opt_err <= OPT_ATOL
    gap = max(abs(lf - lj) / abs(lj) for _, _, lj, _, lf, _ in rows)
    print(f"largest free-running gap {gap:.3e} (bound {free_rtol:g})")
    assert gap < free_rtol
    for stage in ("warmup", "mine", "mined"):
        lj, lf = (np.mean([r[i] for r in rows if r[1] == stage])
                  for i in (2, 4))
        print(f"{stage} mean loss: JAX {lj:.6f}, free-running port "
              f"{lf:.6f} ({abs(lf - lj) / lj:.2%} apart; bound "
              f"{STAGE_RTOL:.0%})")
        assert abs(lf - lj) / lj < STAGE_RTOL, stage
    return gap


def capture_grads(mp):
    """JAX's ``apply_gradients`` keeps the raw gradients in ``extra``."""
    orig = JaxTrainState.apply_gradients
    mp.setattr(JaxTrainState, "apply_gradients",
               lambda self, grads, **kw: orig(self, grads, **kw).replace(
                   extra=grads))


def _shallow(mp):
    mp.setitem(jax_resnet._STAGES, "resnet18",
               ([1, 1, 1, 1], jax_resnet.BasicBlock))
    mp.setitem(port_resnet._STAGES, "resnet18",
               ([1, 1, 1, 1], port_resnet.BasicBlock))


def resnet_track():
    with pytest.MonkeyPatch.context() as mp:
        _shallow(mp)
        capture_grads(mp)
        kw = dict(backbone="resnet18", img_size=S, weight_decay=1e-4,
                  num_batches=NUM_BATCHES, warm_up_epochs=WARM)
        jrec = JaxSHAMRecipe(**kw)
        rec = SHAMRecipe(**kw)
        views = hair_views(S)
        rng = np.random.default_rng(0)
        start = (*random_variables(jrec.module, views[0][0], rng,
                                   train=True),
                 *random_variables(jrec.module, views[0][0], rng,
                                   train=True))
        return run_track(jrec, rec, "resnet18", start, views, S)


def test_sham_resnet18_loss_track_matches_jax():
    check_track(resnet_track(), "SHAM ResNet-18 (1 block a stage), 64 px, "
                "B=8: 36 steps")


if __name__ == "__main__":
    check_track(resnet_track(), "SHAM ResNet-18 (1 block a stage), 64 px, "
                "B=8: 36 steps")
