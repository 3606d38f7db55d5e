"""One SHAM step of the port in each stage (warmup, mine, mined) against
the JAX package's ``SHAMRecipe.train_step``, from identical weights, views
and draws: loss and aux metrics, mined indices, clipped gradients, new BN
running stats, the EMA teacher, and the optimizer on JAX's gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import hairci.models.resnet as jax_resnet
import hairci_torch.models.resnet as port_resnet
from hairci.ssl.sham import SHAMRecipe as JaxSHAMRecipe
from hairci.train.state import TrainState as JaxTrainState
from hairci_torch.models.convert import sham_state_dict_from_jax
from hairci_torch.ssl.sham import SHAMRecipe
from test_torch_resnet import random_variables

torch.set_num_threads(1)
# batch and view size of the step tests. XLA:CPU sums a BN's f32 statistics
# far less accurately than torch (up to ~1e-4 apart at 64 px, ~1e-9 from an
# f64 run on the torch side), and one ReLU input pushed across 0 reroutes
# the gradient: at 32 px the reductions are short enough that none is.
B, S = 8, 32
STAGES = ("warmup", "mine", "mined")


def _t(a):
    return torch.from_numpy(np.array(a))


def _shallow(mp, port_only=False):
    """Both packages' "resnet18" cut to one block per stage: each stage of
    the step is one XLA compile on the CPU, and the full ResNet-18 is held
    against JAX in test_torch_resnet.py."""
    if not port_only:
        mp.setitem(jax_resnet._STAGES, "resnet18",
                   ([1, 1, 1, 1], jax_resnet.BasicBlock))
    mp.setitem(port_resnet._STAGES, "resnet18",
               ([1, 1, 1, 1], port_resnet.BasicBlock))


# ---------------------------------------------------------------------------
# one step per stage
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_steps():
    """JAX's step in each stage from one state, with the clipped gradients.

    The views are seeded arrays handed to both, so the step is compared
    apart from the SimCLR aug (held in test_torch_aug.py); everything drawn
    inside the step comes from JAX's keys. At 32 px a view is one 32 px
    patch, so no patch is masked here (the masking is held bitwise in
    test_torch_aug.py)."""
    with pytest.MonkeyPatch.context() as mp:
        _shallow(mp)
        orig = JaxTrainState.apply_gradients
        mp.setattr(JaxTrainState, "apply_gradients",
                   lambda self, grads, **kw: orig(self, grads, **kw).replace(
                       extra=grads))

        rng = np.random.default_rng(0)
        views = [rng.normal(size=(B, S, S, 3)).astype(np.float32)
                 for _ in range(2)]
        jrec = JaxSHAMRecipe(backbone="resnet18", img_size=S,
                             weight_decay=1e-4, num_batches=2,
                             warm_up_epochs=2)
        jrec.transform = lambda key, images: [jnp.asarray(v) for v in views]
        params, stats = random_variables(jrec.module, views[0], rng,
                                         train=True)
        ema_params, ema_stats = random_variables(jrec.module, views[0], rng,
                                                 train=True)
        neg = np.stack([np.roll(np.arange(B), 1), np.roll(np.arange(B), 3)])
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=jrec.tx.init(params), tx=jrec.tx,
            ema_params=ema_params, ema_batch_stats=ema_stats,
            neg_indices=jnp.asarray(neg, jnp.int32))
        key = jax.random.key(7)
        step = jax.jit(jrec.train_step, static_argnames="stage")
        out = {}
        for stage in STAGES:
            new, aux = jax.device_get(step(
                state, {"image": jnp.zeros((B, S, S, 3), jnp.uint8)}, key,
                stage=stage, batch_id=1, k=3))
            clipped, _ = optax.clip_by_global_norm(1.0).update(
                new.extra, optax.EmptyState())
            out[stage] = (new, aux, jax.device_get(clipped))

        # the draws of the step, from JAX's keys, for the port
        _, k_neg, k_pt, k_mask = jax.random.split(key, 4)
        k1, k2 = jax.random.split(k_pt)
        k_ratio, k_score = jax.random.split(k_mask)
        draws = {
            "perm": _t(jax.random.permutation(k_neg, B)).long(),
            "positive": {
                "theta": _t(jax.random.uniform(k1, (B,), minval=-15.0,
                                               maxval=15.0) * (np.pi / 180)),
                "sigma": _t(jax.random.uniform(
                    jax.random.split(k2)[1], (B,), minval=0.1, maxval=0.5))},
            "mask": {"ratio": _t(jax.random.uniform(k_ratio, (B,),
                                                    minval=0.1, maxval=0.5)),
                     "scores": _t(jax.random.uniform(k_score, (B, 1)))},
        }
    return dict(out=out, views=views, draws=draws, neg=neg,
                start=(params, stats, ema_params, ema_stats))


def _port_state(setup, monkeypatch):
    _shallow(monkeypatch, port_only=True)
    params, stats, ema_params, ema_stats = setup["start"]
    rec = SHAMRecipe(backbone="resnet18", img_size=S, weight_decay=1e-4,
                     num_batches=2, warm_up_epochs=2)
    state = rec.create_state(0, B, torch.device("cpu"))
    state.online.load_state_dict(sham_state_dict_from_jax(params, stats),
                                 strict=True)
    state.ema.load_state_dict(sham_state_dict_from_jax(ema_params, ema_stats),
                              strict=True)
    state.neg_indices.copy_(_t(setup["neg"]))
    return rec, state


def _close(name, got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("stage", STAGES)
def test_sham_step_matches_jax(jax_steps, stage, monkeypatch):
    new, aux, grads = jax_steps["out"][stage]
    rec, state = _port_state(jax_steps, monkeypatch)
    views = [_t(v) for v in jax_steps["views"]]
    metrics = rec.step_on_views(state, views[0], views[1],
                                jax_steps["draws"], stage, batch_id=1, k=3)

    for k, v in metrics.items():
        if k == "margin_violations":
            assert int(v) == int(aux[k])
        else:
            _close(k, v, aux[k], 1e-4, 1e-7)
    assert torch.equal(state.neg_indices, _t(new.neg_indices).long())
    _, stats = jax_steps["start"][:2]
    g = sham_state_dict_from_jax(grads, stats)
    for name, p in state.online.named_parameters():
        _close(f"grad {name}", p.grad, g[name], 1e-3, 1e-6)
    bn = sham_state_dict_from_jax(new.params, new.batch_stats)
    ema = sham_state_dict_from_jax(new.ema_params, new.ema_batch_stats)
    for name, t in state.online.state_dict().items():
        if "running" in name:
            _close(name, t, bn[name], 1e-5, 1e-5)
    for name, t in state.ema.state_dict().items():
        _close(f"ema {name}", t, ema[name], 1e-6, 1e-6)
    assert state.step == 1

    # the optimizer alone, on JAX's clipped gradients
    _, state = _port_state(jax_steps, monkeypatch)
    for name, p in state.online.named_parameters():
        p.grad = g[name].clone()
    state.optimizer.step()
    for name, p in state.online.named_parameters():
        _close(f"param {name}", p, bn[name], 1e-6, 1e-6)


def test_ablations_compose_the_loss(jax_steps, monkeypatch):
    views = [_t(v) for v in jax_steps["views"]]
    for ablation, check in (
            ("No_MSE", lambda m: m["contrastive_loss"]
             + 0.5 * m["triplet_loss"]),
            ("No_Triplet", lambda m: m["contrastive_loss"]
             + 0.2 * m["mse_loss"]),
            ("No_pos_transform", None), ("No masked positive", None)):
        rec, state = _port_state(jax_steps, monkeypatch)
        rec.ablation = ablation
        m = rec.step_on_views(state, views[0], views[1], jax_steps["draws"])
        assert torch.isfinite(m["loss"])
        if check is not None:
            torch.testing.assert_close(m["loss"], check(m))
    assert SHAMRecipe(ablation="fixed_margin_0_5").margin_stage1 == 0.5
