"""One SHAM step of the port on a ViT backbone with S2R2, in each stage
(warmup, mine, mined), against the JAX package's ``SHAMRecipe.train_step``
from identical weights, views and draws: the loss and its terms, the mined
indices, the clipped gradients, the parameters after AdamW (the fixed
position table, the unused mask token and the cls token included), the new
BN running stats and the EMA teacher. Then the port's remat modes against
``remat=False``: the same gradients and the same BN statistics calls.

Both packages' ``vit_base_patch16`` is cut to patch 8, width 64, depth 2,
2 heads, with the SHAM head (64, 64, 32), at 32 px: each stage is one XLA
compile on the CPU (~22 s). The full ViT-B/16 is held against JAX in
test_torch_vit.py."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import hairci.models.vit as jax_vit
import hairci.ssl.sham as jax_sham
import hairci_torch.models.vit as port_vit
import hairci_torch.ops.bn_stats as port_bn_stats
import hairci_torch.ssl.sham as port_sham
from hairci.ssl.sham import SHAMRecipe as JaxSHAMRecipe
from hairci.train.state import TrainState as JaxTrainState
from hairci_torch.models.convert import sham_state_dict_from_jax
from hairci_torch.ssl.sham import SHAMRecipe

torch.set_num_threads(1)
B, S = 8, 32
STAGES = ("warmup", "mine", "mined")
TINY_VIT = (8, 64, 2, 2)          # patch, width, depth, heads
TINY_HEAD = (64, 64, 32)
# a weight decay large enough that one step's decay (lr * wd = 5e-4 of a
# weight) shows above the tolerance of the parameters without a gradient
RECIPE = dict(backbone="vit_b_16", img_size=S, weight_decay=0.5,
              num_batches=2, warm_up_epochs=2, s2r2_weight=1.0)
# the parameters that take no gradient in either package
NO_GRAD = ("backbone.pos_embed", "backbone.mask_token")


def _t(a):
    return torch.from_numpy(np.array(a))


def _tiny(mp, port_only=False):
    mods = [(port_vit, port_sham)]
    if not port_only:
        mods.append((jax_vit, jax_sham))
    for vit, sham in mods:
        mp.setitem(vit.VIT_CONFIGS, "vit_base_patch16", TINY_VIT)
        mp.setitem(sham._PROJ_DIMS, "vit_b_16", TINY_HEAD)


def _random_variables(module, x, rng):
    """Seeded numpy values in the shapes of ``module.init``: kernels of
    variance 1/fan_in, LayerNorm and BN parameters and BN running stats away
    from their init, tokens and the position table of unit scale."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0),
                                                jnp.asarray(x), train=True))

    def leaf(path, s):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "kernel":
            v = rng.normal(0, np.prod(s.shape[:-1]) ** -0.5, s.shape)
        elif name in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name in ("bias", "mean"):
            v = rng.normal(0, 0.1, s.shape)
        elif name in ("cls_token", "mask_token", "pos_embed"):
            v = rng.normal(0, 0.5, s.shape)
        else:
            raise AssertionError(f"unexpected variable {name}")
        return v.astype(np.float32)

    v = jax.tree_util.tree_map_with_path(leaf, shapes)
    return v["params"], v["batch_stats"]


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's step in each stage from one state, with the clipped gradients
    (the views are seeded arrays handed to both, the draws come from JAX's
    keys; at 32 px no hair patch is masked)."""
    with pytest.MonkeyPatch.context() as mp:
        _tiny(mp)
        orig = JaxTrainState.apply_gradients
        mp.setattr(JaxTrainState, "apply_gradients",
                   lambda self, grads, **kw: orig(self, grads, **kw).replace(
                       extra=grads))
        rng = np.random.default_rng(0)
        views = [rng.normal(size=(B, S, S, 3)).astype(np.float32)
                 for _ in range(2)]
        jrec = JaxSHAMRecipe(**RECIPE)
        jrec.transform = lambda key, images: [jnp.asarray(v) for v in views]
        params, stats = _random_variables(jrec.module, views[0], rng)
        ema_params, ema_stats = _random_variables(jrec.module, views[0], rng)
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


def _port_state(setup, monkeypatch, **kw):
    _tiny(monkeypatch, port_only=True)
    params, stats, ema_params, ema_stats = setup["start"]
    rec = SHAMRecipe(**{**RECIPE, **kw})
    state = rec.create_state(0, B, torch.device("cpu"))
    state.online.load_state_dict(
        sham_state_dict_from_jax(params, stats, "vit_b_16"), strict=True)
    state.ema.load_state_dict(
        sham_state_dict_from_jax(ema_params, ema_stats, "vit_b_16"),
        strict=True)
    state.neg_indices.copy_(_t(setup["neg"]))
    return rec, state


def _step(setup, rec, state, stage):
    views = [_t(v) for v in setup["views"]]
    return rec.step_on_views(state, views[0], views[1], setup["draws"],
                             stage, batch_id=1, k=3)


def _close(name, got, want, rtol, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol, err_msg=name)


@pytest.mark.parametrize("stage", STAGES)
def test_sham_vit_step_matches_jax(jax_steps, stage, monkeypatch):
    new, aux, grads = jax_steps["out"][stage]
    rec, state = _port_state(jax_steps, monkeypatch)
    metrics = _step(jax_steps, rec, state, stage)

    for k, v in metrics.items():
        if k == "margin_violations":
            assert int(v) == int(aux[k])
        else:
            _close(k, v, aux[k], 1e-4, 1e-7)
    assert torch.equal(state.neg_indices, _t(new.neg_indices).long())
    stats = jax_steps["start"][1]
    g = sham_state_dict_from_jax(grads, stats, "vit_b_16")
    for name, p in state.online.named_parameters():
        _close(f"grad {name}", p.grad, g[name], 1e-4, 1e-6)
    for name in NO_GRAD:
        assert not state.online.get_parameter(name).grad.any(), name
    after = sham_state_dict_from_jax(new.params, new.batch_stats, "vit_b_16")
    # after the port's own AdamW step: the tokens and the position table,
    # and every BN running stat. Adam's first step moves a weight by about
    # lr whatever the size of its gradient, so where the true gradient is 0
    # (the key part of qkv.bias, which softmax ignores; the final norm's
    # bias, which the head's BN cancels) both packages move by +-lr on
    # rounding noise: the other weights are held below, through the
    # optimizer on JAX's gradients.
    start = sham_state_dict_from_jax(*jax_steps["start"][:2], "vit_b_16")
    for name in NO_GRAD + ("backbone.cls_token",):
        assert not np.allclose(after[name], start[name], rtol=1e-4), name
        _close(name, state.online.get_parameter(name), after[name], 1e-4,
               1e-6)
    for name, t in state.online.state_dict().items():
        if "running" in name:
            _close(name, t, after[name], 1e-4, 1e-6)
    ema = sham_state_dict_from_jax(new.ema_params, new.ema_batch_stats,
                                   "vit_b_16")
    for name, t in state.ema.state_dict().items():
        _close(f"ema {name}", t, ema[name], 1e-4, 1e-7)
    assert state.step == 1

    # the optimizer alone, on JAX's clipped gradients
    _, state = _port_state(jax_steps, monkeypatch)
    for name, p in state.online.named_parameters():
        p.grad = g[name].clone()
    state.optimizer.step()
    for name, p in state.online.named_parameters():
        _close(f"param {name}", p, after[name], 1e-6, 1e-6)


@pytest.mark.parametrize("remat", [True, "full", "selective", "half"])
def test_remat_keeps_gradients_and_bn_calls(jax_steps, remat, monkeypatch):
    calls = []
    twin = port_bn_stats.bn_stats_reference

    def counted(x):
        calls.append(tuple(x.shape))
        return twin(x)

    monkeypatch.setattr(port_bn_stats, "bn_stats_reference", counted)
    results = []
    for mode in (False, remat):
        calls.clear()
        rec, state = _port_state(jax_steps, monkeypatch, remat=mode)
        assert state.online.backbone.remat == mode
        m = _step(jax_steps, rec, state, "mine")
        results.append((m, dict(state.online.named_parameters()),
                        state.online.state_dict(), list(calls)))
    (m0, p0, sd0, calls0), (m1, p1, sd1, calls1) = results
    # the two train-mode BNs of the head, once each: remat never reruns them
    assert calls1 == calls0 == [(3 * B, 64), (3 * B, 32)]
    torch.testing.assert_close(m1["loss"], m0["loss"], rtol=0, atol=0)
    for name, p in p0.items():
        torch.testing.assert_close(p1[name].grad, p.grad, rtol=1e-6,
                                   atol=1e-9, msg=name)
    for name in sd0:
        if "running" in name:
            torch.testing.assert_close(sd1[name], sd0[name], rtol=0, atol=0)


def test_remat_mode_is_checked():
    with pytest.raises(ValueError, match="remat must be one of"):
        port_vit.VisionTransformer(patch_size=8, embed_dim=16, depth=1,
                                   num_heads=2, img_size=16, remat="every")


def test_s2r2_gets_f32_embeddings_in_bf16(monkeypatch):
    """In a bf16 run both packages' SHAM head hands f32 rows to
    l2_normalize and S2R2, whose 1 / tau = 100 would scale bf16 rounding."""
    _tiny(monkeypatch)
    x = np.zeros((2, S, S, 3), np.float32)
    jmod = jax_sham.SHAMModule(backbone_name="vit_b_16", img_size=S,
                               dtype=jnp.bfloat16)
    out, _ = jax.eval_shape(lambda: jmod.init_with_output(
        jax.random.key(0), jnp.asarray(x), train=True))
    module = port_sham.SHAMModule("vit_b_16", torch.bfloat16, img_size=S)
    assert module.backbone.blocks[0].attn.qkv.weight.dtype == torch.float32
    got = module(torch.from_numpy(x))
    assert out.dtype == jnp.float32 and got.dtype == torch.float32
    assert tuple(got.shape) == tuple(out.shape) == (2, TINY_HEAD[-1])
