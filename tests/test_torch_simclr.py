"""The port's SimCLR (``hairci_torch/ssl/simclr.py``) against the JAX
package's ``SimCLRRecipe``: one f32 step from identical weights and views
on a ResNet-18, the same with the S2R2 term (``--mode S2R2``), and on a
ViT-B/16 -- the loss, the gradients, the weights after Adam, the BN running
stats -- and ``extract_features``.

Both packages' "resnet18" is cut to one block per stage and ViT-B/16 to
patch 8, width 64, depth 2, 2 heads, with the SimCLR head (64, 32), at 32
px and 8 images: each step is one XLA compile on the CPU. Gradients and
weights are compared at rtol 1e-4 with an atol of 1e-4 of the tensor's
largest entry (at least 1e-7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hairci.models.resnet as jax_resnet
import hairci.models.vit as jax_vit
import hairci.ssl.simclr as jax_simclr
import hairci_torch.models.heads as port_heads
import hairci_torch.models.resnet as port_resnet
import hairci_torch.models.vit as port_vit
from hairci.train.state import TrainState as JaxTrainState
from hairci_torch.models.convert import simclr_state_dict_from_jax
from hairci_torch.ssl import build_recipe
from test_torch_resnet import random_variables
from test_torch_sham_vit import _random_variables as vit_random_variables
from test_torch_supcon import _close

torch.set_num_threads(1)
B, S = 8, 32
TINY_VIT = (8, 64, 2, 2)          # patch, width, depth, heads
TINY_HEAD = (64, 32)
# case -> (the JAX backbone name, the port's, s2r2_weight)
CASES = {"resnet18": ("resnet18", "resnet18", 0.0),
         "resnet18_s2r2": ("resnet18", "resnet18", 1.0),
         "vit_b_16": ("vit_base_patch16", "vit_b_16", 0.0)}
# the parameters that take no gradient in either package
NO_GRAD = ("backbone.pos_embed", "backbone.mask_token")


def _t(a):
    return torch.from_numpy(np.array(a))


def _cut(mp, port_only=False):
    """Both packages' ResNet-18 to one block per stage, their ViT-B/16 to
    the tiny ViT with the tiny SimCLR head."""
    mp.setitem(port_resnet._STAGES, "resnet18",
               ([1, 1, 1, 1], port_resnet.BasicBlock))
    mp.setitem(port_vit.VIT_CONFIGS, "vit_base_patch16", TINY_VIT)
    mp.setitem(port_heads.SIMCLR_PROJ_DIMS, "vit_b_16", TINY_HEAD)
    if not port_only:
        mp.setitem(jax_resnet._STAGES, "resnet18",
                   ([1, 1, 1, 1], jax_resnet.BasicBlock))
        mp.setitem(jax_vit.VIT_CONFIGS, "vit_base_patch16", TINY_VIT)
        mp.setitem(jax_simclr._PROJ_DIMS, "vit_base_patch16", TINY_HEAD)


_STEPS = {}


def _jax_step(case):
    """JAX's SimCLR step from seeded weights on seeded views, with its
    gradients and the features of a uint8 batch (one compile a case)."""
    if case in _STEPS:
        return _STEPS[case]
    jax_name, _, s2r2 = CASES[case]
    with pytest.MonkeyPatch.context() as mp:
        _cut(mp)
        orig = JaxTrainState.apply_gradients
        mp.setattr(JaxTrainState, "apply_gradients",
                   lambda self, grads, **kw: orig(self, grads, **kw).replace(
                       extra=grads))
        rng = np.random.default_rng(0)
        views = [rng.normal(size=(B, S, S, 3)).astype(np.float32)
                 for _ in range(2)]
        jrec = jax_simclr.SimCLRRecipe(
            backbone=jax_name, img_size=S, weight_decay=1e-4,
            dtype=jnp.float32, s2r2_weight=s2r2)
        jrec.transform = lambda key, images: [jnp.asarray(v) for v in views]
        if jax_name.startswith("vit"):
            params, stats = vit_random_variables(jrec.module, views[0], rng)
        else:
            params, stats = random_variables(jrec.module, views[0], rng,
                                             train=True)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=stats,
                              opt_state=jrec.tx.init(params), tx=jrec.tx)
        new, aux = jax.device_get(jax.jit(jrec.train_step)(
            state, {"image": jnp.zeros((B, S, S, 3), jnp.uint8)},
            jax.random.key(7)))
        images = rng.integers(0, 256, (4, S + 8, S + 8, 3), np.uint8)
        feats = None
        if case != "resnet18_s2r2":
            feats = np.asarray(jax.jit(jrec.extract_features)(
                state, jnp.asarray(images)))
    _STEPS[case] = dict(new=new, aux=aux, views=views, images=images,
                        feats=feats, start=(params, stats))
    return _STEPS[case]


def _port_state(case, setup, monkeypatch):
    _, name, s2r2 = CASES[case]
    _cut(monkeypatch, port_only=True)
    rec = build_recipe("simclr", backbone=name, img_size=S, weight_decay=1e-4,
                       s2r2_weight=s2r2)
    state = rec.create_state(0, B, torch.device("cpu"))
    state.online.load_state_dict(
        simclr_state_dict_from_jax(*setup["start"], name), strict=True)
    return rec, state


@pytest.mark.parametrize("case", list(CASES))
def test_simclr_step_matches_jax(case, monkeypatch):
    setup = _jax_step(case)
    new, aux = setup["new"], setup["aux"]
    _, name, _ = CASES[case]
    rec, state = _port_state(case, setup, monkeypatch)
    assert state.ema is None and state.neg_indices is None
    metrics = rec.step_on_views(state, *(_t(v) for v in setup["views"]))
    _close("loss", metrics["loss"], aux["loss"], 1e-4, 1e-7)

    stats = setup["start"][1]
    g = simclr_state_dict_from_jax(new.extra, stats, name)
    for pname, p in state.online.named_parameters():
        if pname in NO_GRAD:
            assert not p.grad.any(), pname
        else:
            _close(f"grad {pname}", p.grad, g[pname], 1e-4)
    # after the port's own Adam step: every BN running stat, and every
    # weight whose gradient stands clear of rounding (Adam's first step
    # moves a weight by about lr whatever the size of its gradient: the
    # optimizer is held on its own below, on JAX's gradients)
    after = simclr_state_dict_from_jax(new.params, new.batch_stats, name)
    for pname, t in state.online.state_dict().items():
        if "running" in pname:
            _close(pname, t, after[pname], 1e-4)
        elif pname not in NO_GRAD:
            gn = g[pname].numpy()
            clear = np.abs(gn) > max(1e-3 * np.abs(gn).max(), 1e-6)
            _close(pname, t[clear], after[pname][clear], 1e-4)
    assert state.step == 1

    _, state = _port_state(case, setup, monkeypatch)
    for pname, p in state.online.named_parameters():
        p.grad = g[pname].clone()
    state.optimizer.step()
    for pname, p in state.online.named_parameters():
        _close(f"param {pname}", p, after[pname], 1e-6, 1e-6)


@pytest.mark.parametrize("case", ["resnet18", "vit_b_16"])
def test_simclr_features_match_jax(case, monkeypatch):
    """``extract_features``: the center-cropped kNN view, the pooled
    backbone features in eval mode (the running BN stats), the module left
    in train mode."""
    setup = _jax_step(case)
    rec, state = _port_state(case, setup, monkeypatch)
    feats = rec.extract_features(state, _t(setup["images"]))
    assert state.online.training
    assert feats.shape == setup["feats"].shape
    np.testing.assert_allclose(feats.numpy(), setup["feats"], atol=1e-5)


def test_s2r2_mode_and_flag_build_the_term():
    """``--mode S2R2`` and ``--mode simclr --S2R2`` both train SimCLR with
    the Smooth-AP term at weight 1, as the JAX CLI builds them."""
    from hairci.cli.mainpretrain import build_recipe_from_args as jax_build
    from hairci_torch.cli.mainpretrain import build_recipe_from_args
    from hairci_torch.utils.config import parse_pretrain_args

    for argv, weight in ((["--mode", "simclr"], 0.0),
                         (["--mode", "S2R2"], 1.0),
                         (["--mode", "simclr", "--S2R2"], 1.0)):
        args = parse_pretrain_args(argv + ["--model", "resnet50"])
        ours, ref = build_recipe_from_args(args, 4), jax_build(args, 4)
        assert ours.name == ref.name == "simclr"
        assert ours.s2r2_weight == ref.s2r2_weight == weight
        assert ours.temperature == ref.temperature == args.temp
        assert (ours.learning_rate, ours.betas, ours.dtype) == \
            (args.lr, (args.beta1, args.beta2), torch.bfloat16)
