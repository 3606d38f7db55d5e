"""The port's SupCon (``hairci_torch/ssl/supcon.py``) against the JAX
package's: ``supcon_loss`` in both contrast modes, with labels and without,
and with a class of one sample; SupCon's two views on JAX's draws; one f32
step from identical weights and views (the loss, the gradients, the weights
after Adam, the BN running stats); and a reference ``SupConResNet`` ``.pth``
through both packages' converters.

Both packages' "resnet18" is cut to one block per stage: the step is one
XLA compile on the CPU. The step against JAX runs at 4 images of 16 px. At
8 images of 32 px (the CIFAR stem keeps layer1 at 32 x 32, 16,384 BN rows)
JAX's layer1 and layer2 gradients on the CPU lie up to 2e-2 (of each
tensor's largest entry) away from an f64 run of the same step while the
port's lie within 5e-6 of it: XLA:CPU's f32 BN sums are less accurate, and
a ReLU input moved across 0 by rounding reroutes the gradient. At 4 x 16 px
JAX is within 1e-5 of the f64 run. So the 32 px step is held against the
port's own f64 run. Gradients and weights are compared at rtol 1e-4 with an
atol of 1e-4 of the tensor's largest entry (at least 1e-7)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hairci.models.resnet as jax_resnet
import hairci_torch.models.norm as norm
import hairci_torch.models.resnet as port_resnet
from hairci.aug import pipelines as jpipe
from hairci.losses.contrastive import supcon_loss as j_supcon
from hairci.retrieval import torch_import as ti
from hairci.ssl.supcon import CIFAR_MEAN, CIFAR_STD
from hairci.ssl.supcon import SupConModule as JaxSupConModule
from hairci.ssl.supcon import SupConRecipe as JaxSupConRecipe
from hairci.train.state import TrainState as JaxTrainState
from hairci_torch.aug import pipelines as pipe
from hairci_torch.cli.knn_classification import _reference_state_dict
from hairci_torch.losses.contrastive import supcon_loss
from hairci_torch.models.convert import supcon_state_dict_from_jax
from hairci_torch.ssl.supcon import SupConModule, SupConRecipe
from test_torch_aug import _cj_draws, _flags
from test_torch_resnet import random_variables

torch.set_num_threads(1)
B, S = 8, 32
# a class of one sample (3) and a class of three (0)
LABELS = np.array([0, 1, 0, 2, 1, 0, 3, 2])
RECIPE = dict(backbone="resnet18", img_size=S, weight_decay=1e-4)
# the step against JAX (see the module docstring); labels with a class of
# one sample (2) and a class of two (0)
STEP_B, STEP_S = 4, 16
STEP_LABELS = np.array([0, 1, 0, 2])


def _t(a):
    return torch.from_numpy(np.array(a))


def _shallow(mp, port_only=False):
    """Both packages' "resnet18" cut to one block per stage."""
    if not port_only:
        mp.setitem(jax_resnet._STAGES, "resnet18",
                   ([1, 1, 1, 1], jax_resnet.BasicBlock))
    mp.setitem(port_resnet._STAGES, "resnet18",
               ([1, 1, 1, 1], port_resnet.BasicBlock))


def _close(name, got, want, rtol, atol=None):
    """``atol`` defaults to ``rtol`` of the largest entry of ``want`` (and
    at least 1e-7: a gradient that is 0 in exact arithmetic is rounding)."""
    want = np.asarray(want)
    if atol is None:
        atol = max(rtol * float(np.abs(want).max(initial=0.0)), 1e-7)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=atol, err_msg=name)


# ---------------------------------------------------------------------------
# the loss and the views
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["all", "one"])
@pytest.mark.parametrize("labels", ["labels", "none", "singleton"])
def test_supcon_loss_matches_jax(mode, labels):
    rng = np.random.default_rng(0)
    f = rng.normal(size=(B, 2, 16)).astype(np.float32)
    f /= np.linalg.norm(f, axis=-1, keepdims=True)
    y = {"labels": LABELS, "none": None,
         # every sample its own class: a row with no positive but its view
         "singleton": np.arange(B)}[labels]
    want = j_supcon(jnp.asarray(f), None if y is None else jnp.asarray(y),
                    0.1, contrast_mode=mode)
    ft = _t(f).requires_grad_(True)
    got = supcon_loss(ft, None if y is None else _t(y), 0.1,
                      contrast_mode=mode)
    _close("loss", got, want, 1e-5, 1e-6)
    # the gradient too, through the detached row maximum
    jgrad = jax.grad(lambda x: j_supcon(
        x, None if y is None else jnp.asarray(y), 0.1,
        contrast_mode=mode))(jnp.asarray(f))
    got.backward()
    _close("grad", ft.grad, jgrad, 1e-5, 1e-6)


def test_supcon_loss_rejects_unknown_mode():
    with pytest.raises(ValueError):
        supcon_loss(torch.zeros(2, 2, 4), None, contrast_mode="some")


def test_supcon_views_match_jax():
    key = jax.random.key(4)
    x = np.random.default_rng(4).integers(0, 256, (B, 40, 36, 3), np.uint8)
    transform = jpipe.supcon_train_transform(24, CIFAR_MEAN, CIFAR_STD)
    want = transform(key, jnp.asarray(x))
    draws = []
    for k in jax.random.split(key, 2):
        k1, k2 = jax.random.split(k)
        d = {"flip": _flags(k1, 0.5, B)}
        d.update({f"cj_{n}": v for n, v in _cj_draws(
            k2, B, 0.4, 0.4, 0.4, 0.1, 0.8).items()})
        draws.append(d)
    port = pipe.supcon_train_transform(24, CIFAR_MEAN, CIFAR_STD)
    got = port.apply(_t(x), draws)
    for g, w in zip(got, want):
        assert g.shape == (B, 24, 24, 3)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    # the draw half is seeded and differs between the views
    a = port(torch.Generator().manual_seed(1), _t(x))
    b = port(torch.Generator().manual_seed(1), _t(x))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not torch.equal(a[0], a[1])


# ---------------------------------------------------------------------------
# one step
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_step():
    """JAX's SupCon step from seeded weights on seeded views, with its
    gradients."""
    with pytest.MonkeyPatch.context() as mp:
        _shallow(mp)
        orig = JaxTrainState.apply_gradients
        mp.setattr(JaxTrainState, "apply_gradients",
                   lambda self, grads, **kw: orig(self, grads, **kw).replace(
                       extra=grads))
        rng = np.random.default_rng(0)
        views = [rng.normal(size=(STEP_B, STEP_S, STEP_S, 3)).astype(
            np.float32) for _ in range(2)]
        jrec = JaxSupConRecipe(dtype=jnp.float32,
                               **{**RECIPE, "img_size": STEP_S})
        jrec.transform = lambda key, images: [jnp.asarray(v) for v in views]
        params, stats = random_variables(jrec.module, views[0], rng,
                                         train=True)
        state = JaxTrainState(step=jnp.zeros((), jnp.int32), params=params,
                              batch_stats=stats,
                              opt_state=jrec.tx.init(params), tx=jrec.tx)
        new, aux = jax.device_get(jax.jit(jrec.train_step)(
            state, {"image": jnp.zeros((STEP_B, STEP_S, STEP_S, 3),
                                       jnp.uint8),
                    "label": jnp.asarray(STEP_LABELS, jnp.int32)},
            jax.random.key(7)))
    return dict(new=new, aux=aux, views=views, start=(params, stats))


def _port_state(setup, monkeypatch):
    _shallow(monkeypatch, port_only=True)
    rec = SupConRecipe(**RECIPE)
    state = rec.create_state(0, B, torch.device("cpu"))
    state.online.load_state_dict(
        supcon_state_dict_from_jax(*setup["start"]), strict=True)
    return rec, state


def test_supcon_step_matches_jax(jax_step, monkeypatch):
    new, aux = jax_step["new"], jax_step["aux"]
    rec, state = _port_state(jax_step, monkeypatch)
    assert state.ema is None and state.neg_indices is None
    views = [_t(v) for v in jax_step["views"]]
    metrics = rec.step_on_views(state, *views, _t(STEP_LABELS))
    _close("loss", metrics["loss"], aux["loss"], 1e-4, 1e-7)

    stats = jax_step["start"][1]
    g = supcon_state_dict_from_jax(new.extra, stats)
    for name, p in state.online.named_parameters():
        _close(f"grad {name}", p.grad, g[name], 1e-4)
    # after the port's own Adam step: every BN running stat, and every
    # weight whose gradient stands clear of rounding. Adam's first step moves
    # a weight by lr * g / (|g| + eps), about lr whatever the size of g, so
    # where g is at the rounding floor the two steps differ by up to lr: the
    # optimizer is held on its own below, on JAX's gradients.
    after = supcon_state_dict_from_jax(new.params, new.batch_stats)
    for name, t in state.online.state_dict().items():
        if "running" in name:
            _close(name, t, after[name], 1e-4)
        else:
            gn = g[name].numpy()
            clear = np.abs(gn) > max(1e-3 * np.abs(gn).max(), 1e-6)
            _close(name, t[clear], after[name][clear], 1e-4)
    assert state.step == 1

    # the optimizer alone, on JAX's gradients
    _, state = _port_state(jax_step, monkeypatch)
    for name, p in state.online.named_parameters():
        p.grad = g[name].clone()
    state.optimizer.step()
    for name, p in state.online.named_parameters():
        _close(f"param {name}", p, after[name], 1e-6, 1e-6)


def _f64_stats(x):
    return x.sum(0), (x * x).sum(0)


def test_supcon_step_at_32px_matches_f64(jax_step, monkeypatch):
    """8 images of 32 px: the port's f32 step against the same step in f64
    (plain f64 BN sums): the loss, the gradients and the BN running stats
    at rtol 1e-4. (A ReLU input within f32 rounding of 0 reroutes the
    gradient: of the views of seeds 0-3, seeds 1 and 2 have one.)"""
    rng = np.random.default_rng(0)
    views = [_t(rng.normal(size=(B, S, S, 3)).astype(np.float32))
             for _ in range(2)]
    runs = []
    for dtype in (torch.float32, torch.float64):
        rec, state = _port_state(jax_step, monkeypatch)
        if dtype == torch.float64:
            monkeypatch.setattr(norm.BNStats, "apply", _f64_stats)
            state.online.double()
            for mod in state.online.modules():
                if isinstance(getattr(mod, "dtype", None), torch.dtype):
                    mod.dtype = torch.float64
        m = rec.step_on_views(state, *(v.to(dtype) for v in views),
                              _t(LABELS))
        runs.append((m["loss"], dict(state.online.named_parameters()),
                     dict(state.online.named_buffers())))
    (loss, params, bufs), (loss64, params64, bufs64) = runs
    _close("loss", loss, loss64.numpy(), 1e-4, 1e-7)
    for name, p in params.items():
        _close(f"grad {name}", p.grad, params64[name].grad.numpy(), 1e-4)
    for name, t in bufs.items():
        _close(name, t, bufs64[name].numpy(), 1e-4)


def test_supcon_features_are_the_encoders(jax_step, monkeypatch):
    """``extract_features`` is the encoder alone on the kNN view, in eval
    mode; the training forward gives unit rows of the head's width."""
    rec, state = _port_state(jax_step, monkeypatch)
    images = _t(np.random.default_rng(2).integers(0, 256, (4, S, S, 3),
                                                  np.uint8))
    feats = rec.extract_features(state, images)
    assert feats.shape == (4, 512) and state.online.training
    z = state.online(_t(jax_step["views"][0]))
    assert z.shape == (STEP_B, 128)
    _close("norm", torch.linalg.vector_norm(z, dim=1), np.ones(STEP_B), 0,
           1e-6)


@pytest.mark.parametrize("head", ["mlp", "linear"])
def test_supcon_module_forward_matches_jax(head, monkeypatch):
    """Both heads of ``SupConModule`` (biased Dense layers, the output cast
    to f32 and L2-normalised) on the cut encoder in eval mode, from the JAX
    module's weights; and the encoder's features."""
    _shallow(monkeypatch)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, STEP_S, STEP_S, 3)).astype(np.float32)
    jmod = JaxSupConModule(backbone_name="resnet18", head=head)
    params, stats = random_variables(jmod, x, rng, train=True)
    variables = {"params": params, "batch_stats": stats}
    want = jax.jit(lambda v, a: jmod.apply(v, a, train=False))(
        variables, jnp.asarray(x))
    want_f = jax.jit(lambda v, a: jmod.apply(
        v, a, train=False, method=jmod.extract_features))(
        variables, jnp.asarray(x))
    module = SupConModule("resnet18", head=head).eval()
    module.load_state_dict(supcon_state_dict_from_jax(params, stats),
                           strict=True)
    with torch.no_grad():
        got, got_f = module(_t(x)), module.extract_features(_t(x))
    assert got.shape == (4, 128) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-5)


# ---------------------------------------------------------------------------
# a reference .pth
# ---------------------------------------------------------------------------

def test_reference_pth_loads_as_jax_reads_it(tmp_path):
    """A state dict in the reference ``SupConResNet``'s key layout (built
    here from a seeded full ResNet-18 SupCon model: ``shortcut`` for
    ``downsample``, BN counters, the mlp head as ``head.0``/``head.2``)
    goes through the eval CLI's ``.pth`` route into the port, and through
    ``convert_supcon`` into JAX: the two agree on every tensor."""
    state = SupConRecipe(**RECIPE).create_state(3, B, torch.device("cpu"))
    gen = torch.Generator().manual_seed(3)
    ref = {}
    for name, t in state.online.state_dict().items():
        key = name.replace(".downsample.", ".shortcut.")
        ref[key] = t + torch.rand(t.shape, generator=gen)  # away from init
        if name.endswith("running_var"):
            ref[key.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(3)
    assert "encoder.layer2.0.shortcut.0.weight" in ref
    assert {"head.0.weight", "head.0.bias", "head.2.weight",
            "head.2.bias"} <= set(ref)
    path = str(tmp_path / "supcon.pth")
    torch.save({"model": ref, "epoch": 3}, path)

    args = type("Args", (), {"mode": "simclr_supcon", "model": "resnet18"})
    sd = _reference_state_dict(args, path, state.online)
    state.online.load_state_dict(sd, strict=True)
    for name, t in state.online.state_dict().items():
        assert torch.equal(
            t, ref[name.replace(".downsample.", ".shortcut.")]), name

    jparams, jstats = ti.convert_supcon(ti.load_torch_state_dict(path),
                                        "resnet18")
    via_jax = supcon_state_dict_from_jax(jparams, jstats)
    assert set(via_jax) == set(sd)
    for name, t in sd.items():
        np.testing.assert_array_equal(via_jax[name].numpy(), t.numpy(),
                                      err_msg=name)
