"""SiameseIM in the port (``hairci_torch/ssl/siameseim.py``) against the JAX
package's ``SiameseIMRecipe``: ``relative_pos_embed``, the two-view
transform on JAX's draws, the masks from JAX's noise, ``PermuteBN`` and the
PermuteBN ``Block`` (training and eval mode), the online and target
forwards and the features, one step for each ``block_norm`` from identical
weights, BN statistics, views, boxes and mask (the loss, every gradient,
the online running statistics, the momentum branch's EMA of parameters and
PermuteBN buffers taken BEFORE the target forward, whose own statistics
updates are dropped, and the weights after AdamW), the reference ``.pth``
reader against ``convert_siameseim`` + ``merge_params``, and both CLIs on
the CPU (``mainpretrain --mode siameseim``, ``knn_classification --mode
siaMIM`` on the run and on a ``.pth``).

Both packages' ``vit_tiny_patch16`` (and ``vit_base_patch16``, which the
CLIs build) are cut to depth 2 at width 192, 3 heads, on 64-px views (a
4 x 4 grid, 6 tokens kept of 16); the decoder is 64 wide, 4 heads, 1
projector and 2 predictor blocks. One jitted JAX step for each block norm.
Weights and statistics are compared at rtol 1e-4 (the EMA and the optimizer
on JAX's gradients at 1e-6), the building blocks at rtol 1e-5."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hairci.models.vit as jax_vit
import hairci.ssl.siameseim as jax_siam
import hairci_torch.models.vit as port_vit
from hairci.models.heads import PermuteBN as JaxPermuteBN
from hairci.retrieval import torch_import as ti
from hairci.train.state import TrainState as JaxTrainState
from hairci_torch.cli import knn_classification, mainpretrain
from hairci_torch.models.convert import (
    _siam_block_from_jax,
    siameseim_block_norm,
    siameseim_state_dict,
    siameseim_state_dict_from_jax,
)
from hairci_torch.models.heads import PermuteBN
from hairci_torch.ssl import RECIPES
from hairci_torch.ssl.siameseim import (
    SiameseIMModule,
    SiameseIMRecipe,
    relative_pos_embed,
    sim_two_view_transform,
)
from test_torch_aug import _blur_draws, _cj_draws, _crop_draws
from test_torch_distill import random_tree
from test_torch_mae import IMG_DIR, manifests, timm_block
from test_torch_supcon import _close

torch.set_num_threads(1)
B, S, RAW = 4, 64, 80
TINY = (16, 192, 2, 3)            # patch, width, depth, heads
N = (S // 16) ** 2
DEC = dict(decoder_dim=64, decoder_num_heads=4, projector_depth=1,
           predictor_depth=2)
WD = 0.5          # one step's decay (lr * wd) shows above the tolerance
MOMENTUM = 0.9    # the EMA's move shows above the tolerance
CPU = torch.device("cpu")
NORMS = ("permute_bn", "ln")


def _t(a):
    return torch.from_numpy(np.array(a))


def tiny(mp, port_only=False):
    for pkg in (port_vit,) if port_only else (port_vit, jax_vit):
        for name in ("vit_tiny_patch16", "vit_base_patch16"):
            mp.setitem(pkg.VIT_CONFIGS, name, TINY)


def _boxes(rng):
    """(B, 4) crop boxes (top, left, h, w) inside a RAW x RAW image."""
    h, w = rng.uniform(20, RAW, (2, B))
    top = rng.uniform(0, 1, B) * (RAW - h)
    left = rng.uniform(0, 1, B) * (RAW - w)
    return np.stack([top, left, h, w], 1).astype(np.float32)


def _jax_recipe(block_norm="permute_bn", **kw):
    return jax_siam.SiameseIMRecipe(
        backbone="vit_tiny_patch16", img_size=S, block_norm=block_norm,
        dtype=jnp.float32, weight_decay=WD, **DEC, **kw)


def _port_recipe(block_norm="permute_bn", **kw):
    return SiameseIMRecipe(backbone="vit_tiny_patch16", img_size=S,
                           block_norm=block_norm, dtype=torch.float32,
                           weight_decay=WD, **DEC, **kw)


@pytest.fixture(scope="module", params=NORMS)
def jax_run(request):
    """JAX's step, forwards and features from a seeded state whose momentum
    branch (parameters and PermuteBN statistics) is apart from the online
    one; views and boxes are seeded arrays handed to both, the mask comes
    from JAX's key."""
    norm = request.param
    with pytest.MonkeyPatch.context() as mp:
        tiny(mp)
        orig = JaxTrainState.apply_gradients
        # keep the raw gradients (the step leaves neg_indices unused)
        mp.setattr(JaxTrainState, "apply_gradients",
                   lambda self, grads, **kw: orig(self, grads, **kw).replace(
                       neg_indices=grads))
        rng = np.random.default_rng(0)
        v1, v2 = (rng.normal(size=(B, S, S, 3)).astype(np.float32)
                  for _ in range(2))
        b1, b2 = _boxes(rng), _boxes(rng)
        mp.setattr(jax_siam, "sim_two_view_transform",
                   lambda key, x, size=224: tuple(
                       jnp.asarray(a) for a in (v1, v2, b1, b2)))
        jrec = _jax_recipe(norm)
        key = jax.random.key(7)
        _, k_mask = jax.random.split(key)
        scores = np.asarray(jax.random.uniform(k_mask, (B, 2, 2)))
        ids_keep = jrec._masks(k_mask, B)
        rel = jrec._rel(jnp.asarray(b1), jnp.asarray(b2))
        sample = jnp.zeros((B, RAW, RAW, 3), jnp.uint8)
        shapes = jax.eval_shape(lambda: jrec.create_state(
            jax.random.key(0), sample))
        params, stats, ema, ema_stats = (
            random_tree(t, rng) for t in (shapes.params, shapes.batch_stats,
                                          shapes.params, shapes.batch_stats))
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=jrec.tx.init(params), tx=jrec.tx, ema_params=ema,
            ema_batch_stats=ema_stats)
        new, aux = jax.device_get(jax.jit(jrec.train_step)(
            state, {"image": sample}, key, MOMENTUM))
        # the forwards, eagerly, from the start state
        variables = {"params": params, "batch_stats": stats}
        m = jrec.module
        pred, upd = m.apply(variables, jnp.asarray(v1), ids_keep, rel,
                            train=True, mutable=["batch_stats"],
                            method=m.online_forward)
        tgt_train, _ = m.apply(variables, jnp.asarray(v2), train=True,
                               mutable=["batch_stats"],
                               method=m.target_forward)
        tgt_eval = m.apply(variables, jnp.asarray(v2), train=False,
                           method=m.target_forward)
        images = rng.integers(0, 256, (3, S + 8, S + 8, 3), dtype=np.uint8)
        feats = jrec.extract_features(state, jnp.asarray(images))
    out = jax.device_get(dict(
        views=(v1, v2), boxes=(b1, b2), scores=scores, ids_keep=ids_keep,
        rel=rel, start=(params, stats), ema=(ema, ema_stats), new=new,
        aux=aux, pred=pred, pred_stats=upd.get("batch_stats", {}),
        tgt_train=tgt_train, tgt_eval=tgt_eval, images=images, feats=feats))
    return {"norm": norm, **out}


def _port_state(run, mp):
    tiny(mp, port_only=True)
    rec = _port_recipe(run["norm"])
    state = rec.create_state(0, B, CPU)
    state.online.load_state_dict(
        siameseim_state_dict_from_jax(*run["start"]), strict=True)
    state.ema.load_state_dict(
        siameseim_state_dict_from_jax(*run["ema"]), strict=True)
    return rec, state


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def test_relative_pos_embed_matches_jax():
    rng = np.random.default_rng(1)
    b1, b2 = _boxes(rng), _boxes(rng)
    for grid, dim in ((4, 128), (14, 1024)):
        want = jax_siam.relative_pos_embed(jnp.asarray(b1), jnp.asarray(b2),
                                           grid, dim)
        got = relative_pos_embed(_t(b1), _t(b2), grid, dim)
        assert got.shape == (B, grid * grid, dim)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_two_view_transform_matches_jax():
    """The apply half on JAX's draws (its key splits in its order: crop,
    crop, jitter, jitter, blur, blur; no flip): views and boxes."""
    key = jax.random.key(3)
    x = np.random.default_rng(3).integers(0, 256, (B, RAW, RAW - 8, 3),
                                          dtype=np.uint8)
    v1, v2, b1, b2 = jax_siam.sim_two_view_transform(key, jnp.asarray(x), S)
    ks = jax.random.split(key, 8)
    draws = {"crops": [torch.stack(_crop_draws(ks[i], B, RAW, RAW - 8,
                                               (0.2, 1.0)))
                       for i in (0, 1)],
             "jitter": [_cj_draws(ks[i], B, 0.4, 0.4, 0.2, 0.1, 0.8)
                        for i in (2, 3)],
             "blur": [_blur_draws(ks[i], B, (0.1, 2.0), 0.5)
                      for i in (4, 5)]}
    got = sim_two_view_transform(_t(x), draws, S)
    for g, w in zip(got[:2], (v1, v2)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=5e-5)
    for g, w in zip(got[2:], (b1, b2)):
        assert g.shape == (B, 4)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the draw half takes the same kinds of values, six draws in that order
    d = SiameseIMRecipe(img_size=S).draw(torch.Generator().manual_seed(0),
                                         B, RAW, RAW)
    assert [len(d["views"][k]) for k in ("crops", "jitter", "blur")] == \
        [2, 2, 2] and d["scores"].shape == (B, 2, 2)


@pytest.mark.parametrize("blockwise", [True, False])
def test_masks_match_jax(blockwise, monkeypatch):
    """Blockwise (the default) and token masks from JAX's noise, bitwise,
    on the 4 x 4 grid of the tests and ViT-B/16's 14 x 14."""
    tiny(monkeypatch)
    for size in (S, 224):
        key = jax.random.key(5)
        jrec = jax_siam.SiameseIMRecipe(img_size=size,
                                        with_blockwise_mask=blockwise)
        rec = SiameseIMRecipe(img_size=size, with_blockwise_mask=blockwise)
        want = np.asarray(jrec._masks(key, B))
        if blockwise:
            coarse = -(-rec.grid // max(min(4, rec.grid // 2), 1))
            draws = {"scores": _t(jax.random.uniform(key, (B, coarse,
                                                           coarse)))}
        else:
            draws = {"noise": _t(jax.random.uniform(key, (B, rec.grid ** 2)))}
        got = rec.ids_keep(draws, CPU)
        assert got.shape == (B, int(rec.grid ** 2 * 0.4)) == want.shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_permute_bn_matches_jax():
    """Training mode: the output and the running statistics after it;
    eval mode: the output from the running statistics; f32 and bf16
    inputs (the output in the input's dtype)."""
    rng = np.random.default_rng(2)
    x = (rng.normal(size=(3, 7, 32)) * 2 + 1).astype(np.float32)
    mod = JaxPermuteBN()
    v = random_tree(jax.eval_shape(lambda: mod.init(
        jax.random.key(0), jnp.asarray(x))), rng)
    bn = PermuteBN(32)
    bn.bn.load_state_dict({
        "weight": _t(v["params"]["BatchNorm_0"]["scale"]),
        "bias": _t(v["params"]["BatchNorm_0"]["bias"]),
        "running_mean": _t(v["batch_stats"]["BatchNorm_0"]["mean"]),
        "running_var": _t(v["batch_stats"]["BatchNorm_0"]["var"])})
    want, upd = mod.apply(v, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    got = bn.train()(_t(x))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5)
    for ours, theirs in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(
            getattr(bn.bn, ours).numpy(),
            upd["batch_stats"]["BatchNorm_0"][theirs], rtol=1e-5, atol=1e-6)
    v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
    want = mod.apply(v, jnp.asarray(x), train=False)
    np.testing.assert_allclose(bn.eval()(_t(x)).detach().numpy(), want,
                               rtol=1e-5, atol=1e-5)
    xb = jnp.asarray(x, jnp.bfloat16)
    want = mod.apply(v, xb, train=False)
    got = bn(_t(xb.astype(jnp.float32)).bfloat16())
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -8, atol=1e-2)


def test_permute_bn_block_matches_jax():
    """``Block(norm="permute_bn")`` in training mode (output, both norms'
    running statistics) and in eval mode, f32."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 9, 32)).astype(np.float32)
    blk = jax_vit.Block(4, norm="permute_bn")
    v = random_tree(jax.eval_shape(lambda: blk.init(
        jax.random.key(0), jnp.asarray(x))), rng)
    sd = {}
    _siam_block_from_jax(sd, "b", v["params"], v["batch_stats"])
    port = port_vit.Block(32, 4, torch.float32, norm="permute_bn")
    port.load_state_dict({k[2:]: t for k, t in sd.items()}, strict=True)
    want, upd = blk.apply(v, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    np.testing.assert_allclose(port.train()(_t(x)).detach().numpy(), want,
                               rtol=1e-5, atol=1e-5)
    sd = {}
    _siam_block_from_jax(sd, "b", v["params"], upd["batch_stats"])
    for name, t in port.named_buffers():
        np.testing.assert_allclose(t.numpy(), sd[f"b.{name}"], rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    want = blk.apply({"params": v["params"],
                      "batch_stats": upd["batch_stats"]}, jnp.asarray(x),
                     train=False)
    np.testing.assert_allclose(port.eval()(_t(x)).detach().numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_momentum_for_epoch_matches_jax():
    for epochs in (1, 2, 7, 100):
        port, ref = SiameseIMRecipe(epochs=epochs), \
            jax_siam.SiameseIMRecipe(epochs=epochs)
        assert [port.momentum_for_epoch(e) for e in range(epochs + 1)] == \
            [ref.momentum_for_epoch(e) for e in range(epochs + 1)]


# ---------------------------------------------------------------------------
# forwards and one step, each block norm
# ---------------------------------------------------------------------------

def test_forwards_and_features_match_jax(jax_run, monkeypatch):
    rec, state = _port_state(jax_run, monkeypatch)
    online = state.online.train()
    v1, v2 = (_t(v) for v in jax_run["views"])
    ids_keep = _t(jax_run["ids_keep"]).long()
    with torch.no_grad():
        pred = online.online_forward(v1, ids_keep, _t(jax_run["rel"]))
    assert pred.shape == (B, N, 64) and pred.dtype == torch.float32
    _close("online_forward", pred, jax_run["pred"], 1e-4)
    if jax_run["norm"] == "permute_bn":
        after = siameseim_state_dict_from_jax(jax_run["start"][0],
                                              jax_run["pred_stats"])
        for name, t in online.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                _close(name, t, after[name], 1e-5)
    for train, want in ((True, "tgt_train"), (False, "tgt_eval")):
        _, state = _port_state(jax_run, monkeypatch)
        with torch.no_grad():
            _close(want, state.online.train(train).target_forward(v2),
                   jax_run[want], 1e-4)
    feats = rec.extract_features(state, _t(jax_run["images"]))
    assert feats.shape == (3, 192)      # the raw cls token, no final norm
    _close("features", feats, jax_run["feats"], 1e-4)


def test_step_matches_jax(jax_run, monkeypatch):
    rec, state = _port_state(jax_run, monkeypatch)
    new = jax_run["new"]
    v1, v2 = (_t(v) for v in jax_run["views"])
    ids_keep = rec.ids_keep({"scores": _t(jax_run["scores"])}, CPU)
    np.testing.assert_array_equal(ids_keep.numpy(), jax_run["ids_keep"])
    rel = relative_pos_embed(*(_t(b) for b in jax_run["boxes"]), rec.grid,
                             2 * rec.decoder_dim)
    _close("rel", rel, jax_run["rel"], 1e-6)
    metrics = rec.step_on_views(state, v1, v2, ids_keep, _t(jax_run["rel"]),
                                momentum=MOMENTUM)
    _close("loss", metrics["loss"], jax_run["aux"]["loss"], 1e-4, 1e-7)
    assert state.step == 1

    g = siameseim_state_dict_from_jax(new.neg_indices, new.batch_stats)
    for name, p in state.online.named_parameters():
        _close(f"grad {name}", p.grad, g[name], 1e-4)
    # the online PermuteBN statistics after the online forward
    after = siameseim_state_dict_from_jax(new.params, new.batch_stats)
    buffers = dict(state.online.named_buffers())
    for name, t in buffers.items():
        if name != "decoder_pos":
            _close(f"running {name}", t, after[name], 1e-4)
    assert (len(buffers) > 1) == (jax_run["norm"] == "permute_bn")
    # the momentum branch: the EMA taken BEFORE the target forward, of the
    # parameters and the PermuteBN statistics, whose updates the target
    # forward did not keep
    ema = siameseim_state_dict_from_jax(new.ema_params, new.ema_batch_stats)
    for name, v in state.ema.state_dict().items():
        _close(f"ema {name}", v, ema[name], 1e-6, 1e-7)
    # after the port's own AdamW step: every weight whose gradient stands
    # clear of rounding
    for name, p in state.online.named_parameters():
        gn = g[name].numpy()
        clear = np.abs(gn) > max(1e-3 * np.abs(gn).max(), 1e-6)
        _close(name, p.detach()[clear], after[name][clear], 1e-4)

    # the optimizer on JAX's gradients: every weight
    _, state = _port_state(jax_run, monkeypatch)
    for name, p in state.online.named_parameters():
        p.grad = g[name].clone()
    state.optimizer.step()
    for name, p in state.online.named_parameters():
        _close(f"param {name}", p, after[name], 1e-6, 1e-6)


# ---------------------------------------------------------------------------
# the reference checkpoint layout
# ---------------------------------------------------------------------------

def _dec_block(sd, t, d, norm, rng):
    timm_block(sd, t, d, rng)
    if norm == "permute_bn":
        for n in ("norm1", "norm2"):
            w, b = sd.pop(f"{t}.{n}.weight"), sd.pop(f"{t}.{n}.bias")
            sd[f"{t}.{n}.bn.weight"], sd[f"{t}.{n}.bn.bias"] = w, b
            sd[f"{t}.{n}.bn.running_mean"] = torch.from_numpy(
                rng.normal(0, 0.1, d).astype(np.float32))
            sd[f"{t}.{n}.bn.running_var"] = torch.from_numpy(
                rng.uniform(0.5, 1.5, d).astype(np.float32))
            sd[f"{t}.{n}.bn.num_batches_tracked"] = torch.tensor(7)


def reference_siam_sd(norm="permute_bn", decoder=True, seed=0,
                      pred_norm=None):
    """A reference ``SiameseIMViT`` state dict at the tiny widths: the
    online timm encoder at the top level and its momentum copy under
    ``mm_`` (no final norm, the shared ``pos_embed``), and where
    ``decoder``: ``decoder_embed``, the decoder-width ``mask_token`` and
    the projector blocks in both branches, the predictor blocks,
    ``decoder_pred`` and ``decoder_pos_mlp`` online; ``pred_norm`` gives the
    predictor blocks another norm layout."""
    rng = np.random.default_rng(seed)
    p, d, depth, _ = TINY
    dd = DEC["decoder_dim"]

    def r(*shape):
        return torch.from_numpy(rng.normal(0, 0.1, shape).astype(np.float32))

    sd = {"pos_embed": r(1, N + 1, d)}
    for side in ("", "mm_"):
        sd.update({f"{side}cls_token": r(1, 1, d),
                   f"{side}patch_embed.proj.weight": r(d, 3, p, p),
                   f"{side}patch_embed.proj.bias": r(d)})
        for i in range(depth):
            timm_block(sd, f"{side}blocks.{i}", d, rng)
        if decoder:
            sd[f"{side}decoder_embed.weight"] = r(dd, d)
            sd[f"{side}decoder_embed.bias"] = r(dd)
            sd[f"{side}mask_token"] = r(1, 1, dd)
            _dec_block(sd, f"{side}projector_decoder_blocks.0", dd, norm, rng)
    if decoder:
        for i in range(DEC["predictor_depth"]):
            _dec_block(sd, f"predictor_decoder_blocks.{i}", dd,
                       pred_norm or norm, rng)
        sd.update({"decoder_pred.weight": r(dd, dd),
                   "decoder_pred.bias": r(dd),
                   "decoder_pos_mlp.weight": r(dd, 2 * dd),
                   "decoder_pos_mlp.bias": r(dd)})
    return sd


@pytest.mark.parametrize("norm,decoder", [("permute_bn", True),
                                          ("ln", True),
                                          ("permute_bn", False)])
def test_reference_reader_matches_convert_siameseim(norm, decoder,
                                                    monkeypatch):
    """``siameseim_state_dict`` against ``convert_siameseim`` merged over an
    initial JAX state: every tensor the JAX package takes from the file is
    the port's, every other one keeps the port's initial value (a file
    without a decoder stack keeps the whole initial decoder), in both
    branches; and the online features are JAX's."""
    tiny(monkeypatch)
    sd = reference_siam_sd(norm, decoder)
    assert siameseim_block_norm(sd) == norm
    model = SiameseIMModule("vit_tiny_patch16", S, block_norm=norm, **DEC)
    own = {k: v.clone() for k, v in model.state_dict().items()}
    online, mm = siameseim_state_dict(sd, model)

    jrec = _jax_recipe(norm)
    rng = np.random.default_rng(6)
    images = rng.integers(0, 256, (2, S, S, 3), dtype=np.uint8)
    # a seeded initial JAX state (its values, not JAX's init, are what
    # the merge keeps); the momentum branch starts as a copy, as in JAX
    shapes = jax.eval_shape(lambda: jrec.create_state(
        jax.random.key(0), jnp.asarray(images)))
    p0, s0 = (random_tree(t, rng) for t in (shapes.params,
                                            shapes.batch_stats))
    init = types.SimpleNamespace(params=p0, batch_stats=s0, ema_params=p0,
                                 ema_batch_stats=s0)
    params, stats, emap, emastats = ti.convert_siameseim(
        {k: v.numpy() for k, v in sd.items()}, depth=TINY[2])
    taken = {}
    for branch, ours, (p, s), (p0, s0) in (
            ("online", online, (params, stats),
             (init.params, init.batch_stats)),
            ("mm", mm, (emap, emastats),
             (init.ema_params, init.ema_batch_stats))):
        want = siameseim_state_dict_from_jax(ti.merge_params(p0, p),
                                             ti.merge_params(s0, s))
        start = siameseim_state_dict_from_jax(p0, s0)
        assert set(ours) == set(own)
        taken[branch] = {k for k in own if not torch.equal(want[k], start[k])}
        for k, v in ours.items():
            assert torch.equal(v, want[k] if k in taken[branch] else own[k]), \
                (branch, k)
    # the momentum branch takes the projector, never the predictor
    decoder_keys = {k for k in own if not k.startswith("encoder.")}
    projector = {k for k in decoder_keys
                 if k.startswith(("decoder_embed.", "projector_blocks."))
                 or k == "mask_token"}
    assert not decoder or projector <= taken["mm"]
    assert decoder == bool(decoder_keys & taken["online"])
    assert taken["mm"] & decoder_keys <= projector
    model.load_state_dict(online, strict=True)
    want = jrec.extract_features(
        types.SimpleNamespace(params=ti.merge_params(p0, params),
                              batch_stats=s0), jnp.asarray(images))
    got = SiameseIMRecipe(img_size=S).extract_features(
        types.SimpleNamespace(online=model), _t(images))
    assert got.shape == (2, 192)
    _close("features", got, np.asarray(want), 1e-4)


def test_mixed_decoder_norms_are_refused(tmp_path, monkeypatch):
    sd = reference_siam_sd("ln", pred_norm="permute_bn")
    with pytest.raises(ValueError, match="mixes LayerNorm and PermuteBN"):
        siameseim_block_norm(sd)
    with pytest.raises(ValueError, match="mixes"):
        ti.siameseim_block_norm({k: v.numpy() for k, v in sd.items()})
    torch.save({"model": sd}, tmp_path / "mixed.pth")
    with pytest.raises(SystemExit, match="mixes LayerNorm and PermuteBN"):
        _run_knn(tmp_path, tmp_path / "mixed.pth", monkeypatch)


# ---------------------------------------------------------------------------
# both CLIs on the CPU
# ---------------------------------------------------------------------------

def _tiny_cli(mp):
    tiny(mp, port_only=True)
    mp.setitem(RECIPES, "siameseim",
               functools.partial(SiameseIMRecipe, **DEC))


def _common(tmp_path):
    train_csv, test_csv = manifests(tmp_path)
    return ["--model", "vit_b_16", "--size", str(S), "--device", "cpu",
            "--dtype", "float32", "--batch_size", "4", "--num_workers", "1",
            "--train_annotation", train_csv, "--img_dir", str(IMG_DIR)], \
        test_csv


def _run_knn(tmp_path, checkpoint, mp):
    _tiny_cli(mp)
    common, test_csv = _common(tmp_path)
    return knn_classification.main(
        common + ["--mode", "siaMIM", "--eval_type", "knn",
                  "--test_annotation", test_csv,
                  "--checkpoint_path", str(checkpoint),
                  "--save_path", str(tmp_path / "knn")])


def test_clis_train_and_evaluate_siameseim(tmp_path, monkeypatch):
    """``mainpretrain --mode siameseim`` (2 epochs of 3 batches of 4, the
    last padded): each step gets its epoch's momentum, a finite ``Loss =``
    line each epoch, the checkpoint holds both branches with the momentum
    branch's PermuteBN statistics; then ``knn_classification --mode
    siaMIM`` on the run: the online encoder's raw cls features."""
    _tiny_cli(monkeypatch)
    seen = []
    step = SiameseIMRecipe.train_step

    def spy(self, state, images, gen, momentum=0.996):
        seen.append(momentum)
        assert images.shape[0] == 4
        return step(self, state, images, gen, momentum=momentum)

    monkeypatch.setattr(SiameseIMRecipe, "train_step", spy)
    common, _ = _common(tmp_path)
    trainer = mainpretrain.main(common + [
        "--mode", "siameseim", "--epochs", "2",
        "--save_path", str(tmp_path / "out")])
    rec = trainer.recipe
    assert (rec.backbone, rec.epochs, rec.block_norm) == (
        "vit_base_patch16", 2, "permute_bn")
    assert seen == [0.996] * 3 + [1.0] * 3 and trainer.state.step == 6
    log = next((tmp_path / "out").glob("*/training_log.txt")).read_text()
    losses = [float(line.split("Loss = ")[1]) for line in log.splitlines()
              if ": Loss = " in line]
    assert len(losses) == 2 and all(np.isfinite(losses))
    ckpt = torch.load(f"{trainer.save_path}/model_ckpt_latest",
                      weights_only=True)
    assert set(ckpt) == {"online", "ema", "optimizer", "step", "epoch"}
    key = "projector_blocks.0.norm1.bn.running_var"
    assert not torch.equal(ckpt["ema"][key], ckpt["online"][key])
    assert torch.equal(ckpt["ema"][key],
                       trainer.state.ema.get_buffer(key))

    clf = _run_knn(tmp_path, trainer.save_path, monkeypatch)
    tr_f, _, te_f, _ = clf.extracting_features()
    assert tr_f.shape == (10, 192) and te_f.shape == (6, 192)
    images = np.concatenate([x for x, _ in clf.train_loader])[:10]
    raw = rec.extract_features(trainer.state, torch.from_numpy(images))
    np.testing.assert_allclose(
        tr_f, (raw / raw.norm(dim=1, keepdim=True)).numpy(), atol=1e-6)


def test_knn_cli_reads_a_reference_siameseim_pth(tmp_path, monkeypatch):
    """A reference ``.pth`` with LayerNorm decoder blocks: the CLI rebuilds
    the recipe with ``block_norm="ln"`` and gives the features of the file's
    online encoder."""
    sd = reference_siam_sd("ln", seed=3)
    torch.save({"model": sd}, tmp_path / "siam.pth")
    clf = _run_knn(tmp_path, tmp_path / "siam.pth", monkeypatch)
    tr_f, _, _, _ = clf.extracting_features()
    model = SiameseIMModule(img_size=S, block_norm="ln", **DEC)
    model.load_state_dict(siameseim_state_dict(sd, model)[0])
    images = np.concatenate([x for x, _ in clf.train_loader])[:10]
    want = SiameseIMRecipe(img_size=S).extract_features(
        types.SimpleNamespace(online=model), torch.from_numpy(images))
    np.testing.assert_allclose(
        tr_f, (want / want.norm(dim=1, keepdim=True)).numpy(), atol=1e-6)
