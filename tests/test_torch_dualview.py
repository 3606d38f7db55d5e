"""DualViewHair in the port (``hairci_torch/experiments/dualview``) against
the JAX package on the CPU: the pair loader's pairs and batch order over
three epochs (the first-epoch offset of ``train`` included), the student's
view on JAX's draws, the four losses with their gradients, the momentum
queue's ring write across a wrap, the three encoders in train and eval mode
from converted weights, and one ``infonce`` and one ``queue`` step of JAX's
jitted ``make_train_step`` from the same state and draws (the loss, every
gradient, the BN statistics, the EMA taken before the step, Adam on JAX's
gradients, the queue's bank and pointer).

Weights come from ``random_tree`` (the EMA apart from the online weights),
images from a numpy seed that differ in colour and contrast, so that the
pooled features of two images differ and the head's BNs over a few rows are
well conditioned (on white noise every image pools to nearly the same
feature, and the f32 rounding of the trunk is amplified some hundredfold).
The encoders run at full ResNet-18 depth at 128 px, B=8.

The steps run ResNet-18 cut to one block a stage (as the BYOL and DenseCL
tests do): here at 32 px, B=8, against JAX's jitted step; the enhanced
encoders' (``test_torch_dualview_enhanced.py``) at B=16 on JAX's own
student view, multiscale at 64 px against the jitted step, partbased at
128 px (its strips need a 4-row map) against JAX's step run op by op
(``jax.disable_jit``). Measured on a CPU, from one state and one batch
at 128 px: jitted, the
JAX step's gradients differ from its own op-by-op run by 0.7-1.2 % of a
tensor's largest entry (8.6 % at B=8; the XLA:CPU fusion of the step, its
fast-math flags change nothing), while the port and the op-by-op run agree
within 1e-5. At B=4, or at full depth, the step's gradients are chaotic in
f32 (in the port alone, weights moved by 1e-7 of themselves move a
gradient by up to 9 %; port and op-by-op JAX 1-3 % apart at full depth,
B=16). Tolerances: outputs, BN statistics, losses and
gradients rtol 1e-4 with an atol of 1e-4 of the largest entry; the EMA and
Adam on JAX's gradients 1e-6; the losses alone rtol 1e-5; the student's
view 2e-5 (resize weights round differently)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import hairci.experiments.dualview.data as jdata
import hairci.experiments.dualview.enhanced as jenh
import hairci.experiments.dualview.losses as jlosses
import hairci.experiments.dualview.models as jmodels
import hairci.experiments.dualview.train as jtrain
import hairci.models.resnet as jax_resnet
import hairci_torch.models.resnet as port_resnet
from hairci.train.state import TrainState as JaxTrainState
from hairci_torch.experiments.dualview import data, enhanced, losses, models
from hairci_torch.experiments.dualview import train as dvtrain
from hairci_torch.models.convert import dualview_state_dict_from_jax
from test_torch_aug import _cj_draws, _crop_draws, _flags
from test_torch_distill import check_grads, random_tree
from test_torch_supcon import _close

torch.set_num_threads(1)
CPU = torch.device("cpu")
MOMENTUM = 0.9    # the EMA's move shows above the tolerance


def _t(a):
    return torch.from_numpy(np.array(a))


def blocky(rng, B, S, dtype=np.float32):
    """Images that differ in their colour and contrast, (B, S, S, 3): as
    roughly normalised floats (colour blocks plus noise), or as uint8
    noise around a colour of each image's own, in [45, 175], so that the
    student view's colour jitter clips hardly a pixel at 0 or 1 (a clipped
    flat patch makes ties in the stem's max pool, whose gradient XLA and
    torch route to different elements)."""
    if dtype == np.uint8:
        mean = rng.uniform(80, 140, (B, 1, 1, 3))
        amp = rng.uniform(5, 35, (B, 1, 1, 1))
        return (mean + amp * rng.uniform(-1, 1, (B, S, S, 3))).astype(
            np.uint8)
    n = max(S // 16, 1)
    blocks = rng.uniform(-1, 1, (B, n, n, 3))
    x = np.repeat(np.repeat(blocks, S // n, 1), S // n, 2)
    return (1.5 * x + 0.3 * rng.normal(size=(B, S, S, 3))).astype(np.float32)


@pytest.fixture(scope="module")
def pair_root(tmp_path_factory):
    """9 pairs as ``{stem}.jpg`` / ``{stem}_hair.png``, one ``.jpeg``, a
    lone hair crop and a stray file."""
    root = tmp_path_factory.mktemp("pairs")
    rng = np.random.default_rng(0)
    for i in range(9):
        full = rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)
        hair = full.copy()
        hair[:, :20] = 0
        Image.fromarray(full).save(root / f"img{i}.{'jpeg' if i == 4 else 'jpg'}")
        Image.fromarray(hair).save(root / f"img{i}_hair.png")
    Image.fromarray(hair).save(root / "lonely_hair.png")
    (root / "notes.txt").write_text("not an image")
    return str(root)


# ---------------------------------------------------------------------------
# the loader and the student's view
# ---------------------------------------------------------------------------

def test_pairs_and_batch_order_match_jax(pair_root):
    assert data.discover_pairs(pair_root) == jdata.discover_pairs(pair_root)
    assert len(data.discover_pairs(pair_root)) == 9
    ours = data.PairLoader(pair_root, batch_size=4, size=32, seed=5)
    ref = jdata.PairLoader(pair_root, batch_size=4, size=32, seed=5)
    assert len(ours) == len(ref) == 2
    # train() draws one batch first: epoch e is shuffled with seed + e + 1
    next(iter(ours))
    next(iter(ref))
    orders = []
    for _ in range(3):
        a, b = list(ours), list(ref)
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            assert x["full"].shape == (4, 32, 32, 3)
            np.testing.assert_array_equal(x["full"], y["full"])
            np.testing.assert_array_equal(x["hair"], y["hair"])
        orders.append(np.concatenate([x["full"][:, 0, 0] for x in a]))
    assert not np.array_equal(orders[0], orders[1])
    assert ours._epoch == ref._epoch == 4


def student_draws(key, B, S):
    """JAX's draws of ``_student_aug(key, x)`` as the port's draw dict."""
    ks = jax.random.split(key, 3)
    d = {"crop": torch.stack(_crop_draws(ks[0], B, S, S, (0.6, 1.0))),
         "flip": _flags(ks[1], 0.5, B)}
    d.update({f"cj_{k}": v for k, v in _cj_draws(
        ks[2], B, 0.4, 0.4, 0.4, 0.1, 0.8).items()})
    return d


def test_student_and_teacher_views_match_jax():
    B, S = 6, 40
    x = blocky(np.random.default_rng(1), B, S, np.uint8)
    key = jax.random.key(11)
    want = jax.jit(jtrain._student_aug)(key, jnp.asarray(x))
    got = dvtrain._student_aug(_t(x), student_draws(key, B, S))
    assert got.shape == (B, S, S, 3)
    # the resize weights round differently in XLA and torch (~3e-6 in
    # [0, 1]); after normalize (1/std ~ 4.4) up to ~1.2e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=2e-5)
    np.testing.assert_allclose(dvtrain._teacher_aug(_t(x)).numpy(),
                               np.asarray(jtrain._teacher_aug(x)), rtol=0,
                               atol=1e-6)
    # the draw half is seeded and fills the apply half's keys
    d = dvtrain._student_draw(torch.Generator().manual_seed(3), B, S, S)
    assert set(d) == set(student_draws(key, B, S))
    again = dvtrain._student_draw(torch.Generator().manual_seed(3), B, S, S)
    assert all(torch.equal(d[k], again[k]) for k in d)


# ---------------------------------------------------------------------------
# losses and the queue
# ---------------------------------------------------------------------------

LOSS_FNS = {
    "contrastive": (lambda s, t: jmodels.contrastive_loss(s, t, 0.07),
                    lambda s, t: models.contrastive_loss(s, t, 0.07)),
    "ntxent": (lambda s, t: jlosses.ntxent_loss_symmetric(s, t),
               lambda s, t: losses.ntxent_loss_symmetric(s, t)),
    "asymmetric": (lambda s, t: jlosses.asymmetric_ntxent_loss(s, t, 0.1,
                                                               0.7),
                   lambda s, t: losses.asymmetric_ntxent_loss(s, t, 0.1,
                                                              0.7)),
    "hybrid": (lambda s, t: jenh.hybrid_loss(s, t)[0],
               lambda s, t: enhanced.hybrid_loss(s, t)[0]),
}


@pytest.mark.parametrize("name", sorted(LOSS_FNS))
def test_losses_and_gradients_match_jax(name):
    rng = np.random.default_rng(2)
    s, t = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(2))
    check_grads(*LOSS_FNS[name], [s, t], argnums=(0, 1))


def test_hybrid_terms_match_jax():
    rng = np.random.default_rng(3)
    s, t = (rng.normal(size=(5, 8)).astype(np.float32) for _ in range(2))
    total, parts = enhanced.hybrid_loss(_t(s), _t(t), 0.1, 1.0, 0.3, 0.2)
    jtotal, jparts = jenh.hybrid_loss(s, t, 0.1, 1.0, 0.3, 0.2)
    assert set(parts) == set(jparts) == {"contrastive", "align", "uniform"}
    for k in parts:
        np.testing.assert_allclose(parts[k].numpy(), np.asarray(jparts[k]),
                                   rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(total.numpy(), np.asarray(jtotal), rtol=1e-5)


def test_queue_enqueue_bitwise_across_a_wrap_and_its_loss():
    rng = np.random.default_rng(4)
    ours, ref = losses.MomentumQueue(8, size=6), jlosses.MomentumQueue(8, 6)
    bank, ptr = ours.init(CPU)
    jbank, jptr = ref.init()
    assert bank.shape == (6, 8) and bank.dtype == torch.float32
    assert ptr.dim() == 0 and int(ptr) == 0
    for _ in range(3):                      # 0 -> 4 -> 2 (wrapped) -> 0
        keys = rng.normal(size=(4, 8)).astype(np.float32)
        bank, ptr = ours.enqueue(bank, ptr, _t(keys))
        jbank, jptr = ref.enqueue(jbank, jptr, jnp.asarray(keys))
        np.testing.assert_array_equal(bank.numpy(), np.asarray(jbank))
        assert int(ptr) == int(jptr)
    q, k = (rng.normal(size=(4, 8)).astype(np.float32) for _ in range(2))
    check_grads(lambda q, k, b: ref.loss(q, k, b, 0.07),
                lambda q, k, b: ours.loss(q, k, b, 0.07),
                [q, k, np.asarray(jbank)], argnums=(0,))


# ---------------------------------------------------------------------------
# encoders and one step against JAX
# ---------------------------------------------------------------------------

def jax_encoder(encoder, backbone="resnet18"):
    if encoder == "resnet":
        return jmodels.HairstyleEncoder(backbone)
    return jenh.ENCODERS[encoder](backbone_name=backbone)


def port_encoder(encoder, variables, backbone="resnet18"):
    cls = (models.HairstyleEncoder if encoder == "resnet"
           else enhanced.ENCODERS[encoder])
    module = cls(backbone_name=backbone)
    module.load_state_dict(dualview_state_dict_from_jax(
        variables, encoder, backbone), strict=True)
    return module


def _sd(variables, encoder):
    return dualview_state_dict_from_jax(variables, encoder, "resnet18")


@pytest.mark.parametrize("encoder", ["resnet", "multiscale", "partbased"])
def test_encoders_match_jax(encoder):
    """Train mode (the projection, the embedding and the BN statistics)
    and eval mode, ResNet-18 at 128 px (a 4 x 4 last map: every strip of
    the part-based encoder one row)."""
    B, S = 8, 128
    rng = np.random.default_rng(5)
    x = blocky(rng, B, S)
    jm = jax_encoder(encoder)
    v = random_tree(jax.eval_shape(lambda: jm.init(
        jax.random.key(0), jnp.zeros((1, S, S, 3)), train=True)), rng)

    @jax.jit
    def run(v, x):
        z, upd = jm.apply(v, x, train=True, mutable=["batch_stats"])
        e, _ = jm.apply(v, x, train=True, return_embedding=True,
                        mutable=["batch_stats"])
        return z, e, upd["batch_stats"], jm.apply(v, x, train=False)

    z, e, stats, z_eval = run(v, x)
    module = port_encoder(encoder, v).train()
    _close("train projection", module(_t(x)), z, 1e-4)
    after = _sd({"params": v["params"], "batch_stats": stats}, encoder)
    for name, buf in module.named_buffers():
        _close(f"running {name}", buf, after[name], 1e-4)
    module = port_encoder(encoder, v).train()
    _close("train embedding", module(_t(x), return_embedding=True), e, 1e-4)
    module = port_encoder(encoder, v).eval()
    with torch.no_grad():
        _close("eval projection", module(_t(x)), z_eval, 1e-4)
    assert z.shape == (B, 128) and e.shape == (B, 256)


def cut(mp):
    """Both packages' ResNet-18 cut to one block a stage (the step tests)."""
    mp.setitem(jax_resnet._STAGES, "resnet18",
               ([1, 1, 1, 1], jax_resnet.BasicBlock))
    mp.setitem(port_resnet._STAGES, "resnet18",
               ([1, 1, 1, 1], port_resnet.BasicBlock))


def jax_step_run(encoder, loss, S, B=8, seed=0, jit=True, jax_view=False):
    """JAX's ``make_train_step`` from a seeded state (the EMA apart from the
    online weights) on a uint8 batch, jitted or (``jit=False``) run op by
    op; its raw gradients kept; with ``jax_view`` JAX's student view too
    (computed the same way), for the port's step to take. With ``queue``
    a random bank of 4096 x 128 whose pointer wraps in the step. Call with
    the trunk cut (``cut``)."""
    with pytest.MonkeyPatch.context() as mp:
        orig = JaxTrainState.apply_gradients
        mp.setattr(JaxTrainState, "apply_gradients",
                   lambda self, grads, **kw: orig(self, grads, **kw).replace(
                       neg_indices=grads))
        rng = np.random.default_rng(seed)
        jmodel = jmodels.DualViewHairModel(backbone="resnet18",
                                           momentum=MOMENTUM,
                                           encoder=encoder)
        shapes = jax.eval_shape(lambda: jmodel.create_state(
            jax.random.key(0), jnp.zeros((1, S, S, 3))))
        params, stats, ema, ema_stats = (
            random_tree(t, rng) for t in (shapes.params, shapes.batch_stats,
                                          shapes.params, shapes.batch_stats))
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=jmodel.tx.init(params), tx=jmodel.tx,
            ema_params=ema, ema_batch_stats=ema_stats)
        batch = {"full": blocky(rng, B, S, np.uint8),
                 "hair": blocky(rng, B, S, np.uint8)}
        key = jax.random.key(7)
        queue = jlosses.MomentumQueue(128) if loss == "queue" else None
        step = jtrain.make_train_step(jmodel, loss, queue)
        run = dict(start=(params, stats), ema=(ema, ema_stats), batch=batch,
                   key=key, S=S, B=B, encoder=encoder, loss=loss)
        if jit:
            step = jax.jit(step)
        with jax.disable_jit(not jit):
            if jax_view:
                aug = jax.jit(jtrain._student_aug) if jit else \
                    jtrain._student_aug
                run["full_view"] = np.asarray(aug(key, batch["full"]))
            if queue:
                bank = rng.normal(size=(4096, 128)).astype(np.float32)
                ptr = np.asarray(4096 - B // 2, np.int32)
                new, aux, nbank, nptr = jax.device_get(step(
                    state, batch, key, jnp.asarray(bank), jnp.asarray(ptr)))
                run.update(bank=bank, ptr=ptr, new_bank=nbank, new_ptr=nptr)
            else:
                new, aux = jax.device_get(step(state, batch, key))
    run.update(new=new, aux=aux)
    return run


def _port_state(run):
    model = models.DualViewHairModel(backbone="resnet18", momentum=MOMENTUM,
                                     encoder=run["encoder"])
    state = model.create_state(0, CPU)
    enc = run["encoder"]
    state.online.load_state_dict(_sd(dict(zip(
        ("params", "batch_stats"), run["start"])), enc), strict=True)
    state.ema.load_state_dict(_sd(dict(zip(
        ("params", "batch_stats"), run["ema"])), enc), strict=True)
    return model, state


BIAS_BEFORE_BN = {"emb_fc.bias", "proj_fc1.bias", "proj_fc2.bias"}


def check_step_against_jax(run):
    """The port's step from the run's state, batch and JAX's draws: the
    loss, every gradient, the BN statistics, the EMA taken before the step;
    then Adam on JAX's gradients. Returns the port's metrics."""
    enc, loss, new = run["encoder"], run["loss"], run["new"]
    model, state = _port_state(run)
    queue = losses.MomentumQueue(128) if loss == "queue" else None
    step = dvtrain.make_train_step(model, loss, queue)
    batch = {k: _t(v) for k, v in run["batch"].items()}
    draws = student_draws(run["key"], run["B"], run["S"])
    if "full_view" in run:
        # JAX's own view: a view 1e-5 apart flips max-pool and ReLU choices
        # that lie within rounding at 64-128 px
        view = _t(run["full_view"])
        step = functools.partial(
            lambda on_views, state, batch, draws, *a: on_views(
                state, view, dvtrain._teacher_aug(batch["hair"]), *a),
            step.on_views)
    if queue:
        m, bank, ptr = step(state, batch, draws, _t(run["bank"]),
                            torch.tensor(int(run["ptr"])))
        B = run["B"]
        assert int(ptr) == int(run["new_ptr"]) == B // 2       # wrapped
        rows = [(4096 - B // 2 + i) % 4096 for i in range(B)]
        _close("enqueued keys", bank[rows], run["new_bank"][rows], 1e-4)
        untouched = np.ones(4096, bool)
        untouched[rows] = False
        np.testing.assert_array_equal(bank.numpy()[untouched],
                                      run["bank"][untouched])
    else:
        m = step(state, batch, draws)
    _close("loss", m["loss"], run["aux"]["loss"], 1e-4, 1e-7)
    assert state.step == 1
    g = _sd({"params": new.neg_indices, "batch_stats": run["start"][1]}, enc)
    top = max(float(v.abs().max()) for k, v in g.items()
              if k not in BIAS_BEFORE_BN)
    for name, p in state.online.named_parameters():
        # a bias a BN subtracts again has no gradient in exact arithmetic:
        # both packages' are rounding, held against the largest gradient
        _close(f"grad {name}", p.grad, g[name], 1e-4,
               1e-4 * top if name in BIAS_BEFORE_BN else None)
    after = _sd({"params": new.params, "batch_stats": new.batch_stats}, enc)
    for name, buf in state.online.named_buffers():
        _close(f"running {name}", buf, after[name], 1e-4)
    ema = _sd({"params": new.ema_params,
               "batch_stats": new.ema_batch_stats}, enc)
    for name, v in state.ema.state_dict().items():
        _close(f"ema {name}", v, ema[name], 1e-6, 1e-7)
    # Adam on JAX's gradients: every weight
    _, state = _port_state(run)
    for name, p in state.online.named_parameters():
        p.grad = g[name].clone()
    state.optimizer.step()
    for name, p in state.online.named_parameters():
        _close(f"param {name}", p, after[name], 1e-6, 1e-6)
    return m


@pytest.mark.parametrize("loss", ["infonce", "queue"])
def test_step_matches_jax(loss, monkeypatch):
    cut(monkeypatch)
    run = jax_step_run("resnet", loss, S=32)
    m = check_step_against_jax(run)
    assert set(m) == {"loss"}


def test_retrieval_model_matches_jax_index(monkeypatch):
    """``HairstyleRetrievalModel`` over the teacher's embeddings on the
    CPU route of the top-k: the same indices and scores as JAX's
    ``GalleryIndex``, self-retrieval at rank 1."""
    cut(monkeypatch)
    B, S = 8, 32
    rng = np.random.default_rng(6)
    jmodel = jmodels.DualViewHairModel(backbone="resnet18")
    x = blocky(rng, B, S)
    jstate = jax.jit(jmodel.create_state)(jax.random.key(0), jnp.asarray(x))
    jmodel.get_embeddings = jax.jit(jmodel.get_embeddings,
                                    static_argnames="use_teacher")
    model, state = _port_state(dict(
        encoder="resnet", start=(jstate.params, jstate.batch_stats),
        ema=(jstate.ema_params, jstate.ema_batch_stats)))
    paths = [f"p{i}" for i in range(B)]
    ours = models.HairstyleRetrievalModel(model, state)
    ref = jmodels.HairstyleRetrievalModel(jmodel, jstate)
    ours.build_database(x, paths)
    ref.build_database(x, paths)
    s, p = ours.retrieve(x[:3], k=5)
    js, jp = ref.retrieve(x[:3], k=5)
    assert p == jp and [row[0] for row in p] == paths[:3]
    np.testing.assert_allclose(s, np.asarray(js), atol=1e-5)
    assert ours.index.device.type == "cpu" and not ours.index.use_kernel
