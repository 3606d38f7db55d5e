"""DINOv2 and SiameseIM under data parallelism: two gloo ranks on the CPU
compute what one process computes on the global batch, and what JAX's
jitted step computes with the batch sharded over the 8 virtual CPU devices
``tests/conftest.py`` forces -- the counterparts of
``tests/test_dp_equivalence.py``'s DINOv2 centring, KoLeo and SiameseIM
UniGrad cases, at that file's configuration: ``vit_tiny_patch16`` at 32 px
(a 2 x 2 grid; both packages' cut from 12 blocks to 4 to keep JAX's
compile short, width 192 and 3 heads kept), DINOv2 with two 16-px local
views and 64 prototypes,
SiameseIM with the 64-wide, 4-head PermuteBN decoder; a global batch of 16
uint8 images of 48 px, f32. Each rank feeds its rows ``[8 r, 8 r + 8)`` to
``train_step``.

The weights are seeded random values (``tests/test_torch_distill.py``'s
``random_tree``), the centres too. ``centring``: LayerScale gammas at
their init of 1e-5, teacher = student, ``koleo_weight`` 0 (KoLeo's nearest
neighbour is rounding noise there: the cls rows nearly tie); ``koleo``:
random gammas in [0.2, 1] and ``koleo_weight`` 0.1, where the nearest
neighbours stand clear and the KoLeo term itself is held too. SiameseIM:
the momentum branch and all PermuteBN statistics apart from the online
ones, momentum 0.9 so that the EMA shows. The port draws the views for the
global batch from one generator; the block scores are JAX's, from its key;
JAX gets the port's views (and SiameseIM's crop boxes) through its batch,
so that they are sharded with it.

Held at ``tests/test_dp_equivalence.py``'s tolerances for these recipes:
the loss at rtol 3e-4 / atol 1e-5; the gradients the optimizer receives
(the mean over the ranks) as that file holds its SGD update (it switches
these recipes to SGD because Adam's first step, about lr times the sign of
the gradient, turns rounding noise into lr-sized moves): their norm at
rtol 2e-3 and their leaf-wise difference within 2e-3 of that norm; both
centres at rtol 1e-4 / atol 1e-6; the PermuteBN running statistics after
the online forward and the momentum branch (parameters and statistics,
the EMA taken before the target's forward) at rtol 1e-5 / atol 1e-6; and
the parameters, teacher, centres and statistics of the two ranks bit for
bit. One spawn of two gloo processes computes every two-rank case; JAX's
two compiles (DINOv2 with its KoLeo weight traced, SiameseIM) run side by
side in threads meanwhile.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from hairci_torch.parallel import collectives
from test_torch_dp import _free_port, _images
from test_torch_dp_vit import _grads_close

torch.set_num_threads(1)
B, S, RAW, W = 16, 32, 48, 2
LOCAL, N_LOCAL, HEAD = 16, 2, 64
DEC = dict(decoder_dim=64, decoder_num_heads=4)
TEMP, MOM, SIAM_MOM = 0.04, 0.99, 0.9
CASES = ["centring", "koleo", "siameseim"]
KOLEO = {"centring": 0.0, "koleo": 0.1}
TINY_VIT = (16, 192, 4, 3)        # patch, width, depth, heads


def _cut(mp=None):
    """Both packages' ViT-Tiny to 4 blocks through the monkeypatch ``mp``;
    without one, the port's alone (a spawned rank, which imports no
    JAX)."""
    import hairci_torch.models.vit as port_vit

    if mp is None:
        port_vit.VIT_CONFIGS["vit_tiny_patch16"] = TINY_VIT
        return
    import hairci.models.vit as jax_vit

    for vit in (port_vit, jax_vit):
        mp.setitem(vit.VIT_CONFIGS, "vit_tiny_patch16", TINY_VIT)


def _recipe(case):
    from hairci_torch.ssl import build_recipe

    if case == "siameseim":
        return build_recipe("siameseim", backbone="vit_tiny_patch16",
                            img_size=S, dtype=torch.float32, **DEC)
    return build_recipe("dinov2", backbone="vit_tiny_patch16", img_size=S,
                        local_size=LOCAL, n_local=N_LOCAL, head_out=HEAD,
                        dtype=torch.float32, koleo_weight=KOLEO[case])


def port_step(case, setup, images):
    """One port step of ``case`` on ``images`` (this rank's rows under a
    process group) from the shared state: metrics, gradients, new state."""
    rec = _recipe(case)
    state = rec.create_state(0, B, torch.device("cpu"))
    s = setup[case]
    state.online.load_state_dict(s["online"])
    state.ema.load_state_dict(s["ema"])
    rec.draw = lambda gen, b, h, w: (
        s["draws"] if b == B else pytest.fail(f"drew {b}"))
    collectives.calls.update(all_gather=0, all_reduce=0)
    x = torch.from_numpy(images)
    if case == "siameseim":
        metrics = rec.train_step(state, x, None, momentum=SIAM_MOM)
    else:
        state.extra = {k: v.clone() for k, v in s["extra"].items()}
        metrics = rec.train_step(state, x, None, teacher_temp=TEMP,
                                 momentum=MOM)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone()
                      for n, p in state.online.named_parameters()},
            "state": {k: v.clone() for k, v in
                      state.online.state_dict().items()},
            "ema": {k: v.clone() for k, v in state.ema.state_dict().items()},
            "extra": state.extra, "calls": dict(collectives.calls)}


def ibot_case(setup, rank=None):
    """DINOv2's chunked iBOT loss on seeded tokens whose mask weights the
    ranks hold in different counts (the first half of the rows mostly
    masked, the second mostly not; at the step's 2 x 2 grid every image
    masks one token): rank r's rows under a process group, all rows in one
    process. Returns the loss, the new centre and the students' token
    gradient."""
    rec = _recipe("centring")
    state = rec.create_state(0, B, torch.device("cpu"))
    state.online.load_state_dict(setup["centring"]["online"])
    state.ema.load_state_dict(setup["centring"]["ema"])
    rng = np.random.default_rng(30)
    R, M, dim = 2 * B, 3, state.online.backbone.embed_dim
    t_m, s_m = (torch.from_numpy(rng.normal(size=(R, M, dim)).astype(
        np.float32)) for _ in range(2))
    p = np.repeat([0.8, 0.2], R // 2)[:, None]
    w = torch.from_numpy((rng.uniform(size=(R, M)) < p).astype(np.float32))
    rows = slice(None) if rank is None else slice(rank * R // W,
                                                  (rank + 1) * R // W)
    s = s_m[rows].clone().requires_grad_(True)
    loss, center = rec._ibot_loss_chunked(
        state.online, state.ema, t_m[rows], s, w[rows],
        setup["centring"]["extra"]["ibot_center"], TEMP)
    loss.backward()
    return {"loss": loss.item(), "center": center, "grad": s.grad,
            "w": float(w[rows].sum())}


def _worker(rank, setup_path, port, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    _cut()
    setup = torch.load(setup_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=W)
    rows = _images()[rank * B // W:(rank + 1) * B // W]
    out = {case: port_step(case, setup, rows) for case in CASES}
    out["ibot"] = ibot_case(setup, rank)
    torch.save(out, os.path.join(out_dir, f"steps{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the shared state and JAX's steps
# ---------------------------------------------------------------------------

def _flat(arrays):
    """Per-row arrays (B, ...) -> one (B, sum of sizes) f32 array, so that
    they ride in the batch and are sharded with it."""
    return np.concatenate([np.asarray(a, np.float32).reshape(B, -1)
                           for a in arrays], 1)


def _unflat(x, shapes):
    import jax.numpy as jnp

    out, lo = [], 0
    for shape in shapes:
        n = int(np.prod(shape))
        out.append(jnp.reshape(x[:, lo:lo + n], (x.shape[0],) + shape))
        lo += n
    return out


def _setup():
    """Seeded states of both packages, the port's draws (JAX's block
    scores among them) and the global views JAX takes in its batch."""
    import jax
    import jax.numpy as jnp

    from hairci.ssl.dinov2 import DINOv2Recipe as JaxDINOv2
    from hairci.ssl.siameseim import SiameseIMRecipe as JaxSiameseIM
    from hairci_torch.models.convert import (
        dinov2_state_dict_from_jax,
        siameseim_state_dict_from_jax,
    )
    from hairci_torch.models.masking import block_grid
    from hairci_torch.ssl.siameseim import draw_sim_views, \
        sim_two_view_transform
    from test_torch_distill import random_tree

    rng = np.random.default_rng(0)
    images = torch.from_numpy(_images())
    sample = jnp.zeros((B, RAW, RAW, 3), jnp.uint8)
    _, k_mask = jax.random.split(jax.random.key(7))
    setup, jax_in = {}, {}

    jrec = JaxDINOv2(backbone="vit_tiny_patch16", img_size=S,
                     local_size=LOCAL, n_local=N_LOCAL, head_out=HEAD,
                     dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jrec.create_state(jax.random.key(0),
                                                      sample))
    _, coarse = block_grid(jrec.grid, 4)
    scores = torch.from_numpy(np.asarray(jax.random.uniform(
        k_mask, (2 * B, coarse, coarse))))
    rec = _recipe("centring")
    views_draws = rec.transform.draw(torch.Generator().manual_seed(11), B,
                                     RAW, RAW)
    views = rec.transform.apply(images, views_draws)
    jax_in["dino_views"] = _flat(views)
    jax_in["dino_shapes"] = [tuple(v.shape[1:]) for v in views]
    for case in ("centring", "koleo"):
        params = random_tree(shapes.params, rng,
                             1e-5 if case == "centring" else None)
        extra = {k: rng.normal(0, 0.3, v.shape).astype(np.float32)
                 for k, v in shapes.extra.items()}
        jax_in[case] = (params, extra)
        sd = dinov2_state_dict_from_jax(params)
        setup[case] = {"online": sd, "ema": sd,
                       "extra": {k: torch.from_numpy(v)
                                 for k, v in extra.items()},
                       "draws": {"views": views_draws, "scores": scores}}

    jrec = JaxSiameseIM(backbone="vit_tiny_patch16", img_size=S,
                        dtype=jnp.float32, **DEC)
    shapes = jax.eval_shape(lambda: jrec.create_state(jax.random.key(0),
                                                      sample))
    tree = [random_tree(t, rng) for t in (shapes.params, shapes.batch_stats,
                                          shapes.params, shapes.batch_stats)]
    jax_in["siameseim"] = tree
    _, coarse = block_grid(jrec.grid, 4)
    d = draw_sim_views(torch.Generator().manual_seed(13), B, RAW, RAW)
    v1, v2, b1, b2 = sim_two_view_transform(images, d, S)
    jax_in["siam_views"] = _flat([v1, v2, b1, b2])
    jax_in["siam_shapes"] = [tuple(v.shape[1:]) for v in (v1, v2, b1, b2)]
    setup["siameseim"] = {
        "online": siameseim_state_dict_from_jax(*tree[:2]),
        "ema": siameseim_state_dict_from_jax(*tree[2:]),
        "draws": {"views": d, "scores": torch.from_numpy(np.asarray(
            jax.random.uniform(k_mask, (B, coarse, coarse))))}}
    return setup, jax_in


def _jax_references(jax_in):
    """JAX's jitted steps, the state replicated and the batch sharded over
    the 8 devices: loss terms, gradients, the new state as port tensors."""
    import jax
    import jax.numpy as jnp

    import hairci.ssl.siameseim as jax_siam
    from hairci.parallel import (
        batch_sharding,
        create_mesh,
        replicated_sharding,
    )
    from hairci.train.state import TrainState as JaxTrainState
    from hairci_torch.models.convert import (
        dinov2_state_dict_from_jax,
        siameseim_state_dict_from_jax,
    )

    mesh = create_mesh(n_data=8, n_model=1)
    key = jax.random.key(7)

    def batch(x):
        return {"image": jax.device_put(x, batch_sharding(mesh, 2))}

    def dinov2():
        from hairci.ssl.dinov2 import DINOv2Recipe as JaxDINOv2

        jrec = JaxDINOv2(backbone="vit_tiny_patch16", img_size=S,
                         local_size=LOCAL, n_local=N_LOCAL, head_out=HEAD,
                         dtype=jnp.float32)
        jrec.transform = lambda k, x: _unflat(x, jax_in["dino_shapes"])

        def step(state, b, koleo):
            jrec.koleo_weight = koleo      # traced: one compile for both
            return jrec.train_step(state, b, key, teacher_temp=TEMP,
                                   momentum=MOM)

        step = jax.jit(step)
        out = {}
        for case in ("centring", "koleo"):
            params, extra = jax_in[case]
            state = jax.device_put(JaxTrainState(
                step=jnp.zeros((), jnp.int32), params=params,
                batch_stats={}, opt_state=jrec.tx.init(params), tx=jrec.tx,
                ema_params=params, ema_batch_stats={}, extra=extra),
                replicated_sharding(mesh))
            new, aux = jax.device_get(step(state, batch(
                jax_in["dino_views"]), KOLEO[case]))
            out[case] = {
                "metrics": {k: float(v) for k, v in aux.items()},
                "grads": dinov2_state_dict_from_jax(new.neg_indices),
                "state": dinov2_state_dict_from_jax(new.params),
                "ema": dinov2_state_dict_from_jax(new.ema_params),
                "extra": {k: torch.from_numpy(np.asarray(v))
                          for k, v in new.extra.items()}}
        return out

    def siameseim():
        jrec = jax_siam.SiameseIMRecipe(backbone="vit_tiny_patch16",
                                        img_size=S, dtype=jnp.float32, **DEC)
        params, stats, ema, ema_stats = jax_in["siameseim"]
        state = jax.device_put(JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=jrec.tx.init(params), tx=jrec.tx, ema_params=ema,
            ema_batch_stats=ema_stats), replicated_sharding(mesh))
        new, aux = jax.device_get(jax.jit(jrec.train_step)(
            state, batch(jax_in["siam_views"]), key, SIAM_MOM))
        return {"siameseim": {
            "metrics": {"loss": float(aux["loss"])},
            "grads": siameseim_state_dict_from_jax(new.neg_indices, stats),
            "state": siameseim_state_dict_from_jax(new.params,
                                                   new.batch_stats),
            "ema": siameseim_state_dict_from_jax(new.ema_params,
                                                 new.ema_batch_stats)}}

    with pytest.MonkeyPatch.context() as mp:
        orig = JaxTrainState.apply_gradients
        # keep the raw gradients in the state's unused ``neg_indices``
        mp.setattr(JaxTrainState, "apply_gradients",
                   lambda self, grads, **kw: orig(self, grads, **kw).replace(
                       neg_indices=grads))
        mp.setattr(jax_siam, "sim_two_view_transform",
                   lambda k, x, size=224: tuple(_unflat(
                       x, jax_in["siam_shapes"])))
        with ThreadPoolExecutor(2) as pool:
            parts = [pool.submit(dinov2), pool.submit(siameseim)]
            return {**parts[0].result(), **parts[1].result()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        _cut(mp)
        return _runs(tmp_path_factory)


def _runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dpdistill")
    setup, jax_in = _setup()
    setup_path = str(out / "setup.pt")
    torch.save(setup, setup_path)
    ctx = torch.multiprocessing.start_processes(
        _worker, args=(setup_path, _free_port(), str(out)), nprocs=W,
        join=False, start_method="spawn")
    try:
        jax_out = _jax_references(jax_in)
        single = {case: port_step(case, setup, _images()) for case in CASES}
        single["ibot"] = ibot_case(setup)
    finally:
        while not ctx.join():
            pass
    ranks = [torch.load(str(out / f"steps{r}.pt"), weights_only=False)
             for r in range(W)]
    return dict(single=single, jax=jax_out, ranks=ranks)


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

def _ref(runs, case, ref):
    return runs["single" if ref == "one_process" else "jax"][case]


@pytest.mark.parametrize("ref", ["one_process", "jax"])
@pytest.mark.parametrize("case", CASES)
def test_two_ranks_step_matches(runs, case, ref):
    got, want = runs["ranks"][0][case], _ref(runs, case, ref)
    np.testing.assert_allclose(got["metrics"]["loss"],
                               want["metrics"]["loss"], rtol=3e-4, atol=1e-5)
    assert set(got["grads"]) <= set(want["grads"])
    _grads_close(got["grads"], {n: want["grads"][n] for n in got["grads"]},
                 rtol=2e-3)


@pytest.mark.parametrize("ref", ["one_process", "jax"])
@pytest.mark.parametrize("case", ["centring", "koleo"])
def test_two_ranks_dinov2_centres_and_terms_match(runs, case, ref):
    """Both centres (global teacher-logit means; iBOT's a weighted mean
    over the masked tokens of every rank) and each loss term; the KoLeo
    term of the non-degenerate state clear of 0."""
    got, want = runs["ranks"][0][case], _ref(runs, case, ref)
    for key in ("dino_center", "ibot_center"):
        np.testing.assert_allclose(got["extra"][key].numpy(),
                                   want["extra"][key].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    for term in ("dino_loss", "ibot_loss", "koleo_loss"):
        np.testing.assert_allclose(got["metrics"][term],
                                   want["metrics"][term], rtol=3e-4,
                                   atol=1e-6, err_msg=term)
    if case == "koleo":
        assert abs(got["metrics"]["koleo_loss"]) > 1e-3


def test_two_ranks_ibot_weighted_means_match_one_process(runs):
    """iBOT's loss and centre are ratios of sums over every rank's masked
    tokens, not means of the ranks' ratios: with the ranks holding
    different mask counts, the one-process loss (rtol 1e-6) and centre
    (rtol 1e-5), and each rank's rows of the gradient of the sum of both
    ranks' (replicated) losses, W times the one-process gradient, at rtol
    1e-5."""
    one = runs["single"]["ibot"]
    counts = [runs["ranks"][r]["ibot"]["w"] for r in range(W)]
    assert counts[0] != counts[1] and sum(counts) == one["w"]
    R = 2 * B
    for r in range(W):
        got = runs["ranks"][r]["ibot"]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
        np.testing.assert_allclose(got["center"].numpy(),
                                   one["center"].numpy(), rtol=1e-5,
                                   atol=1e-7)
        want = W * one["grad"][r * R // W:(r + 1) * R // W]
        np.testing.assert_allclose(got["grad"].numpy(), want.numpy(),
                                   rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("ref", ["one_process", "jax"])
def test_two_ranks_siameseim_statistics_and_momentum_branch_match(runs, ref):
    """The online PermuteBNs' running statistics over the global batch,
    and the momentum branch (parameters and statistics) after its EMA."""
    got, want = runs["ranks"][0]["siameseim"], _ref(runs, "siameseim", ref)
    running = [n for n in got["state"] if "running" in n]
    assert len(running) == 2 * 2 * 6         # 6 decoder blocks, 2 norms each
    for name in running:
        np.testing.assert_allclose(got["state"][name].numpy(),
                                   want["state"][name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    for name, t in got["ema"].items():
        if name != "decoder_pos":
            np.testing.assert_allclose(t.numpy(), want["ema"][name].numpy(),
                                       rtol=1e-5, atol=1e-6,
                                       err_msg=f"ema {name}")


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_hold_equal_state(runs, case):
    """Parameters, teacher / momentum branch, statistics and centres bit
    for bit on both ranks, with the same metrics; the step went through
    the collectives (KoLeo's gathers among them)."""
    a, b = (runs["ranks"][r][case] for r in range(W))
    assert a["metrics"] == b["metrics"]
    for part in ("state", "ema"):
        for name, t in a[part].items():
            assert torch.equal(t, b[part][name]), f"{part} {name}"
    for key in a["extra"] or {}:
        assert torch.equal(a["extra"][key], b["extra"][key]), key
    gathers = {"centring": 2, "koleo": 2, "siameseim": 0}[case]
    assert a["calls"]["all_gather"] == gathers
    assert a["calls"]["all_reduce"] > 0
    assert runs["single"][case]["calls"] == {"all_gather": 0,
                                             "all_reduce": 0}
