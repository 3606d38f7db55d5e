"""SupCon, BYOL and DenseCL under data parallelism: two gloo ranks on the
CPU compute what one process computes on the global batch, and what JAX's
jitted step computes with the batch sharded over the 8 virtual CPU devices
``tests/conftest.py`` forces.

Both packages' ResNet-18 is cut to one block a stage (the cut of
``tests/test_torch_byol.py``, ``test_torch_densecl.py`` and
``test_torch_supcon.py``; the CIFAR stem for SupCon), f32, with the full
heads; the global batch is 16 uint8 images of 48 px, BYOL's views 32 px.
SupCon's views are 8 px: its CIFAR stem keeps layer1 at the view's size,
and at 32 px (32,768 BN rows) the port's own two-rank and one-process
gradients part by 1.6e-3 of their norm, at 16 px JAX's layer1 gradients
lie 1.1e-3 of the norm off both (XLA:CPU's f32 BN sums, the chaos ROADMAP
records), while at 8 px (2,048 rows) all three agree within 3.7e-6.
DenseCL's views are 64 px, so that its last map is a 2 x 2 grid and each
query position has other key positions to be matched with (at 32 px the
grid is one position). SupCon's labels repeat across the two halves of the
batch, so that every rank's anchors have positives on the other rank, and
one label stands alone. DenseCL takes two steps with banks of 24 rows: the
first fills rows 0-15 with the global batch's keys, the second reads them
(rank 0's queries meet rank 1's keys) and wraps the ring (rows 16-23, then
0-7); its learning rate is 0, so that the second step's gradients are
taken at the same weights in every run (Adam's first step moves a weight
by about lr times the sign of its gradient, and rounding noise on a
gradient that is truly 0 would part the runs by 2 lr before the second
step); its momentum branch still follows the online one, and its BN
statistics still move. BYOL and DenseCL momenta 0.9 (and 0.95), so that
the EMA shows.

The weights are seeded random values (``tests/test_torch_distill.py``'s
``random_tree``), the momentum branches apart from the online ones. The
port draws the views for the global batch from one generator; JAX gets them
(and SupCon's labels) through its batch, so that they are sharded with it.
Each rank feeds its rows ``[8 r, 8 r + 8)`` (and their labels) to
``train_step``.

Held at ``tests/test_dp_equivalence.py``'s tolerances for a step compared
through its gradients (``tests/test_torch_dp_distill.py``): the loss (and
DenseCL's two terms) at rtol 3e-4 / atol 1e-5; the gradients the optimizer
receives, the mean over the ranks, by their norm at rtol 2e-3 and leaf-wise
within 2e-3 of that norm; the BN running statistics and the momentum
branches at rtol 1e-5 / atol 1e-6; DenseCL's banks and pointers at rtol
1e-5 / atol 1e-6; and the parameters, statistics, momentum branches and
banks of the two ranks bit for bit. Measured here, the norm of the
difference between the two ranks' averaged gradients and either
reference's is at most 3.7e-6 (SupCon), 3.0e-6 (BYOL) and 2.2e-6 (DenseCL)
of the reference's norm. One spawn of two gloo processes computes every
two-rank case; JAX's three compiles run side by side in threads meanwhile.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from hairci_torch.parallel import collectives
from test_torch_dp import _free_port, _images
from test_torch_dp_distill import _flat, _unflat
from test_torch_dp_vit import _grads_close

torch.set_num_threads(1)
B, S, S_SUPCON, S_DENSE, RAW, W, M = 16, 32, 8, 64, 48, 2, 24
LABELS = np.array([0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 7])
MOMENTA = {"byol": (0.9,), "densecl": (0.9, 0.95)}
CASES = ["supcon", "byol", "densecl_1", "densecl_2"]
EXTRA = ("bank_g", "ptr_g", "bank_l", "ptr_l")


def _cut(mp=None):
    """Both packages' ResNet-18 to one block a stage through the
    monkeypatch ``mp``; without one, the port's alone (a spawned rank)."""
    import hairci_torch.models.resnet as port_resnet

    if mp is None:
        port_resnet._STAGES["resnet18"] = ([1, 1, 1, 1],
                                           port_resnet.BasicBlock)
        return
    import hairci.models.resnet as jax_resnet

    for resnet in (port_resnet, jax_resnet):
        mp.setitem(resnet._STAGES, "resnet18",
                   ([1, 1, 1, 1], resnet.BasicBlock))


def _recipe(name, jax=False):
    """The port's recipe of ``name``, or JAX's."""
    if jax:
        import jax.numpy as jnp

        from hairci.ssl import build_recipe
        dtype = jnp.float32
    else:
        from hairci_torch.ssl import build_recipe
        dtype = torch.float32
    kw = dict(backbone="resnet18", weight_decay=1e-4, dtype=dtype)
    if name == "supcon":
        return build_recipe("simclr_supcon", img_size=S_SUPCON, **kw)
    if name == "byol":
        return build_recipe("BYOL", img_size=S, **kw)
    return build_recipe("DenseCL", img_size=S_DENSE, bank_size=M,
                        learning_rate=0.0, **kw)


def _converter(name):
    from hairci_torch.models import convert

    fn = {"supcon": convert.supcon_state_dict_from_jax,
          "byol": convert.byol_state_dict_from_jax,
          "densecl": convert.densecl_state_dict_from_jax}[name]
    return lambda params, stats: fn(params, stats, "resnet18")


def _out(metrics, state):
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone()
                      for n, p in state.online.named_parameters()},
            "state": {k: v.clone() for k, v in
                      state.online.state_dict().items()},
            "ema": None if state.ema is None else {
                k: v.clone() for k, v in state.ema.state_dict().items()},
            "extra": {k: v.clone() for k, v in (state.extra or {}).items()},
            "calls": dict(collectives.calls)}


def port_steps(setup, images, labels):
    """Every case's step on ``images`` / ``labels`` (this rank's rows under
    a process group) from the shared state."""
    out = {}
    for name in ("supcon", "byol", "densecl"):
        rec = _recipe(name)
        state = rec.create_state(0, B, torch.device("cpu"))
        s = setup[name]
        state.online.load_state_dict(s["online"], strict=True)
        if state.ema is not None:
            state.ema.load_state_dict(s["ema"], strict=True)
        x = torch.from_numpy(images)
        for i, draws in enumerate(s["draws"]):
            rec.draw = lambda gen, b, h, w, d=draws: (
                d if b == B else pytest.fail(f"drew {b}"))
            collectives.calls.update(all_gather=0, all_reduce=0)
            if name == "supcon":
                m = rec.train_step(state, x, None,
                                   labels=torch.from_numpy(labels))
            else:
                m = rec.train_step(state, x, None,
                                   momentum=MOMENTA[name][i])
            case = name if name != "densecl" else f"densecl_{i + 1}"
            out[case] = _out(m, state)
    return out


def _worker(rank, setup_path, port, out_dir):
    import torch.distributed as dist

    torch.set_num_threads(1)
    _cut()
    setup = torch.load(setup_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=W)
    rows = slice(rank * B // W, (rank + 1) * B // W)
    out = port_steps(setup, _images()[rows], LABELS[rows])
    torch.save(out, os.path.join(out_dir, f"steps{rank}.pt"))
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the shared state and JAX's steps
# ---------------------------------------------------------------------------

def _setup():
    """Seeded states of both packages, the port's draws and the global
    views JAX takes in its batch."""
    import jax
    import jax.numpy as jnp

    from test_torch_distill import random_tree

    rng = np.random.default_rng(0)
    images = torch.from_numpy(_images())
    sample = jnp.zeros((B, RAW, RAW, 3), jnp.uint8)
    setup, jax_in = {}, {}
    for name, seeds in (("supcon", (11,)), ("byol", (12,)),
                        ("densecl", (13, 14))):
        jrec = _recipe(name, jax=True)
        shapes = jax.eval_shape(lambda: jrec.create_state(jax.random.key(0),
                                                          sample))
        trees = [random_tree(shapes.params, rng),
                 random_tree(shapes.batch_stats, rng)]
        if name != "supcon":
            trees += [random_tree(shapes.params, rng),
                      random_tree(shapes.batch_stats, rng)]
        rec = _recipe(name)
        draws = [rec.draw(torch.Generator().manual_seed(seed), B, RAW, RAW)
                 for seed in seeds]
        views = [rec.transform.apply(images, d["views"]) for d in draws]
        jax_in[name] = {"trees": trees, "views": [_flat(v) for v in views],
                        "shapes": [tuple(v.shape[1:]) for v in views[0]]}
        sd = _converter(name)
        setup[name] = {"online": sd(*trees[:2]), "draws": draws,
                       "ema": sd(*trees[2:]) if name != "supcon" else None}
    return setup, jax_in


def _jax_references(jax_in):
    """JAX's jitted steps, the state replicated and the batch sharded over
    the 8 devices: metrics, gradients, the new state as port tensors."""
    import jax
    import jax.numpy as jnp

    from hairci.parallel import (
        batch_sharding,
        create_mesh,
        replicated_sharding,
    )
    from hairci.train.state import TrainState as JaxTrainState

    mesh = create_mesh(n_data=8, n_model=1)
    key = jax.random.key(7)

    def run(name):
        jrec = _recipe(name, jax=True)
        j = jax_in[name]
        shapes = jax.eval_shape(lambda: jrec.create_state(
            jax.random.key(0), jnp.zeros((B, RAW, RAW, 3), jnp.uint8)))
        jrec.transform = lambda k, x: _unflat(x, j["shapes"])
        params, stats = j["trees"][:2]
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
            opt_state=jrec.tx.init(params), tx=jrec.tx)
        if name != "supcon":
            state = state.replace(
                ema_params=j["trees"][2], ema_batch_stats=j["trees"][3],
                # the gradients' tree, so that both steps trace alike
                neg_indices=jax.tree_util.tree_map(np.zeros_like, params))
        if name == "densecl":
            state = state.replace(extra=jax.tree_util.tree_map(
                lambda s: np.zeros(s.shape, s.dtype), shapes.extra))
        state = jax.device_put(state, replicated_sharding(mesh))
        step = jax.jit(jrec.train_step)
        sd = _converter(name)
        out = {}
        for i, views in enumerate(j["views"]):
            batch = {"image": jax.device_put(views, batch_sharding(mesh, 2))}
            if name == "supcon":
                batch["label"] = jax.device_put(
                    jnp.asarray(LABELS, jnp.int32), batch_sharding(mesh, 1))
                state, aux = step(state, batch, key)
            else:
                state, aux = step(state, batch, key, MOMENTA[name][i])
            new, aux = jax.device_get((state, aux))
            out[name if name != "densecl" else f"densecl_{i + 1}"] = {
                "metrics": {k: float(v) for k, v in aux.items()},
                "grads": sd(new.neg_indices, stats),
                "state": sd(new.params, new.batch_stats),
                "ema": (sd(new.ema_params, new.ema_batch_stats)
                        if name != "supcon" else None),
                "extra": {k: torch.from_numpy(np.asarray(v))
                          for k, v in (new.extra or {}).items()}}
        return out

    with pytest.MonkeyPatch.context() as mp:
        orig = JaxTrainState.apply_gradients
        # keep the raw gradients in the state's unused ``neg_indices``
        mp.setattr(JaxTrainState, "apply_gradients",
                   lambda self, grads, **kw: orig(self, grads, **kw).replace(
                       neg_indices=grads))
        with ThreadPoolExecutor(3) as pool:
            parts = list(pool.map(run, ["supcon", "byol", "densecl"]))
    return {k: v for part in parts for k, v in part.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        _cut(mp)
        return _runs(tmp_path_factory)


def _runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("dpzoo")
    setup, jax_in = _setup()
    setup_path = str(out / "setup.pt")
    torch.save(setup, setup_path)
    ctx = torch.multiprocessing.start_processes(
        _worker, args=(setup_path, _free_port(), str(out)), nprocs=W,
        join=False, start_method="spawn")
    try:
        jax_out = _jax_references(jax_in)
        single = port_steps(setup, _images(), LABELS)
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


def _stats_close(got, want, what):
    for name, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=f"{what} {name}")


@pytest.mark.parametrize("ref", ["one_process", "jax"])
@pytest.mark.parametrize("case", CASES)
def test_two_ranks_step_matches(runs, case, ref):
    """The loss and every term, and the averaged gradients."""
    got, want = runs["ranks"][0][case], _ref(runs, case, ref)
    assert set(got["metrics"]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=3e-4,
                                   atol=1e-5, err_msg=k)
    assert set(got["grads"]) <= set(want["grads"])
    _grads_close(got["grads"], {n: want["grads"][n] for n in got["grads"]},
                 rtol=2e-3)


@pytest.mark.parametrize("ref", ["one_process", "jax"])
@pytest.mark.parametrize("case", CASES)
def test_two_ranks_statistics_and_momentum_branch_match(runs, case, ref):
    """The online BN running statistics over the global batch (the trunk's
    and the heads'), and the momentum branch, parameters and statistics,
    after its EMA."""
    got, want = runs["ranks"][0][case], _ref(runs, case, ref)
    running = {n: t for n, t in got["state"].items() if "running" in n}
    heads = [n for n in running if "head" in n]
    # BYOL's projection and prediction heads hold a BN each
    assert len(heads) == (4 if case == "byol" else 0)
    _stats_close(running, want["state"], "running")
    if got["ema"] is not None:
        _stats_close(got["ema"], want["ema"], "ema")


@pytest.mark.parametrize("ref", ["one_process", "jax"])
@pytest.mark.parametrize("step", [1, 2])
def test_two_ranks_densecl_banks_match(runs, step, ref):
    """Both banks hold the global batch's keys in rank order, and the
    pointers moved by the global batch: 16 after the first step, 8 after
    the second, which wrapped."""
    got = runs["ranks"][0][f"densecl_{step}"]["extra"]
    want = _ref(runs, f"densecl_{step}", ref)["extra"]
    for key in EXTRA:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=key)
    assert int(got["ptr_g"]) == int(got["ptr_l"]) == (16 if step == 1 else 8)
    filled = got["bank_g"].abs().sum(1) > 0
    assert int(filled.sum()) == (16 if step == 1 else M)


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_hold_equal_state(runs, case):
    """Parameters, statistics, momentum branch and banks bit for bit on
    both ranks, with the same metrics; the step went through the
    collectives: SupCon gathers its views and its labels, DenseCL its two
    kinds of keys, BYOL nothing (its means and BN sums are all-reduced)."""
    a, b = (runs["ranks"][r][case] for r in range(W))
    assert a["metrics"] == b["metrics"]
    for part in ("state", "ema", "extra"):
        for name, t in (a[part] or {}).items():
            assert torch.equal(t, b[part][name]), f"{part} {name}"
    gathers = {"supcon": 2, "byol": 0}.get(case, 2)
    assert a["calls"]["all_gather"] == gathers
    assert a["calls"]["all_reduce"] > 0
    assert runs["single"][case]["calls"] == {"all_gather": 0,
                                             "all_reduce": 0}


def test_sharded_loader_hands_each_rank_its_labels(tmp_path):
    """SupCon's labels come with the images: each shard of the loader
    yields its rows of the one-process batch and their labels."""
    from PIL import Image

    from hairci_torch.data import DataLoader, load_manifest

    rng = np.random.default_rng(5)
    rows = ["id,class"]
    for i in range(12):
        name = f"{i:06d}_hair.png"
        Image.fromarray(rng.integers(0, 256, (20, 16, 3), dtype=np.uint8)
                        ).save(tmp_path / name)
        rows.append(f"{name},{'abcde'[i % 5]}")
    (tmp_path / "train.csv").write_text("\n".join(rows) + "\n")
    manifest = load_manifest(str(tmp_path / "train.csv"), str(tmp_path))

    def batches(**kw):
        return list(DataLoader(manifest, batch_size=8, size=16, seed=3,
                               shuffle=True, pad_last=True, num_workers=0,
                               mode="raw_resize", **kw))

    whole = batches()
    shards = [batches(shard_index=r, shard_count=W) for r in range(W)]
    assert len(whole) == 2
    for i, (images, labels) in enumerate(whole):
        got = [shard[i] for shard in shards]
        np.testing.assert_array_equal(
            np.concatenate([g[0] for g in got]), images)
        np.testing.assert_array_equal(
            np.concatenate([g[1] for g in got]), labels)
        assert len(set(labels.tolist())) > 1
