"""Data parallelism of the port (``hairci_torch/parallel``): two gloo ranks
on the CPU compute what one process computes on the global batch, and what
JAX computes under its sharding.

The steps run at the JAX package's own DP-test configuration
(``tests/test_dp_equivalence.py``): ResNet-18 at 32 px, a global batch of
16 uint8 images of 48 px, f32, Adam, from the recipes' own initial weights
(JAX's init at key 0; the EMA teacher a copy, as ``create_state`` makes
it), which go to the port through the converters.
The port draws the SimCLR views for the global batch from one generator;
SHAM's permutation, positive and mask draws are JAX's, from its keys; the
port's views go into JAX's step through its transform. Each rank feeds its
rows ``[8 r, 8 r + 8)`` of the uint8 batch to ``train_step``. Held at
``tests/test_dp_equivalence.py``'s tolerances: the loss at rtol 2e-4 /
atol 1e-5, the update's norm at rtol 1e-3 and its leaf-wise difference
within 1e-3 of that norm; the BN running stats at rtol 1e-5 (atol 1e-5, the
statistics near 0 being sums that cancel); ``neg_indices`` equal (the
near-tie rule would excuse EMA similarities within 1e-5 of each other; none
is, at this size); the parameters of the two ranks equal bit for bit. Adam's first step moves a weight by about lr
times the sign of its gradient, so a gradient within rounding of 0 moves it
by lr one way or the other: from seeded random weights (every gradient
nonzero) the port's update stands 5 % of its norm off JAX's for that
reason alone, while at the init, as in JAX's own test, the zero-initialised
last BN scale of each block leaves the residual branches without gradient
and the updates agree.

The CLI: ``mainpretrain --mode simclr`` on a 16-image manifest, one step of
the global batch, run with two processes and with one (loss at rtol 3e-4,
update at rtol 2e-3, as ``tests/test_multiprocess.py``); then each
checkpoint resumed at the other world size for one more step, held against
a one-process resume of the one-process checkpoint; every mode taken under
``--num_processes 2``, and a batch the ranks do not divide refused. One spawn of two gloo
processes computes every two-rank case; the JAX steps and the one-process
runs are computed in this process meanwhile.
"""

import glob
import json
import os
import socket
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from PIL import Image

from hairci_torch.cli import mainpretrain
from hairci_torch.models.convert import (
    sham_state_dict_from_jax,
    simclr_state_dict_from_jax,
)
from hairci_torch.parallel import collectives
from hairci_torch.ssl.sham import SHAMRecipe
from hairci_torch.ssl.simclr import SimCLRRecipe
from hairci_torch.utils.config import parse_pretrain_args

torch.set_num_threads(1)
B, S, RAW, W = 16, 32, 48, 2
CASES = ["SHAM_warmup", "SHAM_mine", "SHAM_mined", "simclr"]
CLI_FLAGS = ["--mode", "simclr", "--model", "resnet18", "--size", "32",
             "--device", "cpu", "--dtype", "float32", "--batch_size", "16",
             "--num_workers", "0", "--seed", "5"]


def _images():
    rng = np.random.default_rng(3)
    return rng.integers(0, 256, (B, RAW, RAW, 3), dtype=np.uint8)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _recipe(case):
    if case == "simclr":
        return SimCLRRecipe(backbone="resnet18", img_size=S,
                            weight_decay=1e-4)
    return SHAMRecipe(backbone="resnet18", img_size=S, weight_decay=1e-4,
                      num_batches=2, warm_up_epochs=2)


def port_step(case, setup, images):
    """One port step of ``case`` on ``images`` (this rank's rows under a
    process group) from the shared weights; the new state's tensors."""
    rec = _recipe(case)
    state = rec.create_state(0, B, torch.device("cpu"))
    if case == "simclr":
        state.online.load_state_dict(setup["simclr"])
        gen = torch.Generator().manual_seed(7)
        metrics = rec.train_step(state, torch.from_numpy(images), gen)
    else:
        state.online.load_state_dict(setup["online"])
        state.ema.load_state_dict(setup["ema"])
        state.neg_indices.copy_(setup["neg"])
        rec.draw = lambda gen, b, h, w: (
            setup["sham_draws"] if b == B else pytest.fail(f"drew {b}"))
        metrics = rec.train_step(state, torch.from_numpy(images), None,
                                 stage=case.split("_")[1], batch_id=1, k=3)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "state": {k: v.clone() for k, v in
                      state.online.state_dict().items()},
            "neg": None if state.neg_indices is None
            else state.neg_indices.clone(),
            "calls": dict(collectives.calls)}


def _worker(rank, setup_path, ports, out_dir, cli):
    import torch.distributed as dist

    torch.set_num_threads(1)
    setup = torch.load(setup_path, weights_only=False)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{ports[0]}",
                            rank=rank, world_size=W)
    rows = _images()[rank * B // W:(rank + 1) * B // W]
    out = {case: port_step(case, setup, rows) for case in CASES}
    torch.save(out, os.path.join(out_dir, f"steps{rank}.pt"))
    dist.destroy_process_group()
    for name, port, extra in (("two", ports[1], []),
                              ("two_from_one", ports[2], cli["resume_one"])):
        mainpretrain.main(cli["flags"] + extra + [
            "--save_path", os.path.join(out_dir, name),
            "--num_processes", str(W), "--process_index", str(rank),
            "--coordinator", f"localhost:{port}"])


# ---------------------------------------------------------------------------
# the references, computed here while the ranks run
# ---------------------------------------------------------------------------

def _jax_references(setup, np_vars, views, sham_views):
    """JAX's jitted step of each case from the same weights, views and
    draws: the loss and the new state as port state dicts."""
    import jax
    import jax.numpy as jnp

    from hairci.ssl.sham import SHAMRecipe as JaxSHAMRecipe
    from hairci.ssl.simclr import SimCLRRecipe as JaxSimCLRRecipe
    from hairci.train.state import TrainState as JaxTrainState

    zeros = {"image": jnp.zeros((B, RAW, RAW, 3), jnp.uint8)}
    key = jax.random.key(7)
    out = {}
    jrec = JaxSHAMRecipe(backbone="resnet18", img_size=S, weight_decay=1e-4,
                         num_batches=2, warm_up_epochs=2, dtype=jnp.float32)
    jrec.transform = lambda k, images: [jnp.asarray(v) for v in sham_views]
    params, stats, ema_params, ema_stats = np_vars["sham"]
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=jrec.tx.init(params), tx=jrec.tx, ema_params=ema_params,
        ema_batch_stats=ema_stats,
        neg_indices=jnp.asarray(setup["neg"].numpy(), jnp.int32))
    sham_step = jax.jit(jrec.train_step, static_argnames="stage")
    sham_state = state
    jrec = JaxSimCLRRecipe(backbone="resnet18", img_size=S, weight_decay=1e-4,
                           dtype=jnp.float32)
    jrec.transform = lambda k, images: [jnp.asarray(v) for v in views]
    params, stats = np_vars["simclr"]
    simclr_state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params, batch_stats=stats,
        opt_state=jrec.tx.init(params), tx=jrec.tx)
    simclr_step = jax.jit(jrec.train_step)

    def run(case):
        if case == "simclr":
            new, aux = jax.device_get(simclr_step(simclr_state, zeros, key))
            return {"loss": float(aux["loss"]),
                    "state": simclr_state_dict_from_jax(
                        new.params, new.batch_stats, "resnet18")}
        new, aux = jax.device_get(sham_step(
            sham_state, zeros, key, stage=case.split("_")[1], batch_id=1,
            k=3))
        return {"loss": float(aux["loss"]),
                "state": sham_state_dict_from_jax(new.params,
                                                  new.batch_stats),
                "neg": torch.from_numpy(np.asarray(new.neg_indices))}

    # the four compiles, ~10 s each, run side by side
    with ThreadPoolExecutor(len(CASES)) as pool:
        return dict(zip(CASES, pool.map(run, CASES)))


def _shared_setup():
    """Seeded weights (numpy for JAX, state dicts for the port), the port's
    view draws and JAX's SHAM draws, and the global views each gets."""
    import jax
    import jax.numpy as jnp

    from hairci.ssl.sham import SHAMRecipe as JaxSHAMRecipe
    from hairci.ssl.simclr import SimCLRRecipe as JaxSimCLRRecipe

    def init(module):
        """The recipe's own initial weights (``create_state``'s init at
        key 0, jitted: eager init takes ~20 s a ResNet here)."""
        v = jax.device_get(jax.jit(lambda key: module.init(
            key, jnp.zeros((B, S, S, 3)), train=True))(jax.random.key(0)))
        return v["params"], v["batch_stats"]

    with ThreadPoolExecutor(2) as pool:
        sham, simclr = pool.map(init, [
            JaxSHAMRecipe(backbone="resnet18", img_size=S).module,
            JaxSimCLRRecipe(backbone="resnet18", img_size=S,
                            dtype=jnp.float32).module])
    sham = sham * 2
    neg = torch.from_numpy(np.stack([np.roll(np.arange(B), 1),
                                     np.roll(np.arange(B), 5)]))

    def t(a):
        return torch.from_numpy(np.array(a))

    # SHAM's draws inside the step, from JAX's keys (tests/test_torch_sham.py)
    _, k_neg, k_pt, k_mask = jax.random.split(jax.random.key(7), 4)
    k1, k2 = jax.random.split(k_pt)
    k_ratio, k_score = jax.random.split(k_mask)
    rec = _recipe("SHAM_warmup")
    images = torch.from_numpy(_images())
    sham_draws = {
        "views": rec.transform.draw(torch.Generator().manual_seed(11), B,
                                    RAW, RAW),
        "perm": t(jax.random.permutation(k_neg, B)).long(),
        "positive": {
            "theta": t(jax.random.uniform(k1, (B,), minval=-15.0,
                                          maxval=15.0) * (np.pi / 180)),
            "sigma": t(jax.random.uniform(jax.random.split(k2)[1], (B,),
                                          minval=0.1, maxval=0.5))},
        "mask": {"ratio": t(jax.random.uniform(k_ratio, (B,), minval=0.1,
                                               maxval=0.5)),
                 "scores": t(jax.random.uniform(k_score, (B, 1)))},
    }
    setup = {
        "online": sham_state_dict_from_jax(*sham[:2]),
        "ema": sham_state_dict_from_jax(*sham[2:]),
        "simclr": simclr_state_dict_from_jax(*simclr, "resnet18"),
        "neg": neg, "sham_draws": sham_draws}
    simclr_views = _recipe("simclr").transform.apply(
        images, _recipe("simclr").draw(torch.Generator().manual_seed(7), B,
                                       RAW, RAW)["views"])
    sham_views = rec.transform.apply(images, sham_draws["views"])
    return setup, {"sham": sham, "simclr": simclr}, \
        [v.numpy() for v in simclr_views], [v.numpy() for v in sham_views]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("dpdata")
    (root / "images").mkdir()
    rng = np.random.default_rng(5)
    rows = ["id,class"]
    for i in range(16):
        name = f"{i:06d}_hair.png"
        Image.fromarray(rng.integers(0, 256, (48, 40, 3), dtype=np.uint8)
                        ).save(root / "images" / name)
        rows.append(f"{name},{i % 4}")
    (root / "train.csv").write_text("\n".join(rows) + "\n")
    return ["--train_annotation", str(root / "train.csv"), "--img_dir",
            str(root / "images")]


def _cli_run(flags, save_path, *extra):
    return mainpretrain.main(flags + list(extra) + ["--save_path", save_path])


def _ckpt(save_path):
    (path,) = glob.glob(os.path.join(save_path, "*", "model_ckpt_latest"))
    return path


def _run_out(save_path):
    """The last epoch's loss, the online weights and the run's folder."""
    run = os.path.dirname(_ckpt(save_path))
    with open(os.path.join(run, "metrics.jsonl")) as f:
        loss = json.loads(f.read().splitlines()[-1])["loss"]
    ckpt = torch.load(_ckpt(save_path), weights_only=True)
    return {"loss": loss, "online": ckpt["online"], "epoch": ckpt["epoch"],
            "run": run}


@pytest.fixture(scope="module")
def runs(dataset, tmp_path_factory):
    out = tmp_path_factory.mktemp("dp")
    flags = CLI_FLAGS + dataset
    setup, np_vars, views, sham_views = _shared_setup()
    setup_path = str(out / "setup.pt")
    torch.save(setup, setup_path)
    # the one-process CLI run first: the ranks resume from its checkpoint
    _cli_run(flags + ["--epochs", "1"], str(out / "one"))
    resume_one = ["--epochs", "2", "--continue_training",
                  "--checkpoint_folder", _run_out(str(out / "one"))["run"]]
    ctx = torch.multiprocessing.start_processes(
        _worker, args=(setup_path, [_free_port() for _ in range(3)],
                       str(out), {"flags": flags + ["--epochs", "1"],
                                  "resume_one": resume_one}),
        nprocs=W, join=False, start_method="spawn")
    single = {case: port_step(case, setup, _images()) for case in CASES}
    jax_out = _jax_references(setup, np_vars, views, sham_views)
    _cli_run(flags, str(out / "one_from_one"), *resume_one)
    while not ctx.join():
        pass
    two = _run_out(str(out / "two"))
    _cli_run(flags, str(out / "one_from_two"), "--epochs", "2",
             "--continue_training", "--checkpoint_folder", two["run"])
    ranks = [torch.load(str(out / f"steps{r}.pt"), weights_only=False)
             for r in range(W)]
    cli = {name: _run_out(str(out / name)) for name in
           ("one", "two", "one_from_one", "one_from_two", "two_from_one")}
    return dict(setup=setup, single=single, jax=jax_out, ranks=ranks,
                cli=cli)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

def _params(sd):
    return {k: v for k, v in sd.items() if "running" not in k}


def _update_close(start, got, want):
    """test_dp_equivalence's rule: update norms at rtol 1e-3, and the
    leaf-wise difference within 1e-3 of the reference update's norm."""
    names = list(_params(start))
    d_got = float(np.sqrt(sum(float(((got[n] - start[n]).double() ** 2)
                                    .sum()) for n in names)))
    d_want = float(np.sqrt(sum(float(((want[n] - start[n]).double() ** 2)
                                     .sum()) for n in names)))
    np.testing.assert_allclose(d_got, d_want, rtol=1e-3)
    diff = float(np.sqrt(sum(float(((got[n] - want[n]).double() ** 2).sum())
                             for n in names)))
    assert diff <= 1e-3 * max(d_want, 1e-8), f"updates diverged: {diff}"


def _start(runs, case):
    s = runs["setup"]
    return s["simclr"] if case == "simclr" else s["online"]


@pytest.mark.parametrize("ref", ["one_process", "jax"])
@pytest.mark.parametrize("case", CASES)
def test_two_ranks_step_matches(runs, case, ref):
    got = runs["ranks"][0][case]
    want = runs["single"][case] if ref == "one_process" else runs["jax"][case]
    want_loss = (want["metrics"]["loss"] if ref == "one_process"
                 else want["loss"])
    np.testing.assert_allclose(got["metrics"]["loss"], want_loss, rtol=2e-4,
                               atol=1e-5)
    _update_close(_start(runs, case), got["state"], want["state"])
    for name, t in got["state"].items():
        if "running" in name:
            np.testing.assert_allclose(t.numpy(), want["state"][name].numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_metrics_match_one_process(runs, case):
    """Every logged metric is the global batch's (SHAM's distances and
    violations too), the same on both ranks."""
    got = [runs["ranks"][r][case]["metrics"] for r in range(W)]
    assert got[0] == got[1]
    want = runs["single"][case]["metrics"]
    assert set(got[0]) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[0][k], v, rtol=2e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_two_ranks_hold_equal_parameters(runs, case):
    a, b = (runs["ranks"][r][case] for r in range(W))
    for name, t in a["state"].items():
        assert torch.equal(t, b["state"][name]), name
    if a["neg"] is not None:
        assert torch.equal(a["neg"], b["neg"])
    # the step went through the collectives
    assert a["calls"]["all_gather"] > 0 and a["calls"]["all_reduce"] > 0
    assert runs["single"][case]["calls"] == {"all_gather": 0,
                                             "all_reduce": 0}


@pytest.mark.parametrize("ref", ["one_process", "jax"])
def test_mined_indices_are_global(runs, ref):
    """The mine stage's k-th neighbours over the all-gathered EMA features:
    global indices, the one-process run's and JAX's (no near-tie at this
    size: equal outright)."""
    got = runs["ranks"][0]["SHAM_mine"]["neg"]
    want = runs["single" if ref == "one_process" else "jax"]["SHAM_mine"][
        "neg"]
    assert torch.equal(got, want.long())
    # the mined stage kept the cache it was given
    assert torch.equal(runs["ranks"][0]["SHAM_mined"]["neg"],
                       runs["setup"]["neg"])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _update_norm(a, b):
    return float(np.sqrt(sum(float(((a[n] - b[n]).double() ** 2).sum())
                             for n in _params(a))))


def test_cli_two_processes_match_one(runs):
    one, two = runs["cli"]["one"], runs["cli"]["two"]
    rec = SimCLRRecipe(backbone="resnet18", img_size=S)
    start = rec.create_state(5, B, torch.device("cpu")).online.state_dict()
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=3e-4, atol=1e-5)
    np.testing.assert_allclose(_update_norm(two["online"], start),
                               _update_norm(one["online"], start), rtol=2e-3)
    # rank 0 alone wrote the run's log: one epoch, one line
    with open(os.path.join(two["run"], "metrics.jsonl")) as f:
        assert len(f.read().splitlines()) == 1


@pytest.mark.parametrize("resumed", ["one_from_two", "two_from_one"])
def test_cli_checkpoint_restores_across_world_sizes(runs, resumed):
    """A checkpoint written at one world size resumes at the other: the
    second epoch's step matches a one-process resume of the one-process
    checkpoint."""
    got, want = runs["cli"][resumed], runs["cli"]["one_from_one"]
    first = runs["cli"]["two" if resumed == "one_from_two" else "one"]
    assert got["epoch"] == want["epoch"] == 1
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=3e-4,
                               atol=1e-5)
    np.testing.assert_allclose(
        _update_norm(got["online"], first["online"]),
        _update_norm(want["online"], runs["cli"]["one"]["online"]),
        rtol=2e-3)


@pytest.mark.parametrize("mode", mainpretrain.PORTED_MODES)
def test_cli_takes_every_mode_on_several_processes(mode):
    """Every mode's step is the global batch's: none is refused under
    --num_processes 2 (the check runs before the rendezvous)."""
    args = parse_pretrain_args(CLI_FLAGS + [
        "--mode", mode, "--num_processes", "2", "--process_index", "0",
        "--coordinator", "localhost:1"])
    mainpretrain.check_data_parallel(args)
    assert not collectives.active()


@pytest.mark.parametrize("flags,says", [
    (["--batch_size", "15"], "W=2"),
])
def test_cli_refuses_what_is_not_global(dataset, tmp_path, flags, says):
    """Under --num_processes 2 a batch the ranks do not divide exits before
    the rendezvous, naming W."""
    with pytest.raises(SystemExit) as e:
        mainpretrain.main(CLI_FLAGS + dataset + flags + [
            "--epochs", "1", "--save_path", str(tmp_path),
            "--num_processes", "2", "--process_index", "0",
            "--coordinator", "localhost:1"])
    assert says in str(e.value)
    assert not collectives.active()


def test_cli_model_shards_need_the_processes(dataset, tmp_path):
    """As JAX's mesh, a model axis larger than the world is refused."""
    with pytest.raises(ValueError, match="not divisible by n_model=2"):
        mainpretrain.main(CLI_FLAGS + dataset + [
            "--epochs", "1", "--save_path", str(tmp_path),
            "--n_model_shards", "2"])
