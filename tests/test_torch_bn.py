"""The port's BatchNorm statistics: the bn_stats twin against the JAX Pallas
kernel ``tools/bn_stats_bench.py:pallas_stats`` in interpret mode, the
port's ``BatchNorm`` against ``hairci.models.norm.BatchNorm`` (output,
running stats, gradients), and the CUDA kernel against its twin on a card."""

import importlib.util
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairci_torch.models.norm import BatchNorm
from hairci_torch.ops.bn_stats import (
    BNStats,
    bn_stats,
    bn_stats_reference,
    plan,
    vector_width,
)
from hairci_torch.ops import bn_stats as bn_mod

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _bench_tool():
    spec = importlib.util.spec_from_file_location(
        "bn_stats_bench", REPO / "tools" / "bn_stats_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_twin_matches_pallas_interpret(dtype):
    tool = _bench_tool()
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 2.0, size=(2 * tool.BLOCK_M, 24)).astype(np.float32)
    xj = jnp.asarray(x, dtype=dtype)
    orig = tool.pl.pallas_call
    interp = lambda *a, **k: orig(*a, **{**k, "interpret": True})  # noqa: E731
    with mock.patch.object(tool.pl, "pallas_call", interp):
        pm, pv = tool.pallas_stats(xj)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32)))
    xt = xt.to(getattr(torch, dtype))
    s, sq = bn_stats(xt)
    n = x.shape[0]
    mean = s / n
    var = sq / n - mean * mean
    # the tool's own tolerances (bn_stats_bench.py:122-125)
    np.testing.assert_allclose(mean.numpy(), np.asarray(pm), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(var.numpy(), np.asarray(pv), rtol=1e-3,
                               atol=1e-3)


def test_wrapper_checks_and_cpu_path():
    x = torch.randn(10, 4)
    before = bn_stats.launches
    s, sq = bn_stats(x)
    assert bn_stats.launches == before  # the twin is no launch
    torch.testing.assert_close(s, x.sum(0))
    torch.testing.assert_close(sq, (x * x).sum(0))
    with pytest.raises(ValueError, match="dtype"):
        bn_stats(x.double())
    with pytest.raises(ValueError, match="contiguous"):
        bn_stats(torch.randn(4, 10).T)
    with pytest.raises(ValueError, match="shape"):
        bn_stats(torch.randn(2, 3, 4))


def test_bnstats_gradient_is_the_formula():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(7, 3, generator=gen).requires_grad_()
    gs, gq = torch.randn(3, generator=gen), torch.randn(3, generator=gen)
    s, sq = BNStats.apply(x)
    (s * gs + sq * gq).sum().backward()
    ref = x.detach().clone().requires_grad_()
    rs, rq = bn_stats_reference(ref)
    (rs * gs + rq * gq).sum().backward()
    torch.testing.assert_close(x.grad, ref.grad, rtol=1e-6, atol=1e-6)


def _blocks(M, C, vec, sm_count=132):
    """The launch ``plan`` gives: (blocks, row lanes, channel tiles, splits,
    rows per split)."""
    log_tg, splits, rows = plan(M, C, vec, sm_count)
    tiles = -(-(-(-C // vec)) // (1 << log_tg))
    return tiles * splits, bn_mod.THREADS >> log_tg, tiles, splits, rows


def test_plan_fills_the_card():
    # the tool's shape in bf16: tiles of 8 groups of 8 channels (one
    # 128-byte line of a row), about 4 blocks per SM of 132
    blocks, lanes, tiles, splits, rows = _blocks(512 * 56 * 56, 256, 8)
    assert tiles == 4 and lanes == 32
    assert 2 * 132 <= blocks <= 4 * 132 and splits * rows >= 512 * 56 * 56
    # wide C makes channel tiles, not more partials per channel
    blocks, _, tiles, splits, _ = _blocks(9408, 2048, 8)
    assert tiles == 32 and 132 <= blocks <= 4 * 132 and splits <= 18
    # no 16-byte loads: a warp on 32 neighbouring channels of one row
    _, lanes, tiles, _, _ = _blocks(100_000, 100, 1)
    assert lanes == 8 and tiles == 4
    # the head's (192, 2048), bf16 in the bf16 run and f32 in the f32 one:
    # one stage, and still a block for every other SM or more
    for vec in (8, 4):
        blocks, _, tiles, splits, rows = _blocks(192, 2048, vec)
        assert (splits, rows) == (1, 192) and blocks == tiles >= 32


def _resnet50_bn_shapes(rows, size):
    """(M, C) of every train-mode BN input of a ResNet-50 forward over
    ``rows`` images of ``size`` px, then the projection head's two."""
    out, hw = [(rows * (size // 2) ** 2, 64)], size // 4
    for i, n_blocks in enumerate((3, 4, 6, 3)):
        f = 64 * 2 ** i
        for j in range(n_blocks):
            out.append((rows * hw * hw, f))              # bn1, before stride
            if i > 0 and j == 0:
                hw //= 2
            out += [(rows * hw * hw, f), (rows * hw * hw, 4 * f)]
            if j == 0:
                out.append((rows * hw * hw, 4 * f))      # downsample
    return out + [(rows, 2048), (rows, 1024)]


_STEP_SHAPES = sorted(set(_resnet50_bn_shapes(192, 224)))


def test_the_step_has_55_bn_inputs_of_14_shapes():
    shapes = _resnet50_bn_shapes(192, 224)
    assert len(shapes) == 55 and len(_STEP_SHAPES) == 14
    assert min(_STEP_SHAPES) == (192, 1024)
    assert max(_STEP_SHAPES) == (192 * 112 * 112, 64)


@pytest.mark.parametrize("vec", [8, 4, 1])
@pytest.mark.parametrize("shape", _STEP_SHAPES + [(1000, 7), (3, 64),
                                                  (100_000, 64), (1, 1)])
def test_plan_covers_every_row_once(shape, vec):
    M, C = shape
    if C % vec:
        vec = 1
    log_tg, splits, rows = plan(M, C, vec, 132)
    tg = 1 << log_tg
    assert 0 <= log_tg <= 5 and bn_mod.THREADS % tg == 0
    # the splits partition [0, M): each non-empty, none beyond M
    assert 1 <= splits <= 65535 and rows >= 1
    assert (splits - 1) * rows < M <= splits * rows
    # the channel tiles cover every group of ``vec`` channels, the last tile
    # is not empty, and a tile never holds more than 256 channels (one
    # thread adds one channel's lanes)
    groups = -(-C // vec)
    tiles = -(-groups // tg)
    assert (tiles - 1) * tg < groups <= tiles * tg and tg * vec <= 256
    small = M * C <= 1 << 19
    if small:
        # the head's and smaller: one stage, no partials
        assert splits == 1
    else:
        # every block makes a few loop turns and the card is not flooded
        assert tiles * splits <= 4 * 132 + tiles
        if splits > 1:
            assert rows >= 2 * bn_mod.UNROLL * (bn_mod.THREADS // tg)
    if (M, C) in ((192, 2048), (192, 1024)):
        assert small


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_vector_width_needs_aligned_rows(dtype):
    size = torch.empty(0, dtype=dtype).element_size()
    wide = 16 // size
    assert vector_width(64, size, 0) == wide
    assert vector_width(2048, size, 4096) == wide
    # a row that does not start on a 16-byte boundary: C or the pointer
    assert vector_width(wide + 1, size, 0) == 1
    assert vector_width(wide // 2, size, 0) == 1
    assert vector_width(64, size, 16 + size) == 1
    assert vector_width(64, size, 8) == 1
    x = torch.zeros(64 * 32 + wide, dtype=dtype)
    assert vector_width(32, size, x.data_ptr()) == wide
    assert vector_width(32, size, x[1:].data_ptr()) == 1
    assert vector_width(32, size, x[wide:].data_ptr()) == wide


@pytest.mark.parametrize("shape", [(2, 5, 6, 8), (12, 16)])
def test_batchnorm_matches_jax(shape):
    # flax is imported here, not at the top: the card's machine has JAX but
    # no flax, and runs this file's cuda test
    from hairci.models.norm import BatchNorm as JaxBatchNorm

    rng = np.random.default_rng(sum(shape))
    x = rng.normal(0.5, 1.5, size=shape).astype(np.float32)
    c = shape[-1]
    scale = rng.normal(1.0, 0.2, size=c).astype(np.float32)
    bias = rng.normal(0.0, 0.2, size=c).astype(np.float32)
    ra_mean = rng.normal(size=c).astype(np.float32)
    ra_var = rng.uniform(0.5, 2.0, size=c).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)

    jbn = JaxBatchNorm(use_running_average=False)
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": ra_mean, "var": ra_var}}

    def loss(params, x):
        y, upd = jbn.apply({**variables, "params": params}, x,
                           mutable=["batch_stats"])
        return jnp.sum(y * g), (y, upd)

    (_, (y, upd)), (gp, gx) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                            jnp.asarray(x))

    bn = BatchNorm(c)
    bn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(ra_mean),
                        "running_var": torch.from_numpy(ra_var)})
    xt = torch.from_numpy(x).requires_grad_()
    # a 4-D input is NCHW to the port (channels_last inside the ResNet)
    xin = xt.permute(0, 3, 1, 2) if xt.dim() == 4 else xt
    yt = bn(xin)
    yt = yt.permute(0, 2, 3, 1) if yt.dim() == 4 else yt
    (yt * torch.from_numpy(g)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(y), **tol)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]), **tol)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **tol)
    np.testing.assert_allclose(bn.weight.grad.numpy(),
                               np.asarray(gp["scale"]), **tol)
    np.testing.assert_allclose(bn.bias.grad.numpy(),
                               np.asarray(gp["bias"]), **tol)

    # eval mode: the running stats, untouched
    bn.eval()
    before = bn.running_var.clone()
    ye = bn(torch.from_numpy(x).permute(0, 3, 1, 2) if len(shape) == 4
            else torch.from_numpy(x))
    ye = ye.permute(0, 2, 3, 1) if ye.dim() == 4 else ye
    yj = JaxBatchNorm(use_running_average=True).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": np.asarray(upd["batch_stats"]["mean"]),
                         "var": np.asarray(upd["batch_stats"]["var"])}},
        jnp.asarray(x))
    np.testing.assert_allclose(ye.detach().numpy(), np.asarray(yj), **tol)
    assert torch.equal(bn.running_var, before)
    assert "num_batches_tracked" not in bn.state_dict()


@pytest.mark.cuda
def test_cuda_kernel_matches_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for M, C in ((4096, 256), (192, 2048), (1000, 7), (3, 64),
                     (100_000, 64), (9408, 2048), (37632, 1024),
                     (150_528, 128), (5000, 24), (70_000, 1), (1, 1)):
            x = torch.randn(M, C, device="cuda", generator=gen).to(dtype)
            before = bn_stats.launches
            s, sq = bn_stats(x)
            rs, rq = bn_stats_reference(x)
            torch.cuda.synchronize()
            assert bn_stats.launches == before + 1
            torch.testing.assert_close(s, rs, rtol=1e-4, atol=1e-3)
            torch.testing.assert_close(sq, rq, rtol=1e-4, atol=1e-3)
            # one launch, the last block adds in index order: the same bits
            # on every run, and the tickets are back at zero
            for _ in range(3):
                s2, sq2 = bn_stats(x)
                assert torch.equal(s, s2) and torch.equal(sq, sq2)
            assert all(int(t.sum()) == 0 for t in bn_mod._counters.values())
    # a view whose pointer is not 16-byte aligned takes the scalar path
    x = torch.randn(64 * 32 + 1, device="cuda", generator=gen)[1:]
    s, _ = bn_stats(x.view(64, 32))
    torch.testing.assert_close(s, x.view(64, 32).sum(0), rtol=1e-5,
                               atol=1e-4)
