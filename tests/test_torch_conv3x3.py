"""The port's 3x3 convolution: the conv3x3 twin against the JAX Pallas kernel
``tools/fused_conv_bn_bench.py:pallas_conv3x3`` in interpret mode, the
wrapper's checks, which convs of the ResNets go to it and when, and the CUDA
kernel against its twin on a card."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from hairci_torch.models import resnet
from hairci_torch.ops import conv3x3 as conv_mod
from hairci_torch.ops.conv3x3 import (
    conv3x3,
    conv3x3_reference,
    kernel_route,
    kernel_weights,
    pack_weights,
    unpack_weights,
)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


def _bench_tool(B, H, W, cin, cout):
    """The TPU tool with its module constants set to a small shape (they are
    read when the kernel is traced)."""
    spec = importlib.util.spec_from_file_location(
        "fused_conv_bn_bench", REPO / "tools" / "fused_conv_bn_bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.B, mod.H, mod.W, mod.CIN, mod.COUT = B, H, W, cin, cout
    return mod


def _ulp_bf16(ref):
    """One bf16 ulp at each value of ``ref`` (8 bits of precision)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("stats,bias", [(False, False), (True, True)])
@pytest.mark.parametrize("shape", [(2, 8, 8, 64, 64), (1, 5, 7, 16, 24)])
def test_twin_matches_pallas_interpret(dtype, stats, bias, shape):
    B, H, W, cin, cout = shape
    tool = _bench_tool(*shape)
    rng = np.random.default_rng(B * H + cin)
    x = rng.normal(size=(B, H, W, cin)).astype(np.float32)
    w = (0.05 * rng.normal(size=(3, 3, cin, cout))).astype(np.float32)
    b = (0.1 * rng.normal(size=cout) if bias else np.zeros(cout)).astype(
        np.float32)
    xj, wj, bj = (jnp.asarray(a, dtype=dtype) for a in (x, w, b))
    with pltpu.force_tpu_interpret_mode():
        out = tool.pallas_conv3x3.__wrapped__(xj, wj, bj, stats=stats)
    ref = np.array(out[0].astype(jnp.float32)).reshape(B, H, W, cout)

    def t(a):  # the values JAX computed on, as f32 tensors
        return torch.from_numpy(np.array(a.astype(jnp.float32)))

    xt = t(xj).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    wt = t(wj).permute(3, 2, 0, 1)      # HWIO -> OIHW, torch's layout
    with torch.no_grad():
        got = conv3x3(xt, wt, t(bj) if bias else None, stats=stats)
    y = got[0] if stats else got
    assert y.dtype == xt.dtype and y.shape == (B, cout, H, W)
    assert y.is_contiguous(memory_format=torch.channels_last)
    ours = y.permute(0, 2, 3, 1).float().numpy()
    if dtype == "bfloat16":
        # both round one f32 sum of the same 9 * Cin products, taken in
        # another order: equal, or one bf16 ulp apart at a rounding boundary
        assert np.all(np.abs(ours - ref) <= _ulp_bf16(ref))
        assert np.mean(ours == ref) > 0.99
    else:
        np.testing.assert_allclose(ours, ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
    if stats:
        for a, r in zip(got[1:], out[1:]):
            r = np.asarray(r)[0]
            np.testing.assert_allclose(a.numpy(), r, rtol=1e-5,
                                       atol=1e-5 * np.abs(r).max())


def test_twin_is_conv2d_with_the_f32_sums():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 8, 5, 6, generator=gen).to(
        memory_format=torch.channels_last)
    w = torch.randn(16, 8, 3, 3, generator=gen)
    b = torch.randn(16, generator=gen)
    y, s, q = conv3x3_reference(x, w, b, stats=True)
    want = torch.nn.functional.conv2d(x, w, b, padding=1)
    torch.testing.assert_close(y, want)
    torch.testing.assert_close(s, want.sum((0, 2, 3)))
    torch.testing.assert_close(q, (want * want).sum((0, 2, 3)))
    # bf16: weights and bias are rounded to the input's type, the result once
    y16 = conv3x3_reference(x.bfloat16(), w, b)
    want16 = torch.nn.functional.conv2d(
        x.bfloat16().float(), w.bfloat16().float(), b.bfloat16().float(),
        padding=1).bfloat16()
    assert y16.dtype == torch.bfloat16 and torch.equal(y16, want16)
    k = kernel_weights(w, torch.bfloat16)
    assert k.shape == (9, 8, 16) and k.dtype == torch.float32
    assert torch.equal(k[5, 3], w[:, 3, 1, 2].bfloat16().float())


def test_wrapper_checks_and_cpu_path():
    x = torch.randn(2, 8, 4, 4).to(memory_format=torch.channels_last)
    w = torch.randn(8, 8, 3, 3)
    before = conv3x3.launches
    y = conv3x3(x, w)
    assert conv3x3.launches == before           # the twin is no launch
    assert torch.equal(y, conv3x3_reference(x, w))
    with pytest.raises(ValueError, match="channels_last"):
        conv3x3(torch.randn(2, 8, 4, 4), w)
    with pytest.raises(ValueError, match="dtype"):
        conv3x3(x.double(), w)
    with pytest.raises(ValueError, match="multiples of 8"):
        conv3x3(torch.randn(2, 4, 4, 4).to(
            memory_format=torch.channels_last), torch.randn(8, 4, 3, 3))
    with pytest.raises(ValueError, match="do not match"):
        conv3x3(x, torch.randn(8, 16, 3, 3))
    with pytest.raises(ValueError, match="bias"):
        conv3x3(x, w, torch.randn(4))
    with pytest.raises(ValueError, match="need"):
        conv3x3(x[0], w)
    with pytest.raises(RuntimeError, match="no backward"):
        conv3x3(x, w.requires_grad_())
    with torch.no_grad():
        assert torch.equal(conv3x3(x, w), y)


@pytest.mark.parametrize("name,count", [("resnet18", 4), ("resnet34", 6),
                                        ("resnet50", 3), ("resnet101", 3)])
def test_which_convs_go_to_the_kernel(name, count):
    model = resnet.build_resnet(name)
    routed = [n for n, m in model.named_modules()
              if isinstance(m, resnet.Conv2d) and m.to_kernel]
    assert len(routed) == count
    assert all(n.startswith("layer1.") for n in routed)
    if name == "resnet50":
        assert routed == [f"layer1.{j}.conv2" for j in range(3)]
    # the routing adds nothing to the state dict
    assert not any("to_kernel" in k for k in model.state_dict())


def test_conv2d_routes_by_grad_mode(monkeypatch):
    calls = []

    def spy(x, w, *a, **k):
        calls.append(tuple(x.shape))
        return conv3x3(x, w, *a, **k)

    monkeypatch.setattr(resnet, "conv3x3", spy)
    conv = resnet.Conv2d(64, 64, 3, 1, 1)
    other = [resnet.Conv2d(64, 64, 3, 2, 1), resnet.Conv2d(64, 128, 3, 1, 1),
             resnet.Conv2d(64, 64, 1, 1, 0), resnet.Conv2d(32, 32, 3, 1, 1)]
    x = torch.randn(2, 64, 6, 6).to(memory_format=torch.channels_last)
    with torch.no_grad():
        y = conv(x)
        for m in other:
            m(x[:, :m.in_channels])
    assert calls == [(2, 64, 6, 6)]
    want = conv(x)                      # grad mode on: the library's conv
    assert calls == [(2, 64, 6, 6)] and want.requires_grad
    torch.testing.assert_close(y, want.detach(), rtol=1e-5, atol=1e-5)
    # bf16 compute: the kernel's route rounds one f32 sum, as the conv does
    conv16 = resnet.Conv2d(64, 64, 3, 1, 1, dtype=torch.bfloat16)
    with torch.no_grad():
        y16 = conv16(x)
    assert y16.dtype == torch.bfloat16 and len(calls) == 2
    torch.testing.assert_close(y16.float(), conv16(x).detach().float(),
                               rtol=2 ** -7, atol=1e-3)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(2, 8, 8, 64, 64), (1, 5, 7, 16, 24)])
def test_packed_weights_feed_an_implicit_gemm(dtype, shape):
    """The layout the kernels read: an implicit GEMM in numpy that takes the
    packed weights tap by tap (tap = dy * 3 + dx; bf16 (Cout, Cin) rows for
    the tensor-core kernel, f32 (Cin, Cout) for the FMA kernel) against the
    JAX Pallas kernel in interpret mode."""
    B, H, W, cin, cout = shape
    tool = _bench_tool(*shape)
    rng = np.random.default_rng(7 * H + cout)
    x = rng.normal(size=(B, H, W, cin)).astype(np.float32)
    w = (0.05 * rng.normal(size=(3, 3, cin, cout))).astype(np.float32)
    xj, wj = (jnp.asarray(a, dtype=dtype) for a in (x, w))
    with pltpu.force_tpu_interpret_mode():
        out = tool.pallas_conv3x3.__wrapped__(
            xj, wj, jnp.zeros(cout, dtype=dtype), stats=False)
    ref = np.array(out[0].astype(jnp.float32)).reshape(B, H, W, cout)

    tdtype = getattr(torch, dtype)
    route = kernel_route(cin, cout, tdtype)
    assert route == ("mma" if (dtype, cin, cout) == ("bfloat16", 64, 64)
                     else "fma")
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)     # HWIO -> OIHW
    packed = pack_weights(wt, tdtype)
    assert packed.is_contiguous()
    if route == "mma":
        assert packed.dtype == torch.bfloat16
        assert packed.shape == (9, cout, cin)
    else:
        assert packed.dtype == torch.float32 and packed.shape == (9, cin, cout)
    taps = packed.float().numpy()
    xv = np.array(xj.astype(jnp.float32))            # the rounded inputs
    xp = np.pad(xv, ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = np.zeros((B * H * W, cout), np.float32)
    for dy in range(3):
        for dx in range(3):
            a = xp[:, dy:dy + H, dx:dx + W, :].reshape(-1, cin)
            tap = taps[dy * 3 + dx]
            acc += a @ (tap.T if route == "mma" else tap)
    ours = acc.reshape(B, H, W, cout)
    if dtype == "bfloat16":
        ours = torch.from_numpy(ours).bfloat16().float().numpy()
        assert np.all(np.abs(ours - ref) <= _ulp_bf16(ref))
    else:
        np.testing.assert_allclose(ours, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    # and back: the twin on the CPU reads the packed weights when given them
    assert torch.equal(unpack_weights(packed), wt.to(tdtype).float())
    xt = torch.from_numpy(xv).to(tdtype).permute(0, 3, 1, 2)
    with torch.no_grad():
        assert torch.equal(conv3x3(xt, wt, packed=packed), conv3x3(xt, wt))
        with pytest.raises(ValueError, match="packed weights"):
            conv3x3(xt, wt, packed=packed[:, :8])
        stale = pack_weights(2 * wt, tdtype)
        assert not torch.equal(conv3x3(xt, wt, packed=stale), conv3x3(xt, wt))


def _ema_update(target, source, momentum=0.9):
    """An EMA teacher's update, as the port's training state does it."""
    with torch.no_grad():
        t, o = list(target.parameters()), list(source.parameters())
        torch._foreach_mul_(t, momentum)
        torch._foreach_add_(t, torch._foreach_mul(o, 1.0 - momentum))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("update", ["mul_", "copy_", "optimizer", "ema",
                                    "load_state_dict", "to_dtype"])
def test_conv2d_packed_weights_follow_the_weight(update, dtype):
    """The cached packed weights are rebuilt after every kind of update the
    port makes, so the no-grad forward (packed weights) equals the grad-mode
    forward (the parameter itself)."""
    gen = torch.Generator().manual_seed(3)
    conv = resnet.Conv2d(64, 64, 3, 1, 1, dtype=dtype)
    x = torch.randn(2, 64, 6, 6, generator=gen).to(
        memory_format=torch.channels_last)
    keys = set(conv.state_dict())
    assert keys == {"weight"}

    def agree():
        with torch.no_grad():
            y = conv(x)
        want = conv(x).detach()
        assert torch.equal(conv.packed_weight(),
                           pack_weights(conv.weight, dtype))
        if dtype == torch.float32:
            torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-5)
        else:
            torch.testing.assert_close(y.float(), want.float(),
                                       rtol=2 ** -7, atol=1e-3)
        return y

    first = agree()
    before = conv.packed_weight()
    assert conv.packed_weight() is before        # no repack without a change
    other = resnet.Conv2d(64, 64, 3, 1, 1, dtype=dtype)
    if update == "mul_":
        with torch.no_grad():
            conv.weight.mul_(-1.5)
    elif update == "copy_":
        with torch.no_grad():
            conv.weight.copy_(other.weight)
    elif update == "optimizer":
        opt = torch.optim.SGD(conv.parameters(), lr=0.5)
        conv(x).square().sum().backward()
        opt.step()
    elif update == "ema":
        _ema_update(conv, other, momentum=0.5)
    elif update == "load_state_dict":
        conv.load_state_dict(other.state_dict())
    else:
        conv.half().float()      # new storage, perhaps at the old address
    assert conv.packed_weight() is not before
    second = agree()
    assert not torch.equal(first, second)
    assert set(conv.state_dict()) == keys
    # a copy of the module (the EMA teacher starts as one) packs its own
    import copy
    twin = copy.deepcopy(conv)
    with torch.no_grad():
        twin.weight.mul_(2.0)
        assert torch.equal(twin.packed_weight(),
                           pack_weights(twin.weight, dtype))
        assert torch.equal(conv(x), second)


@pytest.mark.cuda
def test_cuda_kernel_matches_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU)")
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        for B, H, W, cin, cout in ((4, 56, 56, 64, 64), (3, 7, 9, 64, 64),
                                   (2, 17, 33, 24, 40), (1, 1, 1, 8, 8),
                                   (2, 8, 16, 64, 128), (1, 1, 1, 64, 64),
                                   (2, 9, 29, 64, 64), (5, 30, 57, 64, 64),
                                   (40, 56, 56, 64, 64)):
            x = torch.randn(B, H, W, cin, device="cuda", generator=gen).to(
                dtype).permute(0, 3, 1, 2)
            w = 0.05 * torch.randn(cout, cin, 3, 3, device="cuda",
                                   generator=gen)
            b = 0.1 * torch.randn(cout, device="cuda", generator=gen)
            before = conv3x3.launches
            route = kernel_route(cin, cout, dtype)
            routed = conv3x3.routes[route]
            y, s, q = conv3x3(x, w, b, stats=True)
            ry, rs, rq = conv3x3_reference(x, w, b, stats=True)
            torch.cuda.synchronize()
            assert conv3x3.launches == before + 1
            assert conv3x3.routes[route] == routed + 1
            assert y.is_contiguous(memory_format=torch.channels_last)
            top = ry.float().abs().max().item()
            if dtype == torch.float32:
                torch.testing.assert_close(y, ry, rtol=0, atol=1e-5 * top)
            else:
                diff = (y.float() - ry.float()).abs()
                assert bool((diff <= 2.0 ** -7 * ry.float().abs()
                             + 1e-6 * top).all())
            for a, r in ((s, rs), (q, rq)):
                torch.testing.assert_close(
                    a, r, rtol=1e-5, atol=1e-5 * r.abs().max().item())
            assert torch.equal(conv3x3(x, w, b), y)
            # packed by the caller; and the statistics on every run the same
            y2, s2, q2 = conv3x3(x, w, b, stats=True,
                                 packed=pack_weights(w, dtype))
            assert torch.equal(y2, y) and torch.equal(s2, s) and \
                torch.equal(q2, q)
    with pytest.raises(ValueError, match="channels_last"):
        conv3x3(torch.randn(2, 8, 4, 4, device="cuda"),
                torch.randn(8, 8, 3, 3, device="cuda"))
    assert conv_mod._library()[1:] == ((8, 16), (8, 28))
    assert conv3x3.routes["mma"] > 0 and conv3x3.routes["fma"] > 0
    # a Conv2d on the card after an in-place update of its weight
    conv = resnet.Conv2d(64, 64, 3, 1, 1, dtype=torch.bfloat16).cuda()
    x = torch.randn(2, 12, 12, 64, device="cuda", generator=gen).permute(
        0, 3, 1, 2)
    with torch.no_grad():
        conv(x)
        conv.weight.mul_(0.5)
        assert torch.equal(conv(x), conv3x3(x.bfloat16(), conv.weight))
