"""The port's top-k (hairci_torch/ops/topk.py) against the JAX Pallas kernel
(hairci/ops/topk_pallas.py) run in interpret mode on the CPU, the split
arithmetic of the kernel's batched (tensor-core) route emulated in plain
torch, the route plan, and the CUDA kernel against its plain twin on a
card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairci.ops.topk_pallas import topk_gallery_search as jax_topk
from hairci_torch.ops.topk import (
    BATCHED_MIN_Q,
    plan,
    topk_gallery_search,
    topk_gallery_search_reference,
)

torch.set_num_threads(1)


def _unit(rng, n, d):
    x = rng.normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _assert_same(ours, ref):
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("Q,N,D,k,chunk", [
    (4, 100, 32, 5, 32),     # padding on every axis + multiple chunks
    (8, 256, 128, 10, 128),  # aligned
    (3, 50, 16, 60, 32),     # k > N -> clamped to N
])
def test_twin_matches_pallas_interpret(Q, N, D, k, chunk):
    rng = np.random.default_rng(Q * N)
    q, g = _unit(rng, Q, D), _unit(rng, N, D)
    ref = jax_topk(jnp.asarray(q), jnp.asarray(g), k=k, chunk=chunk,
                   interpret=True)
    ours = topk_gallery_search_reference(torch.from_numpy(q),
                                         torch.from_numpy(g), min(k, N))
    _assert_same(ours, ref)


def test_tie_order_matches_pallas_interpret():
    # duplicated gallery rows -> equal scores; the lower index must win
    rng = np.random.default_rng(1)
    base = _unit(rng, 10, 16)
    g = np.concatenate([base, base])
    ref = jax_topk(jnp.asarray(g[:4]), jnp.asarray(g), k=3, chunk=8,
                   interpret=True)
    ours = topk_gallery_search(torch.from_numpy(g[:4].copy()),
                               torch.from_numpy(g), 3)
    _assert_same(ours, ref)
    np.testing.assert_array_equal(ours[1][:, :2].numpy(),
                                  np.stack([np.arange(4), np.arange(4) + 10],
                                           1))


def test_bf16_storage_matches_pallas_interpret():
    # GalleryIndex passes a bf16 gallery without bf16=True: the kernel reads
    # bf16 rows and scores f32(q) . f32(g)
    rng = np.random.default_rng(2)
    q, g = _unit(rng, 4, 64), _unit(rng, 200, 64)
    g16 = jnp.asarray(g, jnp.bfloat16)
    ref = jax_topk(jnp.asarray(q), g16, k=5, chunk=64, interpret=True)
    g_t = torch.from_numpy(np.array(g16.astype(jnp.float32))).bfloat16()
    ours = topk_gallery_search(torch.from_numpy(q), g_t, 5)
    _assert_same(ours, ref)


def test_n_valid_matches_pallas_interpret():
    rng = np.random.default_rng(3)
    q, g = _unit(rng, 5, 32), _unit(rng, 160, 32)
    ref = jax_topk(jnp.asarray(q), jnp.asarray(g), k=8, chunk=32,
                   interpret=True, n_valid=100)
    ours = topk_gallery_search(torch.from_numpy(q), torch.from_numpy(g), 8,
                               n_valid=100)
    _assert_same(ours, ref)
    assert ours[1].max() < 100


def test_wrapper_checks_and_cpu_path():
    q = torch.zeros(2, 8)
    g = torch.zeros(20, 8)
    before = topk_gallery_search.launches
    s, i = topk_gallery_search(q, g, 4)
    assert s.shape == (2, 4) and i.dtype == torch.int64
    assert topk_gallery_search.launches == before  # the twin is no launch
    with pytest.raises(ValueError, match="k <= 16"):
        topk_gallery_search(q, g, 17)
    with pytest.raises(ValueError, match="dtypes"):
        topk_gallery_search(q.double(), g, 4)
    with pytest.raises(ValueError, match="contiguous"):
        topk_gallery_search(q, torch.zeros(8, 20).T, 4)
    with pytest.raises(ValueError, match="shapes"):
        topk_gallery_search(q, torch.zeros(20, 9), 4)
    with pytest.raises(ValueError, match="n_valid"):
        topk_gallery_search(q, g, 4, n_valid=21)


def test_plan_fills_the_card():
    # ViT-B serving shapes on a 132-SM card: Q=1 still gets hundreds of
    # blocks; shared memory always fits
    p = plan(1, 103945, 768, 5, 132)
    assert (p.route, p.log_qt, p.kcap) == ("fma", 0, 8) and p.splits >= 132
    # the batched route: one block an SM, whole 128-row tiles a split, one
    # wave, every tile in some split
    p = plan(256, 103945, 768, 16, 132)
    assert (p.route, p.kcap) == ("mma", 16)
    assert -(-256 // 128) * p.splits <= 132
    assert (p.splits - 1) * p.tiles_per_split * 128 < 103945 \
        <= p.splits * p.tiles_per_split * 128
    # below the threshold, or where the rows do not allow 16-byte copies,
    # the fma route, as it was
    assert plan(3, 5, 4000, 1, 132).log_qt == 3
    p = plan(256, 103945, 768, 16, 132, aligned=False)
    assert p.route == "fma" and (2 ** p.log_qt) * 768 * 4 <= 232448
    assert -(-256 // 2 ** p.log_qt) * p.splits >= 132


@pytest.mark.parametrize("Q,aligned,route", [
    (1, True, "fma"), (4, True, "fma"), (BATCHED_MIN_Q - 1, True, "fma"),
    (BATCHED_MIN_Q, True, "mma"), (256, True, "mma"), (1024, True, "mma"),
    # rows that do not allow 16-byte copies stay on the fma route
    (BATCHED_MIN_Q, False, "fma"), (256, False, "fma"),
])
def test_plan_routes_by_query_count(Q, aligned, route):
    assert plan(Q, 103945, 768, 5, 132, aligned).route == route


@pytest.mark.parametrize("Q,N", [(256, 103945), (16, 103945),
                                 (1024, 103945), (300, 2000), (64, 129),
                                 (129, 1000000)])
def test_plan_mma_work_is_balanced(Q, N):
    # a block walks no more tiles than the even share of (query tile,
    # gallery tile) pairs over 132 SMs, rounded up; every tile in a split
    p = plan(Q, N, 768, 5, 132)
    n_tiles, q_tiles = -(-N // 128), -(-Q // 128)
    waves = -(-q_tiles * p.splits // 132)
    assert waves * p.tiles_per_split == -(-q_tiles * n_tiles // 132)
    assert p.splits == -(-n_tiles // p.tiles_per_split)


def test_route_counters_and_the_cpu_path():
    # CPU tensors take the twin: no launch on either route, whatever Q
    q, g = torch.zeros(BATCHED_MIN_Q + 3, 16), torch.zeros(50, 16)
    before = (topk_gallery_search.launches,
              dict(topk_gallery_search.routes))
    for rows in (1, BATCHED_MIN_Q, q.shape[0]):
        s, i = topk_gallery_search(q[:rows].contiguous(), g, 3)
        assert s.shape == (rows, 3)
    assert set(topk_gallery_search.routes) == {"fma", "mma"}
    assert (topk_gallery_search.launches,
            topk_gallery_search.routes) == before


# --- the batched route's arithmetic, emulated in plain torch ---------------

def _tf32(x):
    """Round f32 to TF32: round to nearest (ties away) on the low 13
    mantissa bits, then mask them, as the kernel does in registers."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _emulated_scores(q, g):
    """The mma route's f32 scores. f32 gallery: 3xTF32, x = big + small
    with big = tf32(x), small = tf32(x - big), and small.big + big.small +
    big.big. bf16 gallery: q = q0 + q1 + q2 in bf16 terms against the
    exact bf16 rows. Products smallest first, as the kernel sums them."""
    if g.dtype == torch.bfloat16:
        gf, terms, rest = g.float(), [], q
        for _ in range(3):
            t = rest.bfloat16().float()
            terms.append(t)
            rest = rest - t
        return sum(torch.matmul(t, gf.T) for t in reversed(terms))
    qb, gb = _tf32(q), _tf32(g)
    qs, gs = _tf32(q - qb), _tf32(g - gb)
    return (torch.matmul(qb, gs.T) + torch.matmul(qs, gb.T)
            + torch.matmul(qb, gb.T))


def _clustered(rng, Q, N, D, clusters=16):
    """Unit gallery rows scattered round a few centres, and queries near
    gallery rows: many close scores inside a cluster."""
    centres = _unit(rng, clusters, D)
    g = centres[rng.integers(0, clusters, N)] + 0.5 * _unit(rng, N, D)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    q = g[rng.integers(0, N, Q)] + 0.3 * _unit(rng, Q, D)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q.astype(np.float32), g.astype(np.float32)


def test_tf32_rounding_emulation():
    x = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -11,
                      1 + 2 ** -12, -(1 + 2 ** -11), 3.0e-8])
    want = torch.tensor([1.0, 1 + 2 ** -10, 1 + 2 ** -9, 1.0,
                         -(1 + 2 ** -10), 0.0])
    got = _tf32(x)
    assert torch.equal(got[:5], want[:5])        # ties go away from zero
    assert (got.view(torch.int32) & 0x1fff).eq(0).all()
    assert abs(got[5].item() - 3.0e-8) <= 2 ** -11 * 3.0e-8


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_mma_route_split_arithmetic(storage):
    rng = np.random.default_rng(11)
    q, g = _clustered(rng, 256, 2000, 64)
    gt = torch.from_numpy(g)
    if storage == "bf16":
        gt = gt.bfloat16()
    qt = torch.from_numpy(q)
    ours = _emulated_scores(qt, gt)
    exact = torch.from_numpy(q).double() @ gt.double().T
    assert (ours.double() - exact).abs().max().item() <= 2e-6
    # its top-k against the Pallas kernel in interpret mode (which reads a
    # bf16 gallery as f32(g)), ties to the lower index
    idx = torch.from_numpy(np.broadcast_to(np.arange(2000), ours.shape).copy())
    order = np.lexsort((idx.numpy(), -ours.numpy().astype(np.float64)),
                       axis=1)[:, :5]
    g_jax = jnp.asarray(gt.float().numpy())
    ref = jax_topk(jnp.asarray(q), g_jax, k=5, interpret=True)
    np.testing.assert_array_equal(order, np.asarray(ref[1]))
    np.testing.assert_allclose(np.take_along_axis(ours.numpy(), order, 1),
                               np.asarray(ref[0]), rtol=0, atol=2e-6)


@pytest.mark.cuda
def test_cuda_kernel_matches_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        for Q, N, D, k in ((1, 5000, 768, 5), (37, 3001, 96, 16),
                           (256, 20000, 768, 8), (4, 3, 40, 8),
                           (5, 999, 45, 7),   # D % 4 != 0: scalar loads
                           (BATCHED_MIN_Q, 3000, 768, 5),
                           (BATCHED_MIN_Q - 1, 3000, 768, 5),
                           (300, 1000, 64, 16), (129, 7, 32, 8),
                           (256, 999, 45, 5)):   # batched Q, fma route
            q = torch.randn(Q, D, device="cuda", generator=gen)
            g = torch.randn(N, D, device="cuda", generator=gen)
            q = q / q.norm(dim=1, keepdim=True)
            g = (g / g.norm(dim=1, keepdim=True)).to(dtype)
            before = dict(topk_gallery_search.routes)
            s, i = topk_gallery_search(q, g, k)
            rs, ri = topk_gallery_search_reference(q, g, min(k, N))
            torch.cuda.synchronize()
            took = [r for r in before
                    if topk_gallery_search.routes[r] != before[r]]
            vec = 8 if dtype == torch.bfloat16 else 4
            assert took == [plan(Q, N, D, min(k, N), 132,
                                 D % vec == 0).route]
            torch.testing.assert_close(s, rs, rtol=0, atol=1e-5)
            assert torch.equal(i, ri)
        # duplicated rows at Q=64 (the mma route): equal scores, lower
        # index first
        half = torch.randn(500, 768, device="cuda", generator=gen)
        half = half / half.norm(dim=1, keepdim=True)
        dup = torch.cat([half, half]).to(dtype).contiguous()
        s, i = topk_gallery_search(half[:64].contiguous(), dup, 4)
        assert torch.equal(s[:, 0], s[:, 1])
        want = torch.arange(64, device="cuda")
        assert torch.equal(i[:, 0], want) and torch.equal(i[:, 1], want + 500)
        rs, ri = topk_gallery_search_reference(half[:64].contiguous(), dup, 4)
        assert torch.equal(i, ri)
