"""The port's rotate (hairci_torch/ops/rotate.py) against the JAX package:
the twin bitwise against ``hairci.aug.ops.rotate_shear(order=0)``, with the
blur against the composed ``rotate_shear`` + ``gaussian_blur(k=3)``, both
against ``rotate_shear_pallas`` in interpret mode, on the shapes the
kernel's band tiling cares about; a numpy emulation of the kernel's index
logic (shift tables, the conditional wrap, bands with a reflected halo at a
16-byte phase, the in-place vertical pass, the quad loop) bitwise against
the twin; the CUDA kernel against the twin on a card."""

import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hairci.aug import ops as jops
from hairci.ops import rotate_pallas as rp
from hairci_torch.ops.rotate import (
    blur3_weights,
    max_shifts,
    rotate_shear,
    rotate_shear_reference,
    shear_coefficients,
)

torch.set_num_threads(1)
DEG = math.pi / 180.0
# -2 atan(1/8) in f32: -tan(theta/2) is exactly 0.125 in torch and in JAX, so
# with an odd height the shear at d = r - cy = 4 is exactly 0.5: rounding
# half up gives 1 where round-half-even gives 0
HALF_THETA = np.float32(-0.24870999)
THETAS = np.asarray([0.0, 15 * DEG, -15 * DEG, HALF_THETA, 0.2, -0.11],
                    np.float32)

# (H, W, C, max_degrees, fill): the shapes the band tiling cares about
CASES = {
    "wc_not_4x": (33, 31, 3, 15.0, 0.0),      # W*C = 93: ragged quads
    "c1": (32, 32, 1, 15.0, 0.0),
    "c4": (17, 15, 4, 15.0, -1.0),
    "h_below_band": (5, 12, 3, 15.0, 0.0),    # fewer rows than a band
    "mx_ge_w": (40, 6, 3, 45.0, 0.5),         # mx = 10 >= W: a narrow image
    "c5": (9, 7, 5, 15.0, 0.0),               # the kernel for any C
    "wc_below_4": (3, 2, 1, 45.0, -1.0),      # a quad spans two rows
}


def _case_thetas(max_degrees, seed):
    """0, +-max, the exact half shift, beyond the bound (clamped), random."""
    m = max_degrees * DEG
    rng = np.random.default_rng(seed)
    return np.asarray([0.0, m, -m, HALF_THETA, 1.5 * m, -2.0 * m,
                       rng.uniform(-m, m)], np.float32)


def _case(name, seed=0):
    H, W, C, max_deg, fill = CASES[name]
    theta = _case_thetas(max_deg, seed)
    rng = np.random.default_rng(seed + H * W * C)
    x = rng.normal(size=(len(theta), H, W, C)).astype(np.float32)
    sigma = rng.uniform(0.1, 0.5, size=len(theta)).astype(np.float32)
    return x, theta, sigma, max_deg, fill


def _inputs(H=33, W=32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(len(THETAS), H, W, 3)).astype(np.float32)
    sigma = rng.uniform(0.1, 0.5, size=len(THETAS)).astype(np.float32)
    return x, sigma


def _interpret():
    orig = rp.pl.pallas_call
    return mock.patch.object(
        rp.pl, "pallas_call",
        lambda *a, **k: orig(*a, **{**k, "interpret": True}))


def test_half_theta_is_an_exact_half():
    alpha, _ = shear_coefficients(torch.tensor([HALF_THETA]))
    assert float(alpha[0]) == 0.125 and float(alpha[0]) * 4 == 0.5


@pytest.mark.parametrize("H,W", [(33, 32), (32, 32)])
def test_twin_matches_jax_bitwise(H, W):
    x, _ = _inputs(H, W)
    want = jops.rotate_shear(jnp.asarray(x), jnp.asarray(THETAS), order=0,
                             max_degrees=15.0)
    got = rotate_shear_reference(torch.from_numpy(x),
                                 torch.from_numpy(THETAS), max_degrees=15.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_matches_jax_cases(name):
    """Bitwise against ``rotate_shear(order=0)`` and the Pallas kernel
    without blur; within 2e-6 of the Pallas kernel with blur."""
    x, theta, sigma, max_deg, fill = _case(name)
    xj, tj = jnp.asarray(x), jnp.asarray(theta)
    want = jops.rotate_shear(xj, tj, order=0, fill=fill, max_degrees=max_deg)
    with _interpret():
        plain = rp.rotate_shear_pallas(xj, tj, fill=fill, max_degrees=max_deg)
        blurred = rp.rotate_shear_pallas(xj, tj, fill=fill,
                                         max_degrees=max_deg,
                                         blur_sigma=jnp.asarray(sigma))
    xt, tt = torch.from_numpy(x), torch.from_numpy(theta)
    got = rotate_shear(xt, tt, fill=fill, max_degrees=max_deg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), np.asarray(plain))
    got = rotate_shear(xt, tt, fill=fill, max_degrees=max_deg,
                       blur_sigma=torch.from_numpy(sigma))
    np.testing.assert_allclose(got.numpy(), np.asarray(blurred), rtol=0,
                               atol=2e-6)


def test_twin_blur_matches_jax_composed():
    x, sigma = _inputs()
    # gaussian_blur(k=3, p=1) draws (apply, sigma) from one key: feed its
    # sigma to the port
    key = jax.random.key(3)
    _, k_sigma = jax.random.split(key)
    sigma = np.array(jax.random.uniform(k_sigma, (len(THETAS),),
                                          minval=0.1, maxval=0.5))
    want = jops.rotate_shear(jnp.asarray(x), jnp.asarray(THETAS), order=0,
                             max_degrees=15.0)
    want = jops.gaussian_blur(key, want, 3, sigma_range=(0.1, 0.5), p=1.0)
    got = rotate_shear(torch.from_numpy(x), torch.from_numpy(THETAS),
                       max_degrees=15.0, blur_sigma=torch.from_numpy(sigma))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-6)


def test_twins_match_pallas_interpret():
    x, sigma = _inputs(seed=1)
    with _interpret():
        plain = rp.rotate_shear_pallas(jnp.asarray(x), jnp.asarray(THETAS),
                                       max_degrees=15.0)
        blurred = rp.rotate_shear_pallas(jnp.asarray(x), jnp.asarray(THETAS),
                                         max_degrees=15.0,
                                         blur_sigma=jnp.asarray(sigma))
    xt, tt = torch.from_numpy(x), torch.from_numpy(THETAS)
    np.testing.assert_array_equal(
        rotate_shear(xt, tt, max_degrees=15.0).numpy(), np.asarray(plain))
    np.testing.assert_allclose(
        rotate_shear(xt, tt, max_degrees=15.0,
                     blur_sigma=torch.from_numpy(sigma)).numpy(),
        np.asarray(blurred), rtol=0, atol=2e-6)


def test_fill_and_clamp_beyond_the_bound():
    # |theta| past max_degrees: the shifts are clamped as by the roll ladder
    x, _ = _inputs(seed=2)
    theta = np.full(len(THETAS), 40 * DEG, np.float32)
    want = jops.rotate_shear(jnp.asarray(x), jnp.asarray(theta), order=0,
                             fill=-1.0, max_degrees=15.0)
    got = rotate_shear(torch.from_numpy(x), torch.from_numpy(theta),
                       fill=-1.0, max_degrees=15.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --- the CUDA kernel's index logic, emulated in numpy ----------------------
# csrc/rotate.cu, lane by lane where the order matters: a block per band of
# ``rows`` full-width output rows; shared memory a flat f32 array (NaN where
# nothing was written, so a read of it shows in the result) with the band at
# LEAD + ph; every index checked against its range before it is used.

LEAD = 4
BATCH_BLUR, BATCH_PLAIN = 4, 8
KERNEL_C = (1, 3, 4)  # channel counts with a kernel of their own


def _f32(v):
    return np.float32(v)


def _shift_table(coef, size, max_shift, axis_len):
    d = np.arange(size, dtype=np.float32) - _f32(0.5 * (size - 1))
    t = np.floor((_f32(coef) * d).astype(np.float32) + _f32(0.5))
    n = np.clip(t, -2.0 ** 30, 2.0 ** 30).astype(np.int64)
    m = np.clip(n, -max_shift, max_shift)
    if max_shift >= axis_len:
        m = np.fmod(m, axis_len)  # C's %
    m = np.where(m < 0, m + axis_len, m)
    return n, m


def _in(idx, lo, hi, what):
    idx = np.asarray(idx)
    assert ((idx >= lo) & (idx < hi)).all(), f"{what} out of [{lo}, {hi})"
    return idx


def _emulate_block(xflat, strides, out, b, band, rows_max, H, W, C, mx, my,
                   alpha, beta, w, fill, ph_out, threads):
    """One block of the kernel; writes its band of ``out`` (flat) and counts
    each store in ``out_count``."""
    out, out_count = out
    blur = w is not None
    halo = 1 if blur else 0
    WC = W * C
    r0 = band * rows_max
    rows = min(rows_max, H - r0)
    start = (b * H + r0) * WC
    ph = (ph_out + start) & 3
    band_floats = (rows_max * WC + 16 + 3) // 4 * 4
    smem = np.full(band_floats, np.nan, np.float32)
    base = LEAD + ph
    nxu, nxm = _shift_table(alpha, H, mx, W)
    nyu, nym = _shift_table(beta, W, my, H)
    sb, sh, sw, sc = strides

    # gather: lane t walks down column t (then t + threads, ...), batch rows
    # a round, looked up at the band's last row past its end; with the blur
    # the walk starts one reflected row above the band and ends one below,
    # and keeps two rows in registers. C other than 1, 3, 4: one walk a
    # channel
    w0, w1 = w if blur else (None, None)
    stored = rows + 2 * halo
    kch = C if C in KERNEL_C else 1
    batch = BATCH_BLUR if blur else BATCH_PLAIN
    for c in (np.arange(c0, min(c0 + threads, W))
              for c0 in range(0, W, threads)):
        for ch0 in range(0, C, kch):
            up = mid = None
            for g0 in range(0, stored, batch):
                vals = []
                for u in range(batch):
                    r = np.full_like(c, r0 - halo + min(g0 + u, stored - 1))
                    if blur:
                        r = np.where(r < 0, -r,
                                     np.where(r > H - 1, 2 * (H - 1) - r, r))
                    r = _in(r, 0, H, "row")
                    ok = (c - nxu[r] >= 0) & (c - nxu[r] < W)
                    c2 = c - nxm[r]
                    c2 = _in(np.where(c2 < 0, c2 + W, c2), 0, W, "c2")
                    ok &= (r - nyu[c2] >= 0) & (r - nyu[c2] < H)
                    sr = r - nym[c2]
                    sr = _in(np.where(sr < 0, sr + H, sr), 0, H, "sr")
                    ok &= (c2 - nxu[sr] >= 0) & (c2 - nxu[sr] < W)
                    scol = c2 - nxm[sr]
                    scol = _in(np.where(scol < 0, scol + W, scol), 0, W, "sc")
                    src = b * sb + sr * sh + scol * sw + ch0 * sc
                    vals.append(np.stack([np.where(
                        ok, xflat[_in(src + k * sc, 0, xflat.size, "x")],
                        np.float32(fill)) for k in range(kch)]))
                for u in range(batch):
                    g = g0 + u
                    if g >= stored:
                        break
                    dst = base + (g - 2 * halo) * WC + c * C + ch0
                    if not blur:
                        for k in range(kch):
                            smem[_in(dst + k, 0, band_floats, "band")] = \
                                vals[u][k]
                        continue
                    if g >= 2:
                        for k in range(kch):
                            smem[_in(dst + k, 0, band_floats, "band")] = (
                                w1 * mid[k] + w0 * (up[k] + vals[u][k]))
                    up, mid = mid, vals[u]

    # the quad loop, all lanes at once
    n = rows * WC
    quads = (n + ph + 3) >> 2
    t = np.arange(threads)
    step_f = (4 * threads) % WC
    f = np.fmod(4 * t - ph, WC)
    f = np.where(f < 0, f + WC, f)
    q = t.copy()
    while (q < quads).any():
        act = q < quads
        qa, fa = q[act], f[act]
        j0 = 4 * qa - ph
        v = np.zeros((len(qa), 4), np.float32)
        if not blur:
            for k in range(4):
                v[:, k] = smem[_in(LEAD + 4 * qa + k, 0, band_floats, "s4")]
        else:
            fk = fa.copy()
            for k in range(4):
                j = j0 + k
                if C in KERNEL_C:  # the window of three float4 loads
                    win = LEAD + 4 * (qa - 1) + np.arange(12)[:, None]
                    _in(win, 0, band_floats, "window")
                    mid_ = smem[LEAD + 4 * qa + k]
                    lj = np.where(fk < C, 4 + k + C, 4 + k - C)
                    rj = np.where(fk >= WC - C, 4 + k - C, 4 + k + C)
                    lft = smem[LEAD + 4 * (qa - 1) + lj]
                    rgt = smem[LEAD + 4 * (qa - 1) + rj]
                else:  # scalar loads, only for the band's own floats
                    live = (j >= 0) & (j < n)
                    lj = np.where(fk < C, j + C, j - C)
                    rj = np.where(fk >= WC - C, j - C, j + C)
                    _in(base + np.concatenate([lj[live], rj[live]]), 0,
                        band_floats, "scalar")
                    lj, rj, jj = (np.where(live, a, 0) for a in (lj, rj, j))
                    mid_, lft, rgt = (smem[base + a] for a in (jj, lj, rj))
                v[:, k] = w1 * mid_ + w0 * (lft + rgt)
                fk = np.where(fk + 1 == WC, 0, fk + 1)
        dst = start - ph + 4 * qa
        full = (j0 >= 0) & (j0 + 4 <= n)
        assert ((ph_out + dst[full]) % 4 == 0).all(), "float4 misaligned"
        for k in range(4):
            keep = (j0 + k >= 0) & (j0 + k < n)
            idx = _in(dst[keep] + k, start, start + n, "store")
            out[idx] = v[keep, k]
            out_count[idx] += 1
        q = q + threads
        f = f + step_f
        f = np.where(f >= WC, f - WC, f)


def _emulate(x, theta, fill, max_degrees, sigma, rows, threads, ph_out):
    """The kernel on a (B, H, W, C) array (any strides), in numpy; the
    coefficients are the twin's (the kernel's own tanf/sinf/expf are held
    against them on the card)."""
    B, H, W, C = x.shape
    mx, my = max_shifts(H, W, max_degrees)
    alpha, beta = (a.numpy() for a in
                   shear_coefficients(torch.from_numpy(theta)))
    ws = (None if sigma is None else
          [a.numpy() for a in blur3_weights(torch.from_numpy(sigma))])
    base = x.base if x.base is not None else x
    xflat = np.ascontiguousarray(base).reshape(-1)
    strides = tuple(s // 4 for s in x.strides)
    out = np.full(x.size, np.nan, np.float32)
    count = np.zeros(x.size, np.int64)
    bands = -(-H // rows)
    for b in range(B):
        for band in range(bands):
            w = None if ws is None else (ws[0][b], ws[1][b])
            _emulate_block(xflat, strides, (out, count), b, band, rows, H, W,
                           C, mx, my, alpha[b], beta[b], w, fill, ph_out,
                           threads)
    assert (count == 1).all(), "a float stored twice or never"
    return out.reshape(B, H, W, C)


@pytest.mark.parametrize("blur", [False, True], ids=["plain", "blur"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_emulation_matches_twin(name, blur):
    """The kernel's band rows (8 plain, 16 blur) and smaller bands, its 256
    lanes and 32, an aligned and a misaligned output, a contiguous input
    and one in NCHW order: every combination bitwise the twin."""
    x, theta, sigma, max_deg, fill = _case(name, seed=5)
    sig = sigma if blur else None
    want = rotate_shear_reference(
        torch.from_numpy(x), torch.from_numpy(theta), fill, max_deg,
        None if sig is None else torch.from_numpy(sig)).numpy()
    nchw = np.ascontiguousarray(x.transpose(0, 3, 1, 2)).transpose(0, 2, 3, 1)
    for rows, threads, ph_out, xin in ((16 if blur else 8, 256, 0, x),
                                       (3, 32, 1, nchw), (4, 256, 3, nchw),
                                       (1, 16, 2, x)):
        got = _emulate(xin, theta, fill, max_deg, sig, rows, threads, ph_out)
        np.testing.assert_array_equal(got, want, err_msg=(
            f"rows={rows} threads={threads} phase={ph_out}"))


def test_wrapper_checks_and_cpu_path():
    x = torch.zeros(2, 8, 8, 3)
    before = rotate_shear.launches
    assert rotate_shear(x, torch.zeros(2)).shape == x.shape
    assert rotate_shear.launches == before  # the twin is no launch
    with pytest.raises(ValueError, match="f32"):
        rotate_shear(x.double(), torch.zeros(2))
    with pytest.raises(ValueError, match="theta"):
        rotate_shear(x, torch.zeros(3))
    with pytest.raises(ValueError, match="blur_sigma"):
        rotate_shear(x, torch.zeros(2), blur_sigma=torch.ones(1))
    # the kernel gathers at the input's strides: a permuted batch gives the
    # bits of its contiguous copy
    xs = torch.randn(2, 3, 8, 9, generator=torch.Generator().manual_seed(0))
    view = xs.permute(0, 2, 3, 1)
    assert not view.is_contiguous()
    theta = torch.tensor([0.2, -0.25])
    for sigma in (None, torch.tensor([0.3, 0.4])):
        assert torch.equal(
            rotate_shear(view, theta, blur_sigma=sigma),
            rotate_shear(view.contiguous(), theta, blur_sigma=sigma))


@pytest.mark.cuda
def test_cuda_kernel_matches_twin():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(6, 33, 32, 3, 15.0, 0.0), (4, 224, 224, 3, 15.0, 0.0),
              (3, 17, 45, 5, 15.0, 0.0)]
    shapes += [(7, *CASES[name]) for name in sorted(CASES)]
    for B, H, W, C, max_deg, fill in shapes:
        x = torch.randn(B, H, W, C, device="cuda", generator=gen)
        theta = ((torch.rand(B, device="cuda", generator=gen) * 2 - 1)
                 * max_deg * DEG)
        theta[:4] = torch.tensor([max_deg * DEG, float(HALF_THETA),
                                  -1.5 * max_deg * DEG, 0.0])[:B]
        sigma = torch.rand(B, device="cuda", generator=gen) * 0.4 + 0.1
        nchw = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        for xin in (x, nchw):
            for blur in (None, sigma):
                before = rotate_shear.launches
                got = rotate_shear(xin, theta, fill=fill,
                                   max_degrees=max_deg, blur_sigma=blur)
                assert rotate_shear.launches == before + 1
                assert got.is_contiguous()
                want = rotate_shear_reference(x, theta, fill, max_deg, blur)
                torch.cuda.synchronize()
                if blur is None:
                    assert torch.equal(got, want), (B, H, W, C)
                else:
                    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)
    with pytest.raises(ValueError, match="theta must be f32"):
        rotate_shear(x, theta.double())
    with pytest.raises(ValueError, match="does not fit"):
        rotate_shear(torch.zeros(1, 2, 20000, 3, device="cuda"),
                     torch.zeros(1, device="cuda"),
                     blur_sigma=torch.ones(1, device="cuda"))
