"""BatchNorm's apply and its backward for the ResNet trunk: three CUDA
kernels, their plain twins, and the autograd Function that runs them.

Kernels: ``csrc/bn_apply.cu``, written by hand for Hopper (``sm_90a``), built
with nvcc at first use and bound with ctypes, as ``bn_stats`` is. They
replace no TPU kernel: in the JAX package XLA fuses BatchNorm's normalise,
the residual add and the ReLU and differentiates them. Run eagerly, that
chain was one f32 pass over the activation for each of cast, multiply, add,
cast back, ReLU and residual add, each replayed by autograd in the backward,
with an f32 copy of every BN input kept for the multiply's gradient: about
122 bytes moved per element of a bf16 BN input in a training step. The
kernels move 18 to 22 (``csrc/bn_apply.cu`` says how):

- ``bn_apply``: y = x * w + b per channel in f32, rounded to x's dtype, then
  + residual (rounded again) and ReLU where asked;
- ``bn_grad_sums``: A = sum g and B = sum g * x per channel in f32, where g
  is dy masked by the ReLU's output (or dy);
- ``bn_grad_input``: dx = g * w + g_s + 2 x * g_sq rounded once to x's
  dtype, and d residual = g.

Each takes its twin for a CPU tensor and launches its kernel for a CUDA one.
``bn_apply.launches`` / ``.modes`` count the apply's launches (by BN mode,
train or eval), ``bn_grad_sums.launches`` and ``bn_grad_input.launches``
the backward's; ``.twin_calls`` counts the same calls on the CPU. The
twins repeat the kernels' arithmetic in plain torch: the apply's is the
plain BatchNorm formula (as ``hairci/models/norm.py`` writes it) followed by
PyTorch's add and ReLU, op for op.

``BatchNormApply`` is the non-centred ``models.norm.BatchNorm``: the
statistics from ``bn_stats`` (train mode, all-reduced under a process
group) or the running ones (eval mode), the running statistics' update, one
apply launch; its backward forms the weight's and bias' gradients and the
gradients of the sums on C-sized tensors between the two backward launches.
It saves x, w and, with a ReLU, y: no f32 copy of the input.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict, Optional, Tuple

import torch

from hairci_torch.ops import bn_stats as _stats
from hairci_torch.parallel import collectives

# the apply's and the input gradient's row splits: blocks an SM, run in
# waves; each block keeps its channels' vectors in registers for its rows
_ELEMENTWISE_BLOCKS_PER_SM = 16
_MODES = ("train", "eval")


# ---------------------------------------------------------------------------
# the plain twins
# ---------------------------------------------------------------------------

def _masked(dy: torch.Tensor, out: Optional[torch.Tensor]) -> torch.Tensor:
    """dy where the ReLU's output is above 0 (``out`` given), else dy: the
    gradient PyTorch's ReLU passes back."""
    return dy if out is None else torch.ops.aten.threshold_backward(dy, out,
                                                                    0)


def bn_apply_reference(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       residual: Optional[torch.Tensor] = None,
                       relu: bool = False,
                       dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain twin: ``(x * w + b).to(dtype)`` in w's dtype (f32 for a bf16 or
    f32 x), then ``residual + y`` and ``relu`` where asked."""
    y = (x.to(w.dtype) * w + b).to(dtype or x.dtype)
    if residual is not None:
        y = residual + y
    return torch.relu(y) if relu else y


def bn_grad_sums_reference(dy: torch.Tensor, out: Optional[torch.Tensor],
                           x: torch.Tensor,
                           acc: torch.dtype = torch.float32
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin: (sum of g, sum of g * x) over the rows, in ``acc``."""
    g = _masked(dy, out).to(acc)
    return g.sum(0), (g * x.to(acc)).sum(0)


def bn_grad_input_reference(dy: torch.Tensor, out: Optional[torch.Tensor],
                            x: torch.Tensor, w: torch.Tensor,
                            g_s: torch.Tensor, g_sq: torch.Tensor,
                            residual: bool = False
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain twin: (dx = g * w + g_s + 2 x * g_sq in w's dtype, rounded once
    to x's; g, the residual's gradient, where asked, else None)."""
    g = _masked(dy, out)
    dx = (g.to(w.dtype) * w + g_s + 2.0 * x.to(w.dtype) * g_sq).to(x.dtype)
    return dx, (g if residual else None)


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _library() -> Tuple[ctypes.CDLL, Callable]:
    """The built library, its three functions' argument types set once, and
    its error-string function."""
    from hairci_torch.ops._build import load_library

    lib = load_library("bn_apply")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hairci_bn_apply.argtypes = [p] * 5 + [i, ll] + [i] * 4 + [ll, i, p]
    lib.hairci_bn_grad_sums.argtypes = ([p] * 3 + [i, ll] + [i] * 4
                                        + [ll] + [p] * 4)
    lib.hairci_bn_grad_input.argtypes = ([p] * 8 + [i, ll] + [i] * 4
                                         + [ll, p])
    for fn in (lib.hairci_bn_apply, lib.hairci_bn_grad_sums,
               lib.hairci_bn_grad_input):
        fn.restype = ctypes.c_int
    lib.hairci_cuda_error_string.argtypes = [ctypes.c_int]
    lib.hairci_cuda_error_string.restype = ctypes.c_char_p
    lib.hairci_bn_apply_block.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
    lib.hairci_bn_apply_block.restype = None
    threads, unroll = ctypes.c_int(), ctypes.c_int()
    lib.hairci_bn_apply_block(ctypes.byref(threads), ctypes.byref(unroll))
    # the reduce takes bn_stats' plan, which assumes bn_stats' block
    if (threads.value, unroll.value) != (_stats.THREADS, _stats.UNROLL):
        raise RuntimeError(
            f"bn_apply: the kernels' block ({threads.value} threads, unroll "
            f"{unroll.value}) is not the plan's ({_stats.THREADS}, "
            f"{_stats.UNROLL})")
    return lib, lib.hairci_cuda_error_string


def elementwise_plan(M: int, C: int, vec: int,
                     sm_count: int) -> Tuple[int, int, int]:
    """(log2 of the channel groups per block, row splits, rows per split)
    for the apply and the input gradient on (M, C): bn_stats' channel tiles
    (``bn_stats.plan``), and row splits for about 16 blocks an SM, none
    beyond one loop turn's rows. Split i takes rows [i * rows, (i + 1) *
    rows), cut at M; every split is non-empty."""
    log_tg = _stats.plan(M, C, vec, sm_count)[0]
    tiles = -(-(-(-C // vec)) // (1 << log_tg))
    turn = _stats.UNROLL * (_stats.THREADS >> log_tg)
    splits = max(1, min(_ELEMENTWISE_BLOCKS_PER_SM * sm_count // tiles,
                        -(-M // turn), _stats._MAX_SPLITS))
    rows = -(-M // splits)
    return log_tg, -(-M // rows), rows


def _check(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Every (M, C) operand of a kernel: 2-D, contiguous, one shape, one
    dtype (f32 or bf16), one device."""
    ref = tensors[0]
    if ref.dim() != 2:
        raise ValueError(f"{name}: shape {tuple(ref.shape)} is not (M, C)")
    if ref.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: dtype {ref.dtype}; need float32/bfloat16")
    for t in tensors:
        if t is None:
            continue
        if t.shape != ref.shape or t.dtype != ref.dtype \
                or t.device != ref.device:
            raise ValueError(f"{name}: operands differ in shape, dtype or "
                             f"device: {tuple(t.shape)} {t.dtype} {t.device}"
                             f" against {tuple(ref.shape)} {ref.dtype} "
                             f"{ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def _channels(v: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """A per-channel vector as the kernels read it: C contiguous f32."""
    if v.shape != (ref.shape[1],):
        raise ValueError(f"per-channel vector of shape {tuple(v.shape)} for "
                         f"{ref.shape[1]} channels")
    return v.to(device=ref.device, dtype=torch.float32).contiguous()


def _launch(fn, name: str, ref: torch.Tensor, *args) -> None:
    index = ref.device.index
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + _library()[1](err).decode())


def _vec(ref: torch.Tensor, *tensors: Optional[torch.Tensor]) -> int:
    """16-byte lanes where C and every operand's pointer allow them."""
    address = 0
    for t in tensors:
        if t is not None:
            address |= t.data_ptr()
    return _stats.vector_width(ref.shape[1], ref.element_size(), address)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def bn_apply(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
             residual: Optional[torch.Tensor] = None, relu: bool = False,
             dtype: Optional[torch.dtype] = None,
             mode: str = "train") -> torch.Tensor:
    """``relu(residual + round(x * w + b))`` of a contiguous (M, C) input,
    each step after the first where asked, in ``dtype`` (x's by default;
    the kernel takes only x's). w, b: (C,) f32. ``mode`` (train or eval)
    names the BN mode for the counters. CUDA tensors launch the kernel; CPU
    tensors take the twin."""
    if mode not in _MODES:
        raise ValueError(f"bn_apply: mode {mode!r} not in {_MODES}")
    if x.device.type == "cpu":
        bn_apply.twin_calls[mode] += 1
        return bn_apply_reference(x, w, b, residual, relu, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"bn_apply: no kernel for {x.device}")
    if dtype not in (None, x.dtype):
        raise ValueError(f"bn_apply: the kernel writes x's dtype {x.dtype}, "
                         f"not {dtype}")
    _check("bn_apply", x, residual)
    w, b = _channels(w, x), _channels(b, x)
    y = torch.empty_like(x)
    M, C = x.shape
    if M and C:
        vec = _vec(x, x, residual, y)
        log_tg, splits, rows = elementwise_plan(
            M, C, vec, _stats._sm_count(x.device.index))
        lib = _library()[0]
        _launch(lib.hairci_bn_apply, "bn_apply", x, x.data_ptr(),
                _ptr(residual), y.data_ptr(), w.data_ptr(), b.data_ptr(),
                int(x.dtype == torch.bfloat16), M, C, vec, log_tg, splits,
                rows, int(relu), _stream(x))
        bn_apply.launches += 1
        bn_apply.modes[mode] += 1
    return y


bn_apply.launches = 0
bn_apply.modes = dict.fromkeys(_MODES, 0)
bn_apply.twin_calls = dict.fromkeys(_MODES, 0)

# (device index, stream) -> the zeroed tickets of that stream's reduce
# launches: one per channel tile; the kernel leaves them zeroed
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def bn_grad_sums(dy: torch.Tensor, out: Optional[torch.Tensor],
                 x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(A (C,), B (C,)) in f32: the sums over the rows of g and g * x, g =
    dy masked by ``out`` > 0 where ``out`` (the ReLU's output) is given.
    CUDA tensors launch the kernel; CPU tensors take the twin."""
    if x.device.type == "cpu":
        bn_grad_sums.twin_calls += 1
        return bn_grad_sums_reference(dy, out, x,
                                      torch.promote_types(x.dtype,
                                                          torch.float32))
    if x.device.type != "cuda":
        raise ValueError(f"bn_grad_sums: no kernel for {x.device}")
    _check("bn_grad_sums", x, dy, out)
    M, C = x.shape
    if M == 0 or C == 0:
        z = torch.zeros(C, dtype=torch.float32, device=x.device)
        return z, z.clone()
    index = x.device.index
    vec = _vec(x, dy, out, x)
    log_tg, splits, rows = _stats.plan(M, C, vec, _stats._sm_count(index))
    # one allocation: the (2, C) sums, then the (splits, 2, C) partials on a
    # 16-byte boundary; the kernel writes every value it reads
    head = -(-2 * C // 4) * 4
    buf = torch.empty(head + (2 * C * splits if splits > 1 else 0),
                      dtype=torch.float32, device=x.device)
    stream = _stream(x)
    tiles = -(-C // (vec << log_tg))
    tickets = _counters.get((index, stream))
    if tickets is None or tickets.numel() < tiles:
        tickets = torch.zeros(max(tiles, _stats._MIN_COUNTERS),
                              dtype=torch.int32, device=x.device)
        _counters[(index, stream)] = tickets
    lib = _library()[0]
    _launch(lib.hairci_bn_grad_sums, "bn_grad_sums", x, dy.data_ptr(),
            _ptr(out), x.data_ptr(), int(x.dtype == torch.bfloat16), M, C,
            vec, log_tg, splits, rows, buf.data_ptr() + 4 * head,
            buf.data_ptr(), tickets.data_ptr(), stream)
    bn_grad_sums.launches += 1
    return buf[:C], buf[C:2 * C]


bn_grad_sums.launches = 0
bn_grad_sums.twin_calls = 0


def bn_grad_input(dy: torch.Tensor, out: Optional[torch.Tensor],
                  x: torch.Tensor, w: torch.Tensor, g_s: torch.Tensor,
                  g_sq: torch.Tensor, residual: bool = False
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(dx = g * w + g_s + 2 x * g_sq in x's dtype; g where ``residual``,
    else None), g = dy masked by ``out`` > 0 where ``out`` is given. w,
    g_s, g_sq: (C,). CUDA tensors launch the kernel; CPU tensors take the
    twin."""
    if x.device.type == "cpu":
        bn_grad_input.twin_calls += 1
        return bn_grad_input_reference(dy, out, x, w, g_s, g_sq, residual)
    if x.device.type != "cuda":
        raise ValueError(f"bn_grad_input: no kernel for {x.device}")
    _check("bn_grad_input", x, dy, out)
    w, g_s, g_sq = (_channels(v, x) for v in (w, g_s, g_sq))
    dx = torch.empty_like(x)
    dres = torch.empty_like(dy) if residual else None
    M, C = x.shape
    if M and C:
        vec = _vec(x, dy, out, x, dx, dres)
        log_tg, splits, rows = elementwise_plan(
            M, C, vec, _stats._sm_count(x.device.index))
        lib = _library()[0]
        _launch(lib.hairci_bn_grad_input, "bn_grad_input", x, dy.data_ptr(),
                _ptr(out), x.data_ptr(), w.data_ptr(), g_s.data_ptr(),
                g_sq.data_ptr(), dx.data_ptr(), _ptr(dres),
                int(x.dtype == torch.bfloat16), M, C, vec, log_tg, splits,
                rows, _stream(x))
        bn_grad_input.launches += 1
    return dx, dres


bn_grad_input.launches = 0
bn_grad_input.twin_calls = 0


# ---------------------------------------------------------------------------
# the autograd Function
# ---------------------------------------------------------------------------

def _sums(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum, sum of squares) over the rows: ``bn_stats`` (the kernel on a
    card, its twin on the CPU); a float64 CPU input, which ``bn_stats``
    does not take, keeps float64."""
    if x.dtype == torch.float64 and x.device.type == "cpu":
        return x.sum(0), (x * x).sum(0)
    return _stats.bn_stats(x)


class BatchNormApply(torch.autograd.Function):
    """The non-centred BatchNorm of an (M, C) contiguous input, with the
    block's residual add and ReLU where asked:

        y = relu(residual + (x * w + b).to(dtype))

    w = weight / sqrt(var + eps), b = bias - mean * w, from the batch's
    statistics in train mode (their running averages updated in place, at
    ``momentum`` on the old value) or the running ones in eval mode.
    Differentiable in x, weight, bias and residual."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, running_mean, running_var,
                training: bool, momentum: float, eps: float,
                dtype: torch.dtype, relu: bool):
        C = x.shape[1]
        n = None
        if training:
            s, sq = _sums(x)
            # the row count as a device tensor with or without a process
            # group, so that both divide alike (a division by a host scalar
            # may round otherwise on a card)
            n = s.new_full((1,), x.shape[0])
            if collectives.active():
                tot = collectives.all_reduce_sum(torch.cat([s, sq, n]))
                s, sq, n = tot[:C], tot[C:2 * C], tot[2 * C:]
            mean = s / n
            var = sq / n - mean * mean
            m = momentum
            running_mean.copy_(m * running_mean + (1 - m) * mean)
            running_var.copy_(m * running_var + (1 - m) * var)
        else:
            mean, var = running_mean, running_var
        r = torch.reciprocal(torch.sqrt(var + eps))
        w = r * weight
        # -mean as a tensor of its own: in eval mode mean is the running
        # buffer, which a later update may change before the backward
        neg_mean = -mean
        y = bn_apply(x, w, neg_mean * w + bias, residual, relu, dtype,
                     "train" if training else "eval")
        ctx.save_for_backward(x, y if relu else None, w, r, neg_mean, weight,
                              n)
        ctx.training = training
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, out, w, r, neg_mean, weight, n = ctx.saved_tensors
        dy = dy.contiguous()
        A, B = bn_grad_sums(dy, out, x)
        # d loss / d w, with w the per-channel multiplier of both x and the
        # -mean term of b
        d_w = B + neg_mean * A
        C = x.shape[1]
        if ctx.training:
            # through w = r * weight, r = (var + eps)^-1/2, and b's -mean * w,
            # to the statistics, then to the sums: mean = s / n, var = sq /
            # n - mean^2
            d_var = -0.5 * (d_w * weight) * r * r * r
            d_mean = -w * A + 2.0 * neg_mean * d_var
            g = torch.cat([d_mean, d_var]) / n
            if collectives.active():
                g = collectives.all_reduce_sum(g)
            g_s, g_sq = g[:C], g[C:]
        else:
            g_s = g_sq = torch.zeros_like(w)
        need = ctx.needs_input_grad
        dx, d_res = bn_grad_input(dy, out, x, w, g_s, g_sq, need[3])
        return (dx if need[0] else None, d_w * r if need[1] else None,
                A if need[2] else None, d_res,
                None, None, None, None, None, None, None)
