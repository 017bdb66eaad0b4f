"""LayerNorm in float32 with the fast variance ``E[x^2] - E[x]^2`` (the
JAX package's ``models/layers.py::LayerNormFp32``) as dispatcher ops.

``torch.ops.mlaff.layer_norm_fwd(x, weight, bias, eps)`` returns ``(y,
mean, rstd)``: y in x's dtype, and per row of the last dim the float32
mean and ``rsqrt(var + eps)``, the latter negated where the clamp
``var = max(E[x^2] - E[x]^2, 0)`` took effect. ``layer_norm_bwd(x,
weight, mean, rstd, g)`` returns ``(dx, dweight, dbias)``: the gradient
of that same expression, the clamp included, dx in x's dtype and the
parameters' gradients in float32. Each op has a fake kernel, and the
forward an autograd formula that saves x as it came (bf16 in the
benchmark's cells) and the two statistics, nothing else; the statistics
are not differentiable.

On a CUDA tensor the forward launches ``csrc/layer_norm.cu``'s forward
kernel and the backward its two backward kernels (per-block partial sums
of dweight and dbias, then their sum in a fixed order: bitwise
reproducible); on a CPU tensor they run :func:`layer_norm_reference` and
:func:`layer_norm_backward_reference`. There is no fallback between the
two. ``models/layers.py::LayerNormFp32`` calls :func:`layer_norm` on a
CUDA tensor and keeps the plain expression on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .cluster_merge import _aligned

__all__ = ["layer_norm", "layer_norm_backward", "layer_norm_reference",
           "layer_norm_backward_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_PARTS_PER_SM = 8  # 256-thread blocks an H100 SM holds at most
_ENTRY = {}
_SMS = {}


def layer_norm_reference(x, weight, bias, eps: float):
    """The plain expression, as ``LayerNormFp32`` computes it on the CPU,
    with its statistics: ``(y, mean, rstd)``, rstd negated on the rows
    whose variance was clamped."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var_pre = (x32 * x32).mean(-1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var_pre.clamp_min(0.0) + eps)
    y = (x32 - mean) * rstd * weight + bias
    return (y.to(x.dtype), mean[..., 0],
            torch.where(var_pre < 0, -rstd, rstd)[..., 0])


def layer_norm_backward_reference(x, weight, mean, rstd, g):
    """Plain backward of :func:`layer_norm_reference` from its statistics:
    ``(dx, dweight, dbias)``. With ``xhat = (x - mean) * |rstd|`` and
    ``dxhat = g * weight``, ``dx = |rstd| * (dxhat - mean(dxhat) - xhat *
    mean(dxhat * xhat))``, the last term only where the variance was not
    clamped (``rstd > 0``: clamp_min passes the gradient where its input is
    at least 0); dweight and dbias sum ``g * xhat`` and ``g`` over the rows,
    in float32."""
    c = x.shape[-1]
    x32, g32 = x.float(), g.float()
    rs = rstd[..., None]
    r = rs.abs()
    xhat = (x32 - mean[..., None]) * r
    dxhat = g32 * weight
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = torch.where(rs < 0, 0.0, (dxhat * xhat).mean(-1, keepdim=True))
    dx = r * (dxhat - m1 - xhat * m2)
    return (dx.to(x.dtype), (g32 * xhat).reshape(-1, c).sum(0),
            g32.reshape(-1, c).sum(0))


def _entry(name, argtypes):
    """The C entry point ``name`` of ``csrc/layer_norm.cu``, typed once:
    the wrappers sit on the model's host-bound path."""
    fn = _ENTRY.get(name)
    if fn is None:
        fn = getattr(_build.library("layer_norm"), name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
        _ENTRY[name] = fn
    return fn


def _call(fn, device, *args):
    """``fn(*args, stream)`` on ``device``'s current stream; its
    cudaError_t."""
    index = device.index
    if index is not None and index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    return fn(*args, torch.cuda.current_stream(device).cuda_stream)


def _check(x, weight, *rest):
    """x float32 or bfloat16 of at least one dim, the other tensors float32
    on x's device; raises otherwise."""
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() == 0 or x.shape[-1] == 0:
        raise ValueError(f"x needs a non-empty last dim, got {tuple(x.shape)}")
    if weight.shape != (x.shape[-1],):
        raise ValueError(f"weight of shape {tuple(weight.shape)} for rows "
                         f"of {x.shape[-1]}")
    for t in (weight, *rest):
        if t.dtype != torch.float32 or t.device != x.device:
            raise TypeError(f"expected float32 on {x.device}, got {t.dtype} "
                            f"on {t.device}")


def _fwd_cuda(x, weight, bias, eps):
    """The forward kernel, counted in ``layer_norm.launches``."""
    _check(x, weight, bias)
    x = _aligned(x.contiguous())
    weight, bias = weight.contiguous(), bias.contiguous()
    c = x.shape[-1]
    rows = x.numel() // c
    y = torch.empty_like(x)
    mean = torch.empty(x.shape[:-1], dtype=torch.float32, device=x.device)
    rstd = torch.empty_like(mean)
    if rows == 0:
        return y, mean, rstd
    fn = _entry("layer_norm_fwd", [ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p])
    rc = _call(fn, x.device, x.data_ptr(), weight.data_ptr(),
               bias.data_ptr(), y.data_ptr(), mean.data_ptr(),
               rstd.data_ptr(), rows, c, eps, _DTYPE_CODE[x.dtype])
    if rc != 0:
        raise RuntimeError(f"layer_norm_fwd launch failed: CUDA error {rc}")
    layer_norm.launches += 1
    return y, mean, rstd


def _parts(device, rows):
    """Rows of the backward's partial-sum scratch: at most the blocks the
    card holds at once (the kernel takes no more)."""
    sms = _SMS.get(device)
    if sms is None:
        sms = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return min(rows, _PARTS_PER_SM * sms)


def _bwd_cuda(x, weight, mean, rstd, g):
    """The backward's two kernels, counted in
    ``layer_norm_backward.launches``."""
    _check(x, weight, mean, rstd)
    if g.dtype != x.dtype or g.shape != x.shape or g.device != x.device:
        raise ValueError(f"g must be {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}, got {g.dtype} {tuple(g.shape)}")
    if mean.shape != x.shape[:-1] or rstd.shape != x.shape[:-1]:
        raise ValueError("mean and rstd must hold one value per row of x")
    x, g = _aligned(x.contiguous()), _aligned(g.contiguous())
    weight, mean, rstd = (t.contiguous() for t in (weight, mean, rstd))
    c = x.shape[-1]
    rows = x.numel() // c
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(weight), torch.zeros_like(weight)
    parts = _parts(x.device, rows)
    part = torch.empty((parts, 2, c), dtype=torch.float32, device=x.device)
    dw = torch.empty_like(weight)
    db = torch.empty_like(weight)
    fn = _entry("layer_norm_bwd", [ctypes.c_void_p] * 9 + [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    rc = _call(fn, x.device, x.data_ptr(), weight.data_ptr(),
               mean.data_ptr(), rstd.data_ptr(), g.data_ptr(), dx.data_ptr(),
               dw.data_ptr(), db.data_ptr(), part.data_ptr(), parts, rows, c,
               _DTYPE_CODE[x.dtype])
    if rc != 0:
        raise RuntimeError(f"layer_norm_bwd launch failed: CUDA error {rc}")
    layer_norm_backward.launches += 2
    return dx, dw, db


def _fwd_cpu(x, weight, bias, eps):
    return tuple(t.contiguous() for t in layer_norm_reference(
        x, weight, bias, eps))


def _bwd_cpu(x, weight, mean, rstd, g):
    return tuple(t.contiguous() for t in layer_norm_backward_reference(
        x, weight, mean, rstd, g))


def _fwd_fake(x, weight, bias, eps):
    stat = x.new_empty(x.shape[:-1], dtype=torch.float32)
    return x.new_empty(x.shape), stat, stat.new_empty(stat.shape)


def _bwd_fake(x, weight, mean, rstd, g):
    return (x.new_empty(x.shape), weight.new_empty(weight.shape),
            weight.new_empty(weight.shape))


def _fwd_setup(ctx, inputs, output):
    x, weight, _, _ = inputs
    _, mean, rstd = output
    ctx.save_for_backward(x, weight, mean, rstd)
    # mean and rstd carry no gradient (they are the backward's inputs): no
    # zero-filled gradients are made for them, two launches a call
    ctx.mark_non_differentiable(mean, rstd)
    ctx.set_materialize_grads(False)


def _fwd_backward(ctx, g, _g_mean, _g_rstd):
    if g is None:
        return None, None, None, None
    x, weight, mean, rstd = ctx.saved_tensors
    dx, dw, db = layer_norm_backward(x, weight, mean, rstd, g.to(x.dtype))
    return dx, dw, db, None


_LIB = torch.library.Library("mlaff", "FRAGMENT")
_LIB.define("layer_norm_fwd(Tensor x, Tensor weight, Tensor bias, float eps)"
            " -> (Tensor y, Tensor mean, Tensor rstd)")
_LIB.define("layer_norm_bwd(Tensor x, Tensor weight, Tensor mean, "
            "Tensor rstd, Tensor g) -> (Tensor dx, Tensor dweight, "
            "Tensor dbias)")
_LIB.impl("layer_norm_fwd", _fwd_cpu, "CPU")
_LIB.impl("layer_norm_fwd", _fwd_cuda, "CUDA")
_LIB.impl("layer_norm_bwd", _bwd_cpu, "CPU")
_LIB.impl("layer_norm_bwd", _bwd_cuda, "CUDA")
torch.library.register_fake("mlaff::layer_norm_fwd", _fwd_fake, lib=_LIB)
torch.library.register_fake("mlaff::layer_norm_bwd", _bwd_fake, lib=_LIB)
torch.library.register_autograd("mlaff::layer_norm_fwd", _fwd_backward,
                                setup_context=_fwd_setup, lib=_LIB)


def layer_norm(x, weight, bias, eps: float = 1e-5):
    """``LayerNormFp32`` of ``x`` over its last dim, differentiable in x,
    weight and bias, through the op ``mlaff::layer_norm_fwd``: one kernel
    on a CUDA tensor, the plain expression on the CPU. ``layer_norm.calls``
    counts the calls, ``.launches`` the kernels launched. A row whose last
    dim is not contiguous (PatchEmbed's transposed tokens) is copied to
    contiguous rows first: one copy kernel, saved for the backward in
    place of x."""
    layer_norm.calls += 1
    return torch.ops.mlaff.layer_norm_fwd(x.contiguous(), weight, bias,
                                          eps)[0]


layer_norm.calls = 0
layer_norm.launches = 0


def layer_norm_backward(x, weight, mean, rstd, g):
    """``(dx, dweight, dbias)`` of :func:`layer_norm` from the forward's
    statistics and the output gradient ``g``, through the op
    ``mlaff::layer_norm_bwd``: on a CUDA tensor two kernel launches, on a
    CPU tensor :func:`layer_norm_backward_reference`.
    ``layer_norm_backward.calls`` counts the calls, ``.launches`` the
    kernels launched."""
    layer_norm_backward.calls += 1
    return torch.ops.mlaff.layer_norm_bwd(x, weight, mean, rstd, g)


layer_norm_backward.calls = 0
layer_norm_backward.launches = 0
