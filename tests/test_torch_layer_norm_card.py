"""The LayerNorm kernels (``csrc/layer_norm.cu``, ops ``mlaff::layer_norm_*``)
on the card (marker ``cuda``; skips without an NVIDIA GPU), against
``LayerNormFp32``'s plain expression run by PyTorch on the same card.

This file imports no JAX, so it runs where the card is and JAX is not,
without the suite's ``conftest.py`` (which imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_layer_norm_card.py
"""

import os

import pytest
import torch

from ml_autofocusformermod_torch.config import load_config
from ml_autofocusformermod_torch.models.build import build_model
from ml_autofocusformermod_torch.models.layers import LayerNormFp32
from ml_autofocusformermod_torch.ops.layer_norm import (
    layer_norm, layer_norm_backward, layer_norm_backward_reference,
)
from ml_autofocusformermod_torch.time_kernels import (
    layer_norm_case as _case, layer_norm_gaps,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every width the benchmark's presets build (AFF-Mini, MaskFiner UD-Mini at
# ratio 0.9, AFF-Base-384), then odd widths: each vector width (16, 8, 4
# and 2 bytes), a thread, a warp and 2-8 warps a row, and the general path
# (bf16 above 4096, f32 above 4096, odd widths above 1024)
PRESET_WIDTHS = [4, 32, 64, 128, 192, 256, 320, 384, 448, 512, 1024, 2048]
ODD_WIDTHS = [1, 2, 3, 5, 6, 12, 33, 100, 250, 257, 1000, 1025, 3001, 4100,
              8192]
PRESETS = [("aff_mini.yaml", None, 32),
           ("maskfiner_up_down_mini.yaml", [0.0, 0.9, 0.9, 0.9, 0.0, 0.0,
                                            0.0], 76),
           ("aff_base_22kto1k_384.yaml", None, 62)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the LayerNorm kernels are the "
                    "card's")
    return torch.device("cuda")


def _max_gap(got, want, scale):
    """The largest |got - want| over ``scale`` (broadcast; an equal entry
    counts 0 where its scale is 0)."""
    gap = (got.double() - want.double()).abs()
    return torch.where(gap == 0, 0.0, gap / scale).max().item()


def _dx_scale(x, w, g, mean, rstd):
    """Per row, the size of the terms that dx = r * (dxhat - mean(dxhat) -
    xhat * mean(dxhat * xhat)) adds: r * max|dxhat| * (1 + max|xhat|^2).
    dx itself may be far smaller (a row of 2 has dx = 0 up to rounding)."""
    xhat = (x.double() - mean.double()[:, None]) * rstd.double().abs()[:, None]
    dxhat = (g.double() * w.double()).abs().amax(-1, keepdim=True)
    return (rstd.double().abs()[:, None] * dxhat
            * (1 + xhat.abs().amax(-1, keepdim=True) ** 2))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_layer_norm_kernels_match_the_plain_expression(cuda_device, dtype):
    """Forward and all three gradients of the wrappers (through autograd)
    against autograd of the plain expression on the card, and the
    statistics against the expression in float64, at every preset width
    and the odd ones, on rows from N(0, 1), near-constant rows (E[x^2]
    about 3600 times the variance) and constant rows
    (:func:`layer_norm_case`). The tolerances, and why, are
    :func:`layer_norm_gaps`': 1e-5 of the terms each result sums, scaled
    per row by the condition number of ``E[x^2] - E[x]^2``; the plain f32
    expression must sit as close to float64 as the kernel does."""
    for c in PRESET_WIDTHS + ODD_WIDTHS:
        rows = 3000 if c <= 512 else 300
        x, w, b, g = _case(rows, c, dtype, cuda_device, seed=c)
        gaps = layer_norm_gaps(x, w, b, g)
        assert gaps.pop("kappa_max") > 1000, c  # ill-conditioned rows ran
        gaps.pop("max_abs_err"), gaps.pop("dx_max_abs_err")
        assert max(gaps.values()) <= 1, (c, gaps)
        y, mean, rstd = torch.ops.mlaff.layer_norm_fwd(x, w, b, 1e-5)
        dx, dw, db = torch.ops.mlaff.layer_norm_bwd(x, w, mean, rstd, g)
        assert y.dtype == dx.dtype == dtype
        assert {t.dtype for t in (mean, rstd, dw, db)} == {torch.float32}


@pytest.mark.cuda
def test_layer_norm_clamped_and_constant_rows_on_card(cuda_device):
    """Rows at 300 plus noise of 1e-3 in f32, where ``E[x^2] - E[x]^2``
    cancels and may fall below 0, and constant rows: the kernel's
    statistics mark the rows it clamped (rstd < 0), a constant row of 1.25
    (sums exact at C = 384) has mean 1.25 and variance 0 (not clamped:
    ``clamp_min`` passes the gradient at 0), y = b there, and on the
    clamped rows y equals ``(x - mean) * rsqrt(eps) * w + b`` from the
    kernel's mean. The backward equals the plain backward from the
    kernel's own statistics (the clamp decided once, by the forward),
    within 1e-5 of the terms that make dx (:func:`_dx_scale`), of the
    column's sums of |terms| for dw and db."""
    dev = cuda_device
    gen = torch.Generator().manual_seed(7)
    c = 384
    x = (300 + 1e-3 * torch.randn(512, c, generator=gen)).to(dev)
    x[:4] = 1.25
    w = torch.randn(c, generator=gen).to(dev)
    b = torch.randn(c, generator=gen).to(dev)
    g = torch.randn(512, c, generator=gen).to(dev)
    y, mean, rstd = torch.ops.mlaff.layer_norm_fwd(x, w, b, 1e-5)
    r = torch.full_like(rstd, 1e-5).rsqrt()
    assert torch.equal(mean[:4], torch.full_like(mean[:4], 1.25))
    assert torch.equal(rstd[:4], r[:4])
    assert torch.equal(y[:4], b.expand(4, c))
    clamped = rstd < 0
    assert 0 < int(clamped.sum()) < 508
    assert torch.equal(rstd[clamped].abs(), r[clamped])
    want_y = (x - mean[:, None]) * r[:, None] * w + b
    scale = want_y.abs().amax(-1, keepdim=True).double()
    assert _max_gap(y[clamped], want_y[clamped], 1e-5 * scale[clamped]) <= 1
    dx, dw, db = torch.ops.mlaff.layer_norm_bwd(x, w, mean, rstd, g)
    want_dx, want_dw, want_db = layer_norm_backward_reference(x, w, mean,
                                                              rstd, g)
    assert _max_gap(dx, want_dx, 1e-5 * _dx_scale(x, w, g, mean, rstd)) <= 1
    xhat = (x - mean[:, None]) * rstd.abs()[:, None]
    assert _max_gap(dw, want_dw, 1e-5 * (g * xhat).abs().sum(0)) <= 1
    assert _max_gap(db, want_db, 1e-5 * g.abs().sum(0)) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_layer_norm_backward_is_bitwise_reproducible_and_counted(
        cuda_device, dtype):
    """Two backwards give the same bits (dw and db are summed without
    atomics, in a fixed order); the forward adds one call and one launch
    to ``layer_norm``'s counters, the backward one call and two launches
    to ``layer_norm_backward``'s. The transposed rows of PatchEmbed go
    through a copy, and their result equals the contiguous rows'."""
    for rows, c in ((401408, 32), (4800000 // 8, 4), (576, 2048),
                    (1000, 1025)):
        x, w, b, g = _case(rows, c, dtype, cuda_device, seed=rows + c)
        xl = x.clone().requires_grad_(True)
        wl, bl = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
        before = (layer_norm.calls, layer_norm.launches,
                  layer_norm_backward.calls, layer_norm_backward.launches)
        y = layer_norm(xl, wl, bl)
        y.backward(g)
        torch.cuda.synchronize()
        after = (layer_norm.calls, layer_norm.launches,
                 layer_norm_backward.calls, layer_norm_backward.launches)
        assert tuple(a - b_ for a, b_ in zip(after, before)) == (1, 1, 1, 2)
        _, mean, rstd = torch.ops.mlaff.layer_norm_fwd(x, w, b, 1e-5)
        first = layer_norm_backward(x, w, mean, rstd, g)
        second = layer_norm_backward(x, w, mean, rstd, g)
        for a, b_, name in zip(first, second, ("dx", "dw", "db")):
            assert torch.equal(a, b_), (rows, c, name)
        assert torch.equal(xl.grad, first[0])
        assert torch.equal(wl.grad, first[1]) and torch.equal(bl.grad,
                                                              first[2])
        xt = x.t().contiguous().t()  # rows of stride 1 x rows
        assert torch.equal(layer_norm(xt, w, b), y.detach())


@pytest.mark.cuda
@pytest.mark.parametrize("preset,ratios,calls", PRESETS,
                         ids=[p[0].split(".")[0] for p in PRESETS])
def test_every_layer_norm_of_a_train_step_runs_the_kernels(
        cuda_device, preset, ratios, calls):
    """A training forward and backward of each benchmark preset at b2,
    bf16: every ``LayerNormFp32`` call launches the forward kernel once
    (``calls`` per forward) and, where its output reaches the loss, its
    backward twice; none runs the plain expression, and every width they
    see is one of :data:`PRESET_WIDTHS`. (Three of UD-Mini's 76 outputs do
    not reach the classification loss, so no backward runs for them.)"""
    cfg = load_config(os.path.join(ROOT, "ml_autofocusformermod_torch",
                                   "configs", preset),
                      opts=["TPU.COMPUTE_DTYPE", "bfloat16",
                            "DATA.DATA_PATH", "no_dataset"])
    model = build_model(cfg, cuda_device, seed=0, upscale_ratios=ratios)
    model.train()
    widths, graded = [], []

    def hook(mod, inputs, out):
        widths.append(inputs[0].shape[-1])
        out.register_hook(lambda g: graded.append(g.shape[-1]))

    for m in model.modules():
        if isinstance(m, LayerNormFp32):
            m.register_forward_hook(hook)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain expression ran on the card")

    LayerNormFp32.expression, saved = no_plain, LayerNormFp32.expression
    try:
        before = (layer_norm.launches, layer_norm_backward.launches)
        size = cfg.DATA.IMG_SIZE
        images = torch.randn(2, 3, size, size, device=cuda_device)
        out = model(images)
        outs = out if isinstance(out, (list, tuple)) else [out]
        sum(o.float().square().mean() for o in outs).backward()
        torch.cuda.synchronize()
    finally:
        LayerNormFp32.expression = saved
    assert len(widths) == calls and 0 < len(graded) <= calls
    assert calls - len(graded) == (3 if preset.startswith("maskfiner") else 0)
    assert set(widths) <= set(PRESET_WIDTHS)
    assert (layer_norm.launches - before[0],
            layer_norm_backward.launches - before[1]) == (
                calls, 2 * len(graded))
