"""The fused kernels as dispatcher ops (namespace ``mlaff``), on the CPU.

* ``torch.library.opcheck`` on each op: the attention forward in its four
  modes (statistics or not, dropout or not), the attention backward in
  both modes, the merge forward, the merge backward and the inverse
  index. Every check opcheck makes by default runs (``test_schema``,
  ``test_autograd_registration``, ``test_faketensor``,
  ``test_aot_dispatch_dynamic``); none is left out;
* the ops against the plain versions the old wrappers called, bit for
  bit, at a tiny AFF shape and a tiny MixRes shape (the rel-pos clamp):
  the forward outputs and statistics, and the gradients that autograd
  takes through the ops' formulas against the plain backwards called
  directly;
* the flop formulas that ``utils/flops.py`` registers: a hand count at one
  tiny shape, equal to ``FlopCounterMode`` over the plain versions;
* the LayerNorm ops (``mlaff::layer_norm_fwd``, ``_bwd``): opcheck, and
  the plain backward against autograd of ``LayerNormFp32``'s expression,
  in bf16 and f32 at widths 1 to 2048, with a constant row, rows whose
  variance clamps and transposed (non-contiguous) rows; the card check's
  tolerances (``time_kernels.layer_norm_gaps``) against the plain
  expression and its float64 evaluation.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from ml_autofocusformermod_torch.ops.cluster_attention import (
    cluster_attention_backward_reference, cluster_attention_reference,
    fused_cluster_attention, tile_metadata,
)
from ml_autofocusformermod_torch.models.layers import LayerNormFp32
from ml_autofocusformermod_torch.ops.cluster_merge import (
    cluster_merge_backward_reference, cluster_merge_reference,
    fused_cluster_merge, merge_inverse_index_reference,
)
from ml_autofocusformermod_torch.ops.layer_norm import (
    layer_norm, layer_norm_backward, layer_norm_backward_reference,
    layer_norm_reference,
)
from ml_autofocusformermod_torch.time_kernels import (
    layer_norm_case, layer_norm_gaps,
)
from ml_autofocusformermod_torch.utils import flops

torch.set_num_threads(1)
OPS = torch.ops.mlaff
# (name, b, n, heads, c_, cs, nnc, rel_width, clamp_width)
SHAPES = [("aff", 2, 52, 2, 8, 4, 3, 55, 0),
          ("mixres", 2, 43, 2, 8, 1, 9, 511, 1023)]


def _attention_case(shape, dtype=torch.float32, seed=0):
    _, b, n, h, c_, cs, nnc, R, clamp = shape
    rng = np.random.default_rng(seed)
    c = h * c_
    k = -(-n // cs)
    ncc = np.stack([rng.permutation(k)[:nnc] for _ in range(b * n)])
    t = {"q": rng.standard_normal((b, n, c)) * 0.5,
         "kv": rng.standard_normal((b, n, 2 * c)),
         "pe_kernel": rng.standard_normal((5, h)) * 0.1,
         "pe_bias": rng.standard_normal(h), "blank_k": rng.standard_normal((c_, h)),
         "blank_v": rng.standard_normal((h, c_)),
         "g": rng.standard_normal((b, n, c))}
    t = {k_: torch.from_numpy(v).to(dtype) for k_, v in t.items()}
    t["ncc"] = torch.from_numpy(ncc.reshape(b, n, nnc).astype(np.int32))
    t["pos"] = torch.from_numpy(
        rng.integers(0, 40, (b, n, 2)).astype(np.float32))
    return t, (h, cs, R, clamp)


ARGS = ("q", "kv", "ncc", "pos", "pe_kernel", "pe_bias", "blank_k",
        "blank_v")


def _merge_case(b=2, n=26, n_=7, c=6, cs=4, nnc=3, dtype=torch.float32,
                seed=1):
    rng = np.random.default_rng(seed)
    k = -(-n // cs)
    ncc = np.stack([rng.permutation(k)[:nnc] for _ in range(b * n_)])
    w = torch.from_numpy(rng.standard_normal((b, n_, nnc * cs, 4))).to(dtype)
    f = torch.from_numpy(rng.standard_normal((b, n, c))).to(dtype)
    g = torch.from_numpy(rng.standard_normal((b, n_, 4, c))).to(dtype)
    return w, f, torch.from_numpy(ncc.reshape(b, n_, nnc).astype(np.int32)), \
        cs, g


@pytest.mark.parametrize("want_stats", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_opcheck_attention_forward(want_stats, rate):
    t, (h, cs, R, clamp) = _attention_case(SHAPES[0], torch.float64)
    args = [t[k] for k in ARGS]
    for i in (0, 1, 4, 5, 6, 7):
        args[i] = args[i].requires_grad_(True)
    torch.library.opcheck(OPS.cluster_attention_fwd.default, (
        *args, *tile_metadata(t["ncc"]), h, cs, R, clamp, rate, 7,
        want_stats))


@pytest.mark.parametrize("saved", [False, True])
def test_opcheck_attention_backward(saved):
    t, (h, cs, R, clamp) = _attention_case(SHAPES[1], torch.float64)
    args = [t[k] for k in ARGS]
    out = stats = None
    if saved:
        out, stats = cluster_attention_reference(*args, h, cs, R, clamp,
                                                 want_stats=True)
    torch.library.opcheck(OPS.cluster_attention_bwd.default, (
        *args, *tile_metadata(t["ncc"]), t["g"], out, stats, h, cs, R, clamp,
        0.0, 0))


def test_opcheck_merge_ops():
    w, f, ncc, cs, g = _merge_case(dtype=torch.float64)
    torch.library.opcheck(OPS.cluster_merge_fwd.default, (
        w.requires_grad_(True), f.requires_grad_(True), ncc, cs))
    torch.library.opcheck(OPS.cluster_merge_bwd.default, (
        w.detach(), f.detach(), ncc, cs, g))
    torch.library.opcheck(OPS.merge_inverse_index.default, (ncc, 26, cs))


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
@pytest.mark.parametrize("rate", [0.0, 0.25])
def test_attention_op_equals_the_plain_versions_bit_for_bit(shape, rate,
                                                            monkeypatch):
    """The op's outputs, and the gradients autograd takes through it in
    both backward modes, against the plain versions called directly."""
    t, geo = _attention_case(shape)
    args = [t[k] for k in ARGS]
    drop = (rate, 11) if rate else None
    meta = tile_metadata(t["ncc"])
    out, stats = OPS.cluster_attention_fwd(*args, *meta, *geo, rate, 11,
                                           True)
    want, want_stats = cluster_attention_reference(
        *args, *geo, drop=drop, want_stats=True)
    assert torch.equal(out, want) and torch.equal(stats, want_stats)
    for flag in ("1", "0"):  # the saved-stats and the recompute backward
        monkeypatch.setenv("MLAFF_BWD_SAVED", flag)
        leaves = [a.clone().requires_grad_(i in (0, 1, 4, 5, 6, 7))
                  for i, a in enumerate(args)]
        got = fused_cluster_attention(*leaves, *geo, drop_rate=rate,
                                      drop_seed=11 if rate else None)
        assert torch.equal(got, want)
        got.backward(t["g"])
        ref = cluster_attention_backward_reference(
            *args, t["g"], *geo, drop=drop,
            saved=(want, want_stats) if flag == "1" else None)
        for i, r in zip((0, 1, 4, 5, 6, 7), ref):
            assert torch.equal(leaves[i].grad, r), (flag, ARGS[i])


def test_merge_ops_equal_the_plain_versions_bit_for_bit():
    w, f, ncc, cs, g = _merge_case()
    want = cluster_merge_reference(w, f, ncc, cs)
    wl, fl = w.clone().requires_grad_(True), f.clone().requires_grad_(True)
    got = fused_cluster_merge(wl, fl, ncc, cs)
    assert torch.equal(got, want)
    got.backward(g)
    dw, dfeat = cluster_merge_backward_reference(w, f, ncc, cs, g)
    assert torch.equal(wl.grad, dw) and torch.equal(fl.grad, dfeat)
    got = OPS.merge_inverse_index(ncc, 26, cs)
    assert all(torch.equal(a, b) for a, b in
               zip(got, merge_inverse_index_reference(ncc, 26, cs)))


def test_flop_formulas_match_a_hand_count():
    t, geo = _attention_case(SHAPES[0])
    h, cs = geo[0], geo[1]
    b, n, c = t["q"].shape
    m = t["ncc"].shape[-1] * cs
    # per query: bias 5 x h x m, q.k c x m, q.blank_k c, P.V c x m MACs
    hand = 2 * b * n * (5 * h * m + c * m + c + c * m)
    assert hand == 2 * 2 * 52 * (5 * 2 * 12 + 16 * 12 + 16 + 16 * 12)
    args = [t[k] for k in ARGS]
    with FlopCounterMode(display=False) as op_count:
        fused_cluster_attention(*args, *geo)
    with FlopCounterMode(display=False) as plain_count:
        cluster_attention_reference(*args, *geo)
    assert op_count.get_total_flops() == hand
    assert plain_count.get_total_flops() == hand
    assert flops.attention_flops(t["q"].shape, t["ncc"].shape, h, cs) == hand

    w, f, ncc, cs, _ = _merge_case()
    hand = 2 * 2 * 7 * 12 * 4 * 6  # b n' m ic c
    with FlopCounterMode(display=False) as op_count:
        fused_cluster_merge(w, f, ncc, cs)
    with FlopCounterMode(display=False) as plain_count:
        cluster_merge_reference(w, f, ncc, cs)
    assert op_count.get_total_flops() == plain_count.get_total_flops() == hand


LN_WIDTHS = [1, 4, 32, 384, 2048]
LN_DTYPES = [torch.float32, torch.bfloat16]


def _layer_norm_case(c, dtype, seed=2):
    """(x, weight, bias, g): 2 x 6 rows of ``c``; row (0, 0) constant and,
    in f32, rows (1, 0:4) at 300 plus noise of 1e-3, where ``E[x^2] -
    E[x]^2`` cancels and some rows clamp at 0."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 6, c, generator=gen) * 2 + 0.5
    x[0, 0] = 1.25
    if dtype == torch.float32 and c > 1:
        x[1, :4] = 300 + 1e-3 * torch.randn(4, c, generator=gen)
    w = torch.randn(c, generator=gen)
    b = torch.randn(c, generator=gen)
    g = torch.randn(2, 6, c, generator=gen)
    return x.to(dtype), w, b, g.to(dtype)


@pytest.mark.parametrize("c", [1, 384])
@pytest.mark.parametrize("dtype", LN_DTYPES, ids=["f32", "bf16"])
def test_opcheck_layer_norm(c, dtype):
    x, w, b, g = _layer_norm_case(c, dtype)
    torch.library.opcheck(OPS.layer_norm_fwd.default, (
        x.requires_grad_(True), w.requires_grad_(True),
        b.requires_grad_(True), 1e-5))
    _, mean, rstd = layer_norm_reference(x.detach(), w.detach(), b.detach(),
                                         1e-5)
    torch.library.opcheck(OPS.layer_norm_bwd.default, (
        x.detach(), w.detach(), mean, rstd, g))
    # rows whose last dim is not contiguous, as PatchEmbed hands them over
    xt = x.detach().transpose(1, 2).contiguous().transpose(1, 2)
    assert c == 1 or not xt.is_contiguous()
    torch.library.opcheck(OPS.layer_norm_fwd.default, (
        xt.requires_grad_(True), w.detach(), b.detach(), 1e-5))


def _close_by_row(got, want, mean, rstd, rtol):
    """|got - want| <= rtol * (the row's largest |want|) * (1 + |mean| *
    rstd on rows not clamped) + one rounding of ``want`` in ``got``'s dtype.
    On a row not clamped, autograd of the expression adds ``2 x dvar / C``
    and ``-2 mean dvar / C``: two terms ``|mean| * rstd`` times the
    result's scale that cancel (the rows at 300 + 1e-3 noise)."""
    got, want = got.double(), want.double()
    gain = torch.where(rstd > 0, 1 + mean.abs() * rstd, 1.0)[..., None]
    scale = want.abs().amax(-1, keepdim=True) * gain.double()
    ulp = want.abs() * (2.0 ** -8 if got.dtype == torch.bfloat16 else 0.0)
    return bool(((got - want).abs() <= rtol * scale + ulp).all())


@pytest.mark.parametrize("c", LN_WIDTHS)
@pytest.mark.parametrize("dtype", LN_DTYPES, ids=["f32", "bf16"])
def test_layer_norm_backward_reference_equals_autograd(c, dtype):
    """The op's forward is ``LayerNormFp32``'s CPU expression bit for bit;
    its plain backward equals autograd of that expression. Both are f32
    evaluations of one gradient, ops in another order: dx within 1e-6 of
    its row's largest entry (a few f32 roundings of the row's largest
    term, :func:`_close_by_row`), plus one rounding to bf16 where dx is
    bf16; dweight and dbias, the same sums in the same order, equal. The
    clamped rows drop the variance's path as autograd of ``clamp_min``
    does, and the transposed case runs through ``layer_norm``, as the
    model calls it."""
    x, w, b, g = _layer_norm_case(c, dtype)
    norm = LayerNormFp32(c)
    with torch.no_grad():
        norm.weight.copy_(w)
        norm.bias.copy_(b)
    for transposed in (False, True):
        xin = (x.transpose(1, 2).contiguous().transpose(1, 2)
               if transposed else x)
        xl = xin.clone().requires_grad_(True)
        norm.zero_grad()
        y = norm(xl)
        y.backward(g)
        want_y, mean, rstd = layer_norm_reference(xin, w, b, norm.eps)
        assert torch.equal(y, want_y)
        if dtype == torch.float32 and c > 1:
            clamped = (rstd < 0).sum().item()
            assert 0 < clamped < rstd.numel()
        dx, dw, db = layer_norm_backward_reference(xin, w, mean, rstd, g)
        assert dx.dtype == dtype and dw.dtype == db.dtype == torch.float32
        assert _close_by_row(dx, xl.grad, mean, rstd, 1e-6)
        assert torch.equal(dw, norm.weight.grad)
        assert torch.equal(db, norm.bias.grad)
        # the op's autograd formula is the plain backward, on the
        # contiguous rows that layer_norm hands the op (a CPU sum over
        # transposed rows takes another order)
        want_y, mean, rstd = layer_norm_reference(xin.contiguous(), w, b,
                                                  norm.eps)
        dx, dw, db = layer_norm_backward_reference(xin.contiguous(), w, mean,
                                                   rstd, g)
        xo = xin.clone().requires_grad_(True)
        wo, bo = w.clone().requires_grad_(True), b.clone().requires_grad_(True)
        calls = layer_norm.calls, layer_norm_backward.calls
        launches = layer_norm.launches, layer_norm_backward.launches
        yo = layer_norm(xo, wo, bo, norm.eps)
        yo.backward(g)
        assert torch.equal(yo, want_y)
        assert torch.equal(xo.grad, dx)
        assert torch.equal(wo.grad, dw) and torch.equal(bo.grad, db)
        assert (layer_norm.calls, layer_norm_backward.calls) == (
            calls[0] + 1, calls[1] + 1)
        assert (layer_norm.launches, layer_norm_backward.launches) == \
            launches  # CPU: plain


@pytest.mark.parametrize("c", [2, 3] + LN_WIDTHS)
@pytest.mark.parametrize("dtype", LN_DTYPES, ids=["f32", "bf16"])
def test_layer_norm_gaps_hold_for_the_plain_expression(c, dtype):
    """The card's check, ``time_kernels.layer_norm_gaps``, on the CPU: the
    op's plain forward and backward against autograd of the expression,
    and the witness for its tolerances: on rows from N(0, 1), near-constant
    rows and constant rows (E[x^2] up to 1e5 times ``var + eps``), the
    plain f32 expression sits within the condition-scaled tolerance of the
    expression in float64."""
    x, w, b, g = layer_norm_case(300, c, dtype, "cpu", seed=c)
    gaps = layer_norm_gaps(x, w, b, g)
    assert gaps["kappa_max"] > 1000
    assert gaps["max_abs_err"] == 0.0  # the op's CPU forward is the expression
    assert all(gaps[k] <= 1 for k in ("mean", "rstd", "y", "dx", "dw", "db",
                                      "kernel_vs_f64", "plain_vs_f64"))
