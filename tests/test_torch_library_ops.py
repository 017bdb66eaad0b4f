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
  tiny shape, equal to ``FlopCounterMode`` over the plain versions.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from ml_autofocusformermod_torch.ops.cluster_attention import (
    cluster_attention_backward_reference, cluster_attention_reference,
    fused_cluster_attention, tile_metadata,
)
from ml_autofocusformermod_torch.ops.cluster_merge import (
    cluster_merge_backward_reference, cluster_merge_reference,
    fused_cluster_merge, merge_inverse_index_reference,
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
