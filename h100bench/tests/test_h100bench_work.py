"""``work.py`` against the formulas it copies (``chip_smoke.py``'s
``attn_work``, ``attn_bwd_work``, ``merge_work``, ``merge_bwd_work``) at
the four cells' shapes, and each configuration's stored flops per image
against the reference's and the port's count."""

import json
from pathlib import Path

import pytest
import torch

from h100bench import reference, work

ROOT = Path(__file__).resolve().parents[2]


def _arg(t):
    return work.Arg(tuple(t.shape), t.element_size(), tuple(t.stride()),
                    str(t.dtype).replace("torch.", ""))


def _distinct_ncc(rows, n, nnc, k):
    """Each row's ``nnc`` distinct clusters, the last (padded) one first,
    as a kNN gives them."""
    ids = torch.cat([torch.tensor([k - 1]), torch.arange(nnc - 1)])
    return ids.to(torch.int32).expand(rows, n, nnc).contiguous()


def _stage(b, n, c, h, nnc, cs, dtype, broadcast_ncc):
    k = -(-n // cs)
    # every query reads the padded last cluster
    ncc = _distinct_ncc(1 if broadcast_ncc else b, n, nnc, k)
    if broadcast_ncc:
        ncc = ncc.expand(b, n, nnc)
    return dict(
        q=torch.zeros(b, n, c, dtype=dtype),
        kv=torch.zeros(b, n, 2 * c, dtype=dtype), ncc=ncc,
        pos=torch.zeros(b, n, 2), pe_kernel=torch.zeros(5, h),
        pe_bias=torch.zeros(h), blank_k=torch.zeros(c // h, h),
        blank_v=torch.zeros(h, c // h))


# (b, n, c, h, nnc, cs, broadcast ncc): AFF-Mini's stages at the train and
# b128 cells, and one at b1; UD-Mini's local levels at ratio 0.9
SHAPES = [(128, 3136, 32, 2, 6, 8, True), (128, 784, 128, 4, 6, 8, False),
          (128, 196, 256, 8, 6, 8, False), (1, 196, 256, 8, 6, 8, False),
          (128, 181, 192, 6, 6, 8, False), (128, 668, 128, 4, 6, 8, False),
          (16, 2470, 64, 2, 6, 8, False)]


@pytest.mark.parametrize("shape", SHAPES)
def test_attention_work_matches_chip_smoke(shape):
    import chip_smoke

    b, n, c, h, nnc, cs, bc = shape
    a = _stage(b, n, c, h, nnc, cs, torch.bfloat16, bc)
    small = [_arg(a[k]) for k in ("pe_kernel", "pe_bias", "blank_k",
                                  "blank_v")]
    args = [_arg(a[k]) for k in ("q", "kv", "ncc", "pos")]
    moved, flops = work.attention_fwd(*args, small, h, cs)
    ref_moved, ref_flops = chip_smoke.attn_work(torch, a, h, cs)
    assert moved == ref_moved
    assert flops == ref_flops  # every query reads the padded cluster
    g = torch.zeros_like(a["q"])
    moved, flops = work.attention_bwd(*args, small, _arg(g), h, cs)
    ref_moved, ref_flops = chip_smoke.attn_bwd_work(torch, a, g, h, cs)
    assert (moved, flops) == (ref_moved, ref_flops)


def test_attention_flops_are_a_lower_bound():
    import chip_smoke

    b, n, c, h, nnc, cs = 4, 196, 256, 8, 6, 8
    a = _stage(b, n, c, h, nnc, cs, torch.bfloat16, False)
    a["ncc"] = torch.zeros_like(a["ncc"])  # no query reads the padding
    small = [_arg(a[k]) for k in ("pe_kernel", "pe_bias", "blank_k",
                                  "blank_v")]
    args = [_arg(a[k]) for k in ("q", "kv", "ncc", "pos")]
    _, flops = work.attention_fwd(*args, small, h, cs)
    _, ref_flops = chip_smoke.attn_work(torch, a, h, cs)
    assert flops < ref_flops


@pytest.mark.parametrize("b,n,n_,c", [(128, 3136, 784, 32),
                                      (128, 784, 196, 128),
                                      (128, 196, 49, 256), (1, 196, 49, 256)])
def test_merge_work_matches_chip_smoke(b, n, n_, c):
    import chip_smoke

    cs, nnc, ic = 8, 6, 4
    ncc = _distinct_ncc(b, n_, nnc, -(-n // cs))
    w = torch.zeros(b, n_, nnc * cs, ic, dtype=torch.bfloat16)
    feat = torch.zeros(b, n, c, dtype=torch.bfloat16)
    g = torch.zeros(b, n_, ic, c, dtype=torch.bfloat16)
    assert work.merge_fwd(_arg(w), _arg(feat), _arg(ncc), cs) == \
        chip_smoke.merge_work(torch, w, feat, ncc, cs)
    assert work.merge_bwd(_arg(w), _arg(feat), _arg(ncc), _arg(g), cs) == \
        chip_smoke.merge_bwd_work(torch, w, feat, ncc, g, cs)


def test_op_work_reads_recorded_arguments():
    a = _stage(2, 196, 256, 8, 6, 8, torch.bfloat16, False)
    args = [_arg(a[k]) for k in ("q", "kv", "ncc", "pos", "pe_kernel",
                                 "pe_bias", "blank_k", "blank_v")]
    args += [None, None, None, 8, 8, 55, 0, 0.0, 0, True, 0]
    moved, flops, dtype = work.op_work("mlaff::cluster_attention_fwd", args)
    assert (moved, flops) == work.attention_fwd(*args[:4], args[4:8], 8, 8)
    assert dtype == "bfloat16"
    assert work.op_work("mlaff::merge_inverse_index", []) is None
    t = work.least_seconds(moved, flops, dtype)
    assert t == pytest.approx(max(moved / 3.35e12, flops / 989e12))


@pytest.mark.parametrize("name", ["aff_mini", "ud_mini"])
def test_config_flops_per_image(name):
    from ml_autofocusformermod_torch.config import load_config
    from ml_autofocusformermod_torch.models.build import build_model
    from ml_autofocusformermod_torch.train.curriculum import (
        set_upsample_ratios)
    from ml_autofocusformermod_torch.utils.flops import model_complexity

    cfg = json.loads((ROOT / "h100bench/configs" / f"{name}.json")
                     .read_text())
    ref = work.model_flops_per_image(reference.build(cfg["model"]),
                                     cfg["img_size"])
    assert ref == pytest.approx(cfg["gflops_per_image"] * 1e9, rel=1e-9)
    port = build_model(load_config(str(ROOT / cfg["preset"]), opts=[
        "TPU.COMPUTE_DTYPE", "float32"]), device="cpu")
    if "upscale_ratios" in cfg["model"]:
        set_upsample_ratios(port, cfg["model"]["upscale_ratios"])
    assert model_complexity(port, cfg["img_size"])["flops"] == ref


def test_mfu():
    assert work.mfu(1000.0, 2e9, 3) == pytest.approx(6e12 / 989e12)
