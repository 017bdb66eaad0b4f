"""The port's fused kernels against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; the JAX side runs
``fused_cluster_attention`` / ``fused_cluster_merge`` in Pallas interpret
mode, as the JAX package's own tests do. The tests marked ``cuda`` hold
the CUDA kernels against their plain versions on the card and skip where
there is none (a CUDA kernel has no CPU mode).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_autofocusformermod_tpu.ops.clusten_pallas import (
    fused_cluster_attention as jax_attention,
)
from ml_autofocusformermod_tpu.ops.merge_pallas import (
    fused_cluster_merge as jax_merge,
)
from ml_autofocusformermod_tpu.ops.sfc import (
    grid_cluster, grid_nearest_clusters,
)
from ml_autofocusformermod_torch.ops.cluster_attention import (
    cluster_attention_reference, fused_cluster_attention, tile_metadata,
)
from ml_autofocusformermod_torch.ops.cluster_merge import (
    cluster_merge_reference, fused_cluster_merge,
)

torch.set_num_threads(1)
ATOL, RTOL = 1e-5, 1e-4  # fp32 envelope of tests/test_pallas_kernel.py:453


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# ---------------------------------------------------------------- merge ----

def _merge_case(b, n, n_, c, cs, nnc, ic=4, seed=0):
    rng = np.random.default_rng(seed)
    k = -(-n // cs)
    weights = rng.standard_normal((b, n_, nnc * cs, ic)).astype(np.float32)
    feat = rng.standard_normal((b, n, c)).astype(np.float32)
    ncc = rng.integers(0, k, size=(b, n_, nnc)).astype(np.int32)
    return weights, feat, ncc


# the cases of tests/test_merge_pallas.py:41-45: stage-1-like (aligned),
# odd n', padded last cluster (cs does not divide n)
MERGE_CASES = [
    (2, 64, 16, 32, 8, 3),
    (1, 48, 12, 16, 4, 2),
    (2, 52, 12, 8, 8, 3),
]


@pytest.mark.parametrize("b,n,n_,c,cs,nnc", MERGE_CASES)
def test_merge_matches_jax(b, n, n_, c, cs, nnc):
    weights, feat, ncc = _merge_case(b, n, n_, c, cs, nnc)
    with jax.default_matmul_precision("highest"):
        ref = jax_merge(jnp.asarray(weights), jnp.asarray(feat),
                        jnp.asarray(ncc), cs)
    before = fused_cluster_merge.launches
    out = fused_cluster_merge(torch.from_numpy(weights),
                              torch.from_numpy(feat), torch.from_numpy(ncc), cs)
    assert fused_cluster_merge.launches == before  # CPU: plain version
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=RTOL)


# ------------------------------------------------------------ attention ----

H, CS, C_ = 2, 8, 16


def _token_major(x):
    b, h, n, c_ = x.shape
    return x.transpose(0, 2, 1, 3).reshape(b, n, h * c_)


def _attention_inputs(rng, b, n, ncc, pos):
    q = rng.standard_normal((b, H, n, C_)).astype(np.float32)
    k = rng.standard_normal((b, H, n, C_)).astype(np.float32)
    v = rng.standard_normal((b, H, n, C_)).astype(np.float32)
    kv = np.stack([k, v], axis=3).transpose(0, 2, 1, 3, 4).reshape(
        b, n, H * 2 * C_)
    return dict(
        q=_token_major(q), kv=np.ascontiguousarray(kv), ncc=ncc, pos=pos,
        pe_kernel=(rng.standard_normal((5, H)) * 0.1).astype(np.float32),
        pe_bias=(rng.standard_normal((H,)) * 0.1).astype(np.float32),
        blank_k=(rng.standard_normal((C_, H)) * 0.5).astype(np.float32),
        blank_v=(rng.standard_normal((H, C_)) * 0.5).astype(np.float32),
    )


def _run_both(args, rel_width, clamp_width=0, **jax_kw):
    names = ["q", "kv", "ncc", "pos", "pe_kernel", "pe_bias", "blank_k",
             "blank_v"]
    with jax.default_matmul_precision("highest"):
        ref = jax_attention(*(jnp.asarray(args[k]) for k in names), H, CS,
                            rel_width, clamp_width, **jax_kw)
    before = fused_cluster_attention.launches
    t = [torch.from_numpy(args[k]) for k in names]
    out = fused_cluster_attention(*t, H, CS, rel_width, clamp_width,
                                  meta=tile_metadata(t[2]))
    assert fused_cluster_attention.launches == before  # CPU: plain version
    return out.numpy(), np.asarray(ref)


def test_attention_on_grid_matches_jax():
    """16x16 on-grid stage (cs 8, nnc 3, h 2, c_ 16) with host-constant
    neighbours: the JAX side takes its windowed route
    (tests/test_pallas_kernel.py:476-487)."""
    rng = np.random.default_rng(0)
    b, hw, nnc, R = 2, 16, 3, 55
    n = hw * hw
    g_pos = grid_cluster(hw, hw, CS)[0]
    g_ncc = grid_nearest_clusters(hw, hw, CS, nnc)
    pos = np.broadcast_to(g_pos[None], (b, n, 2)).astype(np.float32)
    ncc = np.broadcast_to(g_ncc[None], (b, n, nnc)).astype(np.int32)
    args = _attention_inputs(rng, b, n, ncc, pos)
    out, ref = _run_both(args, R, static_ncc=g_ncc, static_pos=g_pos)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def _off_grid(rng, b, n, nnc, hw=28):
    k = -(-n // CS)
    ncc = np.argsort(rng.uniform(size=(b, n, k)), axis=-1)[:, :, :nnc]
    pos = rng.integers(0, hw, size=(b, n, 2)).astype(np.float32)
    return ncc.astype(np.int32), pos


def test_attention_off_grid_padded_matches_jax():
    """n = 196 is not a multiple of cs: the last cluster has 4 padded slots,
    excluded from the softmax (the JAX side takes its stacked route)."""
    rng = np.random.default_rng(1)
    ncc, pos = _off_grid(rng, 2, 196, 3)
    args = _attention_inputs(rng, 2, 196, ncc, pos)
    out, ref = _run_both(args, 27)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)


def test_attention_clamp_width_matches_jax():
    """MixRes clamp of the table-frame coordinates (clamp_width > 0) with
    offsets well beyond the table, so the clamp changes the bias."""
    rng = np.random.default_rng(2)
    ncc, pos = _off_grid(rng, 2, 128, 3, hw=40)
    args = _attention_inputs(rng, 2, 128, ncc, pos)
    out, ref = _run_both(args, 4, clamp_width=9)
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=RTOL)
    unclamped, _ = _run_both(args, 4, clamp_width=0)
    assert np.abs(unclamped - out).max() > 1e-3


# -------------------------------------------------- on the card (cuda) ----

def _to(args, dev, dtype):
    out = {}
    for k, v in args.items():
        t = torch.from_numpy(np.ascontiguousarray(v)).to(dev)
        out[k] = t.to(dtype) if k in ("q", "kv", "g") else t
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_matches_plain_on_card(cuda_device, dtype):
    rng = np.random.default_rng(3)
    ncc, pos = _off_grid(rng, 2, 196, 6)
    args = _to(_attention_inputs(rng, 2, 196, ncc, pos), cuda_device, dtype)
    names = ["q", "kv", "ncc", "pos", "pe_kernel", "pe_bias", "blank_k",
             "blank_v"]
    out = fused_cluster_attention(*(args[k] for k in names), H, CS, 27)
    ref = cluster_attention_reference(*(args[k] for k in names), H, CS, 27)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    err = (out.float() - ref.float()).abs().max().item()
    assert out.dtype == dtype
    assert err <= tol * ref.float().abs().max().item()


def _stress_case(name, seed):
    """The attention stress shapes of ``chip_smoke.py`` (b = 1): n = 1921
    with clamp_width 9 and h = 8, c_ = 32; cs = 1 with nnc = 48; random
    ncc, whose 64-query tile unions hold most of the image's clusters and
    so span several shared-memory chunks; AFF-Base-384's cs = 24 with
    nnc = 6 (m = 144); heads wider than a staged tile (c_ = 556 and 1440,
    the widest the one-warp kernels took); and m = 760 with cs = 40, whose
    rows list clusters more than once. Returns (inputs, h, cs, R,
    clamp_width)."""
    rng = np.random.default_rng(seed)
    n, h, c_, cs, nnc, R, clamp = {
        "n1921_clamp9": (1921, 8, 32, 8, 6, 4, 9),
        "cs1_nnc48": (196, 4, 32, 1, 48, 27, 0),
        "random_ncc": (784, 4, 32, 8, 6, 27, 0),
        "aff_base384": (2304, 8, 32, 24, 6, 95, 0),
        "wide_c556": (196, 2, 556, 8, 6, 27, 0),
        "wide_c1440": (196, 1, 1440, 8, 6, 27, 0),
        "m760_repeats": (990, 2, 16, 40, 19, 27, 0),
    }[name]
    k = -(-n // cs)
    if name.endswith("repeats"):  # drawn with replacement
        ncc = rng.integers(0, k, size=(1, n, nnc))
    else:
        ncc = np.argsort(rng.uniform(size=(1, n, k)), axis=-1)[:, :, :nnc]
    c = h * c_
    a = dict(
        q=rng.standard_normal((1, n, c)).astype(np.float32) * c_**-0.5,
        kv=rng.standard_normal((1, n, 2 * c)).astype(np.float32),
        ncc=ncc.astype(np.int32),
        pos=rng.integers(0, 56, size=(1, n, 2)).astype(np.float32),
        pe_kernel=(rng.standard_normal((5, h)) * 0.1).astype(np.float32),
        pe_bias=(rng.standard_normal((h,)) * 0.1).astype(np.float32),
        blank_k=(rng.standard_normal((c_, h)) * 0.5).astype(np.float32),
        blank_v=(rng.standard_normal((h, c_)) * 0.5).astype(np.float32),
        g=rng.standard_normal((1, n, c)).astype(np.float32),
    )
    return a, h, cs, R, clamp


STRESS = ["n1921_clamp9", "cs1_nnc48", "random_ncc", "aff_base384",
          "wide_c556", "wide_c1440", "m760_repeats"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", STRESS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernel_stress_shapes_on_card(cuda_device, dtype, name):
    a, h, cs, R, clamp = _stress_case(name, 11)
    args = _to(a, cuda_device, dtype)
    names = ["q", "kv", "ncc", "pos", "pe_kernel", "pe_bias", "blank_k",
             "blank_v"]
    before = fused_cluster_attention.launches
    out = fused_cluster_attention(*(args[k] for k in names), h, cs, R, clamp)
    plain = dict(args, q=args["q"].float(), kv=args["kv"].float())
    ref = cluster_attention_reference(*(plain[k] for k in names), h, cs, R,
                                      clamp)
    torch.cuda.synchronize()
    assert fused_cluster_attention.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    err = (out.float() - ref).abs().max().item()
    assert out.dtype == dtype
    assert err <= tol * ref.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_kernel_matches_plain_on_card(cuda_device, dtype):
    weights, feat, ncc = _merge_case(2, 52, 12, 40, 8, 3)
    w = torch.from_numpy(weights).to(cuda_device, dtype)
    f = torch.from_numpy(feat).to(cuda_device, dtype)
    nc = torch.from_numpy(ncc).to(cuda_device)
    out = fused_cluster_merge(w, f, nc, 8)
    ref = cluster_merge_reference(w.float(), f.float(), nc, 8)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    err = (out.float() - ref).abs().max().item()
    assert err <= tol * ref.abs().max().item()


def _merge_stress_case(name, seed):
    """The merge stress shapes of ``chip_smoke.py`` (b = 2): m = 760 (cs =
    40, nnc = 19) with clusters listed twice, which the one-thread-row
    forward refused (shared memory over 48 KB); random ncc, where some
    clusters are named by many centres and some by none; AFF-Base-384's
    first merge (n = 9216, cs = 24), whose f32 image does not fit in
    shared memory; AFF-Base's third merge (c = 512, a padded last
    cluster); and AFF-Mini's first merge at b = 1. Returns (weights, feat,
    ncc, g, cs) as numpy arrays."""
    rng = np.random.default_rng(seed)
    b, n, n_, c, cs, nnc = {
        "merge_m760_repeats": (2, 990, 247, 32, 40, 19),
        "merge_random_ncc": (2, 784, 196, 128, 8, 6),
        "merge_aff_base384": (2, 9216, 2304, 128, 24, 6),
        "merge_base_c512": (2, 196, 49, 512, 8, 6),
        "merge_b1": (1, 3136, 784, 32, 8, 6),
    }[name]
    k = -(-n // cs)
    if name == "merge_m760_repeats":  # drawn with replacement
        ncc = rng.integers(0, k, size=(b, n_, nnc))
    elif name == "merge_random_ncc":  # odds falling as (id + 1)^-2
        odds = np.arange(1, k + 1, dtype=np.float64) ** -2
        ncc = np.stack([rng.choice(k, nnc, replace=False, p=odds / odds.sum())
                        for _ in range(b * n_)]).reshape(b, n_, nnc)
    else:
        ncc = np.argsort(rng.uniform(size=(b, n_, k)), -1)[..., :nnc]
    weights = rng.standard_normal((b, n_, nnc * cs, 4)).astype(np.float32)
    feat = rng.standard_normal((b, n, c)).astype(np.float32)
    g = rng.standard_normal((b, n_, 4, c)).astype(np.float32)
    return weights, feat, ncc.astype(np.int32), g, cs


MERGE_STRESS = ["merge_m760_repeats", "merge_random_ncc", "merge_aff_base384",
                "merge_base_c512", "merge_b1"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", MERGE_STRESS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_kernel_stress_shapes_on_card(cuda_device, dtype, name):
    """Every merge stress shape runs and agrees with the plain version; m
    = 760 was refused by the forward before its redesign (ROADMAP C3)."""
    weights, feat, ncc, _, cs = _merge_stress_case(name, 13)
    w = torch.from_numpy(weights).to(cuda_device, dtype)
    f = torch.from_numpy(feat).to(cuda_device, dtype)
    nc = torch.from_numpy(ncc).to(cuda_device)
    before = fused_cluster_merge.launches
    out = fused_cluster_merge(w, f, nc, cs)
    ref = cluster_merge_reference(w.float(), f.float(), nc, cs)
    torch.cuda.synchronize()
    assert fused_cluster_merge.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    err = (out.float() - ref).abs().max().item()
    assert out.dtype == dtype
    assert err <= tol * ref.abs().max().item()
