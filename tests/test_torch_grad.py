"""Gradients of the port against the JAX package (CPU), and the backward
kernels against their plain versions (card).

* the plain attention backward against ``jax.vjp`` of the JAX
  ``fused_cluster_attention``: its XLA-oracle backward at n = 196 and 49
  (padded last clusters), with and without ``clamp_width``, and its Pallas
  ``_bwd_kernel`` in interpret mode; every gradient, d_blank_v included;
* the plain merge backward against ``jax.vjp`` of ``fused_cluster_merge``
  (Pallas backward in interpret mode);
* each ``autograd.Function`` against ``gradcheck`` in float64 and against
  autograd through its own plain forward;
* the 112^2 AFF of ``tests/test_torch_model.py`` in training mode: loss,
  input gradient, every parameter gradient and the updated BatchNorm
  running stats against ``jax.value_and_grad``;
* guards for the two faults the training slice repaired: gradients that
  stop at the fused ops, and BatchNorm's unbiased running variance.
The tests marked ``cuda`` hold the two backward kernels against their plain
versions, the merge backward at the merge stress shapes too, check that
the merge backward is bitwise reproducible, and skip without a GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_autofocusformermod_torch.ckpt.from_jax import state_dict_from_flax
from ml_autofocusformermod_torch.models.aff import AutoFocusFormer
from ml_autofocusformermod_torch.models.layers import PatchEmbed
from ml_autofocusformermod_torch.ops.cluster_attention import (
    cluster_attention_backward, cluster_attention_backward_reference,
    cluster_attention_reference, fused_cluster_attention,
)
from ml_autofocusformermod_torch.ops.cluster_merge import (
    cluster_merge_backward, cluster_merge_backward_reference,
    cluster_merge_reference, fused_cluster_merge,
)
from ml_autofocusformermod_torch.train.losses import (
    smooth_one_hot, soft_target_cross_entropy,
)
from ml_autofocusformermod_tpu.models.aff import AutoFocusFormer as JaxAFF
from ml_autofocusformermod_tpu.models.layers import PatchEmbed as JaxPatchEmbed
from ml_autofocusformermod_tpu.ops.clusten_pallas import (
    fused_cluster_attention as jax_attention,
)
from ml_autofocusformermod_tpu.ops.merge_pallas import (
    fused_cluster_merge as jax_merge,
)
from ml_autofocusformermod_tpu.ops.sfc import (
    grid_cluster, grid_nearest_clusters,
)
from ml_autofocusformermod_tpu.train.losses import (
    smooth_one_hot as jax_smooth_one_hot,
    soft_target_cross_entropy as jax_soft_target_ce,
)
from test_torch_kernels import (
    MERGE_STRESS, STRESS, _merge_stress_case, _stress_case,
)

torch.set_num_threads(1)
ATOL, RTOL = 1e-5, 1e-4  # fp32 envelope of tests/test_pallas_kernel.py:453
ATTN_GRADS = ["q", "kv", "pe_kernel", "pe_bias", "blank_k", "blank_v"]
ATTN_ARGS = ["q", "kv", "ncc", "pos", "pe_kernel", "pe_bias", "blank_k",
             "blank_v"]
H, CS, C_ = 2, 8, 16


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# ------------------------------------------------------------- inputs ----

def _attention_case(rng, b, n, nnc, hw, h=H, c_=C_):
    k = -(-n // CS)
    ncc = np.argsort(rng.uniform(size=(b, n, k)), axis=-1)[:, :, :nnc]
    pos = rng.integers(0, hw, size=(b, n, 2)).astype(np.float32)
    c = h * c_
    return dict(
        q=rng.standard_normal((b, n, c)).astype(np.float32) * c_**-0.5,
        kv=rng.standard_normal((b, n, 2 * c)).astype(np.float32),
        ncc=ncc.astype(np.int32), pos=pos,
        pe_kernel=(rng.standard_normal((5, h)) * 0.1).astype(np.float32),
        pe_bias=(rng.standard_normal((h,)) * 0.1).astype(np.float32),
        blank_k=(rng.standard_normal((c_, h)) * 0.5).astype(np.float32),
        blank_v=(rng.standard_normal((h, c_)) * 0.5).astype(np.float32),
        g=rng.standard_normal((b, n, c)).astype(np.float32),
    )


def _jax_attention_vjp(args, rel_width, clamp_width=0, **jax_kw):
    ncc, pos = jnp.asarray(args["ncc"]), jnp.asarray(args["pos"])

    def f(q, kv, pk, pb, bk, bv):
        return jax_attention(q, kv, ncc, pos, pk, pb, bk, bv, H, CS,
                             rel_width, clamp_width, **jax_kw)

    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(f, *(jnp.asarray(args[k]) for k in ATTN_GRADS))
        return [np.asarray(g) for g in vjp(jnp.asarray(args["g"]))]


def _port_attention_backward(args, rel_width, clamp_width=0):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in args.items()}
    before = cluster_attention_backward.launches
    grads = cluster_attention_backward(
        *(t[k] for k in ATTN_ARGS), t["g"], H, CS, rel_width, clamp_width)
    assert cluster_attention_backward.launches == before  # CPU: plain
    return [g.numpy() for g in grads]


def _assert_grads(port, ref, names):
    """atol 1e-5 + 1e-6 of the tensor's largest entry, rtol 1e-4: the
    parameter gradients are sums of ~2e4 slot terms that cancel, taken in
    another order by each framework."""
    for name, a, r in zip(names, port, ref):
        assert a.shape == r.shape, name
        np.testing.assert_allclose(a, r, atol=ATOL + 1e-6 * np.abs(r).max(),
                                   rtol=RTOL, err_msg=f"gradient {name}")


# --------------------------------------------------- attention backward ----

@pytest.mark.parametrize("n,clamp_width", [(196, 0), (196, 9), (49, 0),
                                           (49, 9)])
def test_attention_backward_matches_jax_oracle(n, clamp_width):
    """n = 196 and 49 leave 4 and 7 padded slots in the last cluster; the
    clamp of 9 with R = 4 changes the bias of the far slots. On the CPU the
    JAX backward is its XLA oracle (``clusten_pallas.py:3080-3149``)."""
    rng = np.random.default_rng(n + clamp_width)
    args = _attention_case(rng, 2, n, 3, hw=28)
    R = 4 if clamp_width else 27
    ref = _jax_attention_vjp(args, R, clamp_width)
    port = _port_attention_backward(args, R, clamp_width)
    _assert_grads(port, ref, ATTN_GRADS)
    assert np.abs(port[5]).max() > 0  # d_blank_v is not dropped


def test_attention_backward_matches_pallas_bwd_kernel(monkeypatch):
    """The JAX package's Pallas ``_bwd_kernel`` itself, in interpret mode
    (``tests/test_pallas_kernel.py:465``): a 16x16 on-grid stage, c_ = 16,
    host-constant neighbours (its windowed route). Tolerance 2e-4 of each
    gradient's largest entry, the envelope that test holds that kernel to
    against the oracle."""
    monkeypatch.setenv("MLAFF_PALLAS_BWD_INTERPRET", "1")
    rng = np.random.default_rng(5)
    b, hw, nnc, R = 2, 16, 3, 55
    n = hw * hw
    g_pos = grid_cluster(hw, hw, CS)[0]
    g_ncc = grid_nearest_clusters(hw, hw, CS, nnc)
    args = _attention_case(rng, b, n, nnc, hw)
    args["pos"] = np.broadcast_to(g_pos[None], (b, n, 2)).astype(np.float32)
    args["ncc"] = np.broadcast_to(g_ncc[None], (b, n, nnc)).astype(np.int32)
    ref = _jax_attention_vjp(args, R, static_ncc=g_ncc, static_pos=g_pos)
    port = _port_attention_backward(args, R)
    for name, a, r in zip(ATTN_GRADS, port, ref):
        scale = np.abs(r).max()
        assert scale > 0, name
        np.testing.assert_allclose(a / scale, r / scale, atol=2e-4, rtol=0,
                                   err_msg=f"gradient {name}")


# ------------------------------------------------------- merge backward ----

MERGE_CASES = [  # tests/test_merge_pallas.py:41-45; the last one is padded
    (2, 64, 16, 32, 8, 3),
    (1, 48, 12, 16, 4, 2),
    (2, 52, 12, 8, 8, 3),
]


def _merge_case(b, n, n_, c, cs, nnc, seed=0):
    rng = np.random.default_rng(seed)
    k = -(-n // cs)
    return dict(
        weights=rng.standard_normal((b, n_, nnc * cs, 4)).astype(np.float32),
        feat=rng.standard_normal((b, n, c)).astype(np.float32),
        ncc=rng.integers(0, k, size=(b, n_, nnc)).astype(np.int32),
        g=rng.standard_normal((b, n_, 4, c)).astype(np.float32),
    )


@pytest.mark.parametrize("b,n,n_,c,cs,nnc", MERGE_CASES)
def test_merge_backward_matches_jax(b, n, n_, c, cs, nnc):
    a = _merge_case(b, n, n_, c, cs, nnc)
    ncc = jnp.asarray(a["ncc"])
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(lambda w, f: jax_merge(w, f, ncc, cs),
                         jnp.asarray(a["weights"]), jnp.asarray(a["feat"]))
        ref = [np.asarray(g) for g in vjp(jnp.asarray(a["g"]))]
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    before = cluster_merge_backward.launches
    port = cluster_merge_backward(t["weights"], t["feat"], t["ncc"], cs,
                                  t["g"])
    assert cluster_merge_backward.launches == before  # CPU: plain
    assert port[1].dtype == torch.float32
    _assert_grads([p.numpy() for p in port], ref, ["weights", "feat"])


# ----------------------------------------------- the autograd Functions ----

def _f64_attention_inputs():
    """n = 18 tokens in clusters of cs = 4: the last of the 5 clusters has
    2 padded slots; each query attends to 3 of the 5."""
    rng = np.random.default_rng(7)
    a = _attention_case(rng, 2, 18, 3, hw=10, h=2, c_=4)
    a["ncc"] = np.argsort(rng.uniform(size=(2, 18, 5)), -1)[:, :, :3].astype(
        np.int32)
    out = {}
    for name, v in a.items():
        t = torch.from_numpy(v)
        if name in ATTN_GRADS:
            t = t.double().requires_grad_()
        out[name] = t
    return out


def test_attention_function_gradcheck():
    """The Function's backward against finite differences (f64) and against
    autograd through the plain forward, padded slots included."""
    a = _f64_attention_inputs()
    diff = [a[k] for k in ATTN_GRADS]

    def fn(plain):
        op = cluster_attention_reference if plain else fused_cluster_attention

        def f(q, kv, pk, pb, bk, bv):
            return op(q, kv, a["ncc"], a["pos"], pk, pb, bk, bv, 2, 4, 5)
        return f

    assert torch.autograd.gradcheck(fn(False), diff)
    g = torch.randn(2, 18, 8, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(0))
    got = torch.autograd.grad(fn(False)(*diff), diff, g)
    want = torch.autograd.grad(fn(True)(*diff), diff, g)
    for name, x, y in zip(ATTN_GRADS, got, want):
        torch.testing.assert_close(x, y, rtol=1e-10, atol=1e-12, msg=name)


def test_merge_function_gradcheck():
    """As above for the merge: 18 rows in clusters of 4 (2 padded)."""
    a = _merge_case(2, 18, 5, 6, 4, 3, seed=8)
    w = torch.from_numpy(a["weights"]).double().requires_grad_()
    f = torch.from_numpy(a["feat"]).double().requires_grad_()
    ncc = torch.from_numpy(a["ncc"])
    assert torch.autograd.gradcheck(
        lambda w, f: fused_cluster_merge(w, f, ncc, 4), (w, f))
    g = torch.from_numpy(a["g"]).double()
    got = torch.autograd.grad(fused_cluster_merge(w, f, ncc, 4), (w, f), g)
    want = torch.autograd.grad(cluster_merge_reference(w, f, ncc, 4), (w, f), g)
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=1e-10, atol=1e-12)


# ---------------------------------------------------- the whole model ----

CFG = dict(  # tests/test_torch_model.py
    num_classes=10, embed_dim=(16, 32, 48, 64), cluster_size=8,
    nbhd_size=(48, 48, 48, 49), depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
    mlp_ratio=2.0, img_size=112,
)


def _random_variables(model, x, rng):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(x[:1]))

    def draw(path, leaf):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def test_aff_112_training_gradients_match_jax():
    """Loss, input gradient, every parameter gradient (mapped through
    ``state_dict_from_flax``, since gradients transform like parameters)
    and the updated BatchNorm running stats of one training-mode forward
    and backward, against ``jax.value_and_grad`` of the JAX model (Pallas
    forward kernels in interpret mode, Pallas merge backward, XLA-oracle
    attention backward). Parameter gradients are held to atol 1e-5 +
    rtol 1e-4 of each tensor's largest entry: sums over 2 x 784 tokens
    reorder between the two frameworks."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 112, 112, 3)).astype(np.float32)
    labels = np.array([3, 7])
    model = JaxAFF(use_pallas=True, merge_mode="pallas", drop_path_rate=0.0,
                 dtype=jnp.float32, **CFG)
    variables = _random_variables(model, x, rng)

    def loss_fn(params, images):
        logits, upd = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            images, training=True, mutable=["batch_stats"])
        return jax_soft_target_ce(
            logits, jax_smooth_one_hot(jnp.asarray(labels), 10, 0.1)), upd

    # jit: one XLA program compiles in seconds, where eager dispatch of the
    # interpret-mode kernels takes over a minute on this CPU
    step = jax.jit(jax.value_and_grad(loss_fn, argnums=(0, 1), has_aux=True))
    with jax.default_matmul_precision("highest"):
        (loss, upd), (g_params, g_x) = step(variables["params"],
                                            jnp.asarray(x))
    g_ref = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": g_params}))
    stats_ref = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"batch_stats": upd["batch_stats"]}))

    port = AutoFocusFormer(**CFG).train()
    port.load_state_dict(state_dict_from_flax(variables))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    out = port(xt)
    loss_t = soft_target_cross_entropy(
        out, smooth_one_hot(torch.from_numpy(labels), 10, 0.1))
    loss_t.backward()

    np.testing.assert_allclose(loss_t.item(), float(loss), rtol=RTOL)
    np.testing.assert_allclose(
        xt.grad.permute(0, 2, 3, 1).numpy(), np.asarray(g_x),
        atol=ATOL * np.abs(np.asarray(g_x)).max(), rtol=RTOL)
    params = dict(port.named_parameters())
    assert set(params) == set(g_ref)
    for name, p in params.items():
        want = g_ref[name].numpy()
        assert p.grad is not None, name
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=RTOL,
            atol=ATOL + RTOL * np.abs(want).max(), err_msg=name)
    buffers = dict(port.named_buffers())
    for name, want in stats_ref.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(buffers[name].numpy(), want.numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


# ---------------------------------------------------- the fault guards ----

def test_fused_ops_carry_gradients_to_their_parameters():
    """Every parameter of the attention blocks and of the downsamples gets
    a non-zero gradient through the fused ops' Functions (the same
    Functions that launch the CUDA kernels on the card)."""
    torch.manual_seed(0)
    port = AutoFocusFormer(**CFG).train()
    port.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(2, 3, 112, 112)
    out = port(x)
    out.float().square().mean().backward()
    for i, layer in enumerate(port.layers[:3]):
        attn = layer.blocks[0].attn
        for name, p in [*attn.named_parameters(),
                        *layer.downsample.named_parameters(),
                        *layer.prob_net.named_parameters()]:
            assert p.grad is not None and p.grad.abs().max() > 0, (i, name)


def test_attention_function_is_on_the_autograd_path():
    a = _f64_attention_inputs()
    out = fused_cluster_attention(*(a[k] for k in ATTN_ARGS), 2, 4, 5)
    # the autograd formulas of the ops mlaff::cluster_attention_fwd and
    # mlaff::cluster_merge_fwd
    assert type(out.grad_fn).__name__ == (
        "GeneratedBackwardFor_mlaff_cluster_attention_fwd_defaultBackward")
    w = torch.ones(1, 1, 8, 4, requires_grad=True)
    f = torch.ones(1, 4, 3)
    ncc = torch.zeros(1, 1, 2, dtype=torch.int32)
    merged = fused_cluster_merge(w, f, ncc, 4)
    assert type(merged.grad_fn).__name__ == (
        "GeneratedBackwardFor_mlaff_cluster_merge_fwd_defaultBackward")


def test_batchnorm_train_matches_flax_biased_running_var():
    """PatchEmbed in training mode against the JAX PatchEmbed: output and
    the running stats after one step. 2 x 4 x 4 = 32 values per channel, so
    an unbiased variance would be 32/31 too large and fail here."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32) * 2.0 + 0.5
    jm = JaxPatchEmbed(embed_dim=8, dtype=jnp.float32)
    variables = _random_variables(jm, x, rng)
    with jax.default_matmul_precision("highest"):
        (_, feat_ref, _, _), upd = jm.apply(variables, jnp.asarray(x),
                                            training=True,
                                            mutable=["batch_stats"])
    stats = state_dict_from_flax({"batch_stats": jax.tree_util.tree_map(
        np.asarray, upd["batch_stats"])})

    pe = PatchEmbed(embed_dim=8).train()
    pe.load_state_dict(state_dict_from_flax(variables))
    _, feat, _, _ = pe(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(feat.detach().numpy(), np.asarray(feat_ref),
                               atol=ATOL, rtol=RTOL)
    for key in ("bn.running_mean", "bn.running_var"):
        np.testing.assert_allclose(
            dict(pe.named_buffers())[key].numpy(), stats[key].numpy(),
            atol=1e-6, rtol=1e-6, err_msg=key)


# -------------------------------------------------- on the card (cuda) ----

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_kernel_matches_plain_on_card(cuda_device, dtype):
    rng = np.random.default_rng(9)
    a = _attention_case(rng, 2, 196, 6, hw=28, h=4, c_=32)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in a.items()}
    for k in ("q", "kv", "g"):
        t[k] = t[k].to(dtype)
    before = cluster_attention_backward.launches
    got = cluster_attention_backward(*(t[k] for k in ATTN_ARGS), t["g"], 4,
                                     CS, 27)
    plain = {k: (v.float() if k in ("q", "kv", "g") else v)
             for k, v in t.items()}
    want = cluster_attention_backward_reference(
        *(plain[k] for k in ATTN_ARGS), plain["g"], 4, CS, 27)
    torch.cuda.synchronize()
    assert cluster_attention_backward.launches == before + 1
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for name, x, y in zip(ATTN_GRADS, got, want):
        err = (x.float() - y.float()).abs().max().item()
        assert err <= tol * y.float().abs().max().item(), name


@pytest.mark.cuda
@pytest.mark.parametrize("name", STRESS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_kernel_stress_shapes_on_card(cuda_device, dtype,
                                                         name):
    """The stress shapes of ``tests/test_torch_kernels.py`` (n = 1921 with
    clamp_width 9, cs = 1 with nnc = 48, random ncc over several chunks,
    AFF-Base-384's m = 144, c_ = 556 and 1440, m = 760 with repeated
    clusters); every gradient."""
    a, h, cs, R, clamp = _stress_case(name, 12)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in a.items()}
    for k in ("q", "kv", "g"):
        t[k] = t[k].to(dtype)
    got = cluster_attention_backward(*(t[k] for k in ATTN_ARGS), t["g"], h,
                                     cs, R, clamp)
    # the plain backward in f64: at c_ = 556 its f32 rounding of d_pe_bias
    # (a sum of slot terms that cancel) nears the limit
    plain = {k: (v.double() if v.is_floating_point() else v)
             for k, v in t.items()}
    want = cluster_attention_backward_reference(
        *(plain[k] for k in ATTN_ARGS), plain["g"], h, cs, R, clamp)
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for gname, x, y in zip(ATTN_GRADS, got, want):
        err = (x.float() - y.float()).abs().max().item()
        assert err <= tol * y.float().abs().max().item(), gname


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_backward_kernel_matches_plain_on_card(cuda_device, dtype):
    a = _merge_case(2, 52, 12, 40, 8, 3)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in a.items()}
    w, f, g = (t[k].to(dtype) for k in ("weights", "feat", "g"))
    before = cluster_merge_backward.launches
    got = cluster_merge_backward(w, f, t["ncc"], 8, g)
    want = cluster_merge_backward_reference(w.float(), f.float(), t["ncc"], 8,
                                            g.float())
    torch.cuda.synchronize()
    assert cluster_merge_backward.launches == before + 1
    assert got[0].dtype == dtype and got[1].dtype == dtype
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for x, y in zip(got, want):
        err = (x.float() - y).abs().max().item()
        assert err <= tol * y.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("name", MERGE_STRESS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_backward_kernel_stress_shapes_on_card(cuda_device, dtype,
                                                     name):
    """The merge stress shapes of ``tests/test_torch_kernels.py`` (m = 760
    with repeats, random ncc, AFF-Base-384's first merge, c = 512, b = 1);
    dw and dfeat against the plain backward in f64."""
    a = _merge_case_of(*_merge_stress_case(name, 14), cuda_device)
    w, f, g = (a[k].to(dtype) for k in ("weights", "feat", "g"))
    got = cluster_merge_backward(w, f, a["ncc"], a["cs"], g)
    want = cluster_merge_backward_reference(
        w.double(), f.double(), a["ncc"], a["cs"], g.double())
    torch.cuda.synchronize()
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for x, y in zip(got, want):
        assert x.dtype == dtype
        err = (x.double() - y).abs().max().item()
        assert err <= tol * y.abs().max().item()


def _merge_case_of(weights, feat, ncc, g, cs, dev):
    t = dict(weights=weights, feat=feat, ncc=ncc, g=g)
    out = {k: torch.from_numpy(v).to(dev) for k, v in t.items()}
    out["cs"] = cs
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_backward_is_bitwise_reproducible_on_card(cuda_device, dtype):
    """The merge backward sums in an order fixed by the inverse index, with
    no atomics: two runs on the same inputs give the same bits (ROADMAP
    C4). AFF-Mini's first merge at b = 8."""
    a = _merge_case_of(*_merge_stress_case("merge_b1", 15), cuda_device)
    w, f, g = (a[k].to(dtype).expand(8, *a[k].shape[1:]).contiguous()
               for k in ("weights", "feat", "g"))
    ncc = a["ncc"].expand(8, *a["ncc"].shape[1:]).contiguous()
    first = cluster_merge_backward(w, f, ncc, a["cs"], g)
    second = cluster_merge_backward(w, f, ncc, a["cs"], g)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random_ncc", "m760_repeats"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_backward_is_bitwise_reproducible_on_card(cuda_device,
                                                            dtype, name):
    """The attention backward sums dk/dv over a tile's queries, the tiles'
    partials in ascending tile order and the parameter gradients in a
    fixed order, with no atomics: two runs on the same inputs give the
    same bits for every output (ROADMAP C6). Random ncc (unions over
    several chunks, most clusters named by every tile) and repeated
    clusters, at b = 8."""
    a, h, cs, R, clamp = _stress_case(name, 16)
    t = {k: torch.from_numpy(v).to(cuda_device) for k, v in a.items()}
    for k in ("q", "kv", "g"):
        t[k] = t[k].to(dtype)
    t = {k: (v.expand(8, *v.shape[1:]).contiguous() if v.dim() == 3 else v)
         for k, v in t.items()}
    args = [t[k] for k in ATTN_ARGS]
    first = cluster_attention_backward(*args, t["g"], h, cs, R, clamp)
    second = cluster_attention_backward(*args, t["g"], h, cs, R, clamp)
    torch.cuda.synchronize()
    for gname, x, y in zip(ATTN_GRADS, first, second):
        assert torch.equal(x, y), gname
