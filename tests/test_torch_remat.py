"""Rematerialisation (``TPU.REMAT``) in the port, on the CPU, mirroring the
JAX package's ``tests/test_remat.py``.

* (a) ``blocks`` and ``dots`` against ``''`` on a tiny AFF and a tiny
  Up-Down model: two train steps of ``train/trainer.py`` with Dropout,
  DropPath and attention dropout all on give the same loss, the same
  gradients and the same generator states after each step, bit for bit
  (the recompute replays the explicit generators);
* (b) against JAX's ``remat=blocks`` / ``dots`` with the drop rates 0:
  loss and every parameter gradient within the whole-model gradient
  tests' envelope (atol 1e-5 + rtol 1e-4 of each tensor's largest entry);
  AFF in this process, Up-Down at ratio 1.0 in the reference process
  (``torch_maskfiner_reference.py``, cases ``ud_train_remat_*``);
* (c) the mechanism: the products that run during the backward, counted
  with a ``TorchDispatchMode``, order ``blocks`` > ``dots`` > ``''``, and
  every local block's attention op runs again in the backward under both
  modes and never under ``''``;
* (d) an unknown mode raises.
"""

from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ml_autofocusformermod_torch.ckpt.from_jax import state_dict_from_flax
from ml_autofocusformermod_torch.config import load_config
from ml_autofocusformermod_torch.models import maskfiner_ot, maskfiner_ud
from ml_autofocusformermod_torch.models.aff import AutoFocusFormer
from ml_autofocusformermod_torch.models.build import build_model
from ml_autofocusformermod_torch.models.mixres_vit import MixResViT
from ml_autofocusformermod_torch.train.losses import (
    smooth_one_hot, soft_target_cross_entropy,
)
from ml_autofocusformermod_torch.train.trainer import (
    create_train_state, make_train_step, model_loss,
)
from ml_autofocusformermod_tpu.models.aff import AutoFocusFormer as JaxAFF
from ml_autofocusformermod_tpu.train.losses import (
    smooth_one_hot as jax_smooth_one_hot,
    soft_target_cross_entropy as jax_soft_target_ce,
)
from test_torch_grad import _random_variables
from test_torch_maskfiner import PORT_CFG, port_tiny_mr
from torch_maskfiner_reference import (
    SMOOTHING, TRAIN_REMAT, run_reference, unflatten,
)

torch.set_num_threads(1)
ATOL, RTOL = 1e-5, 1e-4  # tests/test_torch_grad.py
MODES = ("blocks", "dots")
TINY = dict(  # JAX tests/test_remat.py
    num_classes=10, embed_dim=(32, 64, 96, 128), cluster_size=4,
    nbhd_size=(8, 8, 8, 49), depths=(1, 1, 2, 1), num_heads=(2, 2, 4, 4),
    mlp_ratio=2.0, img_size=56,
)
LOCAL_AFF_BLOCKS = 4  # stages 1-3; stage 4 (3 tokens) attends globally
# the tiny Up-Down with every dropout on: attention dropout on its local
# levels 2-4, whose heads have c_ = 8 (JAX's fused dropout needs c_ % 8)
UD_DROP = {"MODEL.MR.EMBED_DIM": [32, 24, 16, 16, 16, 24, 32],
           "MODEL.MR.DROP_RATE": [0.1] * 7,
           "MODEL.MR.DROP_PATH_RATE": 0.2,
           "MODEL.MR.ATTN_DROP_RATE": [0.0, 0.0, 0.1, 0.1, 0.1, 0.0, 0.0]}


def _aff_cfg():
    return load_config(f"{PORT_CFG}/aff_mini.yaml",
                       ["TPU.COMPUTE_DTYPE", "float32",
                        "MODEL.NUM_CLASSES", "10"])


def _ud_cfg(mode, **opts):
    """The tiny Up-Down's port config with ``TPU.REMAT`` ``mode`` (an
    empty string does not pass through ``--opts``: '' is the default)."""
    remat = {"TPU.REMAT": mode} if mode else {}
    return port_tiny_mr("maskfiner_up_down_mini.yaml", **opts, **remat)


def _images(b, size, seed=1):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal((b, 3, size, size))
                             .astype(np.float32)),
            torch.from_numpy(rng.integers(0, 10, b)))


def _two_steps(model, cfg, x, y):
    """Loss, gradients and generator states after each of two train
    steps."""
    state, schedule = create_train_state(cfg, model, 10)
    step = make_train_step(cfg, state, schedule)
    gens = {k: getattr(state, k) for k in (
        "drop_generator", "attn_drop_generator", "upsample_generator",
        "mix_generator")}
    out = []
    for _ in range(2):
        metrics = step(x, y)
        out.append((metrics["loss"].item(),
                    {k: p.grad.clone() for k, p in model.named_parameters()
                     if p.grad is not None},
                    {k: g.get_state() for k, g in gens.items()}))
    return out


def _aff_model(mode):
    model = AutoFocusFormer(remat=mode, drop_rate=0.1, attn_drop_rate=0.1,
                            drop_path_rate=0.2, **TINY)
    return model.init_weights(torch.Generator().manual_seed(0))


def _ud_model(mode):
    return build_model(_ud_cfg(mode, **UD_DROP), "cpu",
                       upscale_ratios=[0.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("model_name", ["aff", "ud"])
def test_remat_steps_equal_the_plain_steps_bit_for_bit(model_name, mode):
    if model_name == "aff":
        make, cfg, (x, y) = _aff_model, _aff_cfg(), _images(2, 56)
    else:
        make, (x, y) = _ud_model, _images(2, 64)
        cfg = _ud_cfg("", **UD_DROP)
    base = _two_steps(make(""), cfg, x, y)
    got = _two_steps(make(mode), cfg, x, y)
    for (l0, g0, s0), (l1, g1, s1) in zip(base, got):
        assert l0 == l1
        assert set(g0) == set(g1)
        for k in g0:
            assert torch.equal(g0[k], g1[k]), k
        for k in s0:
            assert torch.equal(s0[k], s1[k]), k
    # the dropouts were on: the two steps drew different masks
    assert base[0][0] != base[1][0]


@pytest.mark.parametrize("mode", MODES)
def test_aff_remat_gradients_match_jax(mode):
    """Loss and every parameter gradient of one training-mode step of the
    tiny AFF with ``remat=mode`` against ``jax.value_and_grad`` of JAX's
    (Pallas kernels in interpret mode), drop rates 0."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 56, 56, 3)).astype(np.float32)
    labels = np.array([3, 7])
    model = JaxAFF(use_pallas=True, merge_mode="pallas", drop_path_rate=0.0,
                   dtype=jnp.float32, remat=mode, **TINY)
    variables = _random_variables(model, x, rng)

    def loss_fn(params):
        logits, _ = model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]},
            jnp.asarray(x), training=True, mutable=["batch_stats"])
        return jax_soft_target_ce(
            logits, jax_smooth_one_hot(jnp.asarray(labels), 10, 0.1))

    with jax.default_matmul_precision("highest"):
        loss, g = jax.jit(jax.value_and_grad(loss_fn))(variables["params"])
    g_ref = state_dict_from_flax(jax.tree_util.tree_map(
        np.asarray, {"params": g}))

    port = AutoFocusFormer(remat=mode, **TINY).train()
    port.load_state_dict(state_dict_from_flax(variables))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    loss_t = soft_target_cross_entropy(
        port(xt), smooth_one_hot(torch.from_numpy(labels), 10, 0.1))
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss), rtol=RTOL)
    params = dict(port.named_parameters())
    assert set(params) == set(g_ref)
    for name, p in params.items():
        want = g_ref[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=RTOL,
            atol=ATOL + RTOL * np.abs(want).max(), err_msg=name)


@pytest.fixture(scope="module")
def remat_refs(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("remat"), list(TRAIN_REMAT))


@pytest.mark.parametrize("case", list(TRAIN_REMAT))
def test_ud_remat_gradients_match_jax(case, remat_refs, monkeypatch):
    """The tiny Up-Down at ratio 1.0 with ``TPU.REMAT``: loss and every
    parameter gradient against JAX's, JAX's training masks replayed."""
    preset, opts, ratios = TRAIN_REMAT[case]
    port = build_model(port_tiny_mr(preset, **opts), "cpu",
                       upscale_ratios=ratios)
    port.load_state_dict(state_dict_from_flax(
        {"params": unflatten(remat_refs, f"{case}/params"),
         "batch_stats": unflatten(remat_refs, f"{case}/batch_stats")}),
        strict=True)

    def replay(model, j, b, n, device):
        return torch.from_numpy(remat_refs[f"{case}/mask/{j}"]).to(device)

    monkeypatch.setattr(maskfiner_ot, "random_upsampling_mask", replay)
    monkeypatch.setattr(maskfiner_ud, "random_upsampling_mask", replay)
    port.train()
    x = torch.from_numpy(remat_refs[f"{case}/in/x"]).permute(0, 3, 1, 2)
    labels = torch.from_numpy(remat_refs[f"{case}/in/labels"])
    loss = model_loss(port(x.contiguous()),
                      smooth_one_hot(labels, 10, SMOOTHING))
    loss.backward()
    np.testing.assert_allclose(loss.item(), remat_refs[f"{case}/out/loss"],
                               atol=ATOL, rtol=RTOL)
    g_ref = state_dict_from_flax(
        {"params": unflatten(remat_refs, f"{case}/grad")})
    params = dict(port.named_parameters())
    assert set(params) == set(g_ref)
    for name, p in params.items():
        want = g_ref[name].numpy()
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=RTOL,
            atol=ATOL + RTOL * np.abs(want).max(), err_msg=name)


class _OpCounter(TorchDispatchMode):
    """Counts the ops that reach the dispatcher, by name."""

    def __init__(self):
        super().__init__()
        self.counts = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


PRODUCTS = ("mm", "addmm", "bmm", "baddbmm")


def _backward_counts(model, x):
    """The products and attention ops that run during the backward of one
    forward of ``model``, and the attention ops of the forward."""
    fwd = _OpCounter()
    with fwd:
        loss = model(x).float().square().sum()
    bwd = _OpCounter()
    with bwd:
        loss.backward()
    c = bwd.counts
    return (sum(c[p] for p in PRODUCTS), c["cluster_attention_fwd"],
            fwd.counts["cluster_attention_fwd"])


@pytest.mark.parametrize("model_name", ["aff", "ud"])
def test_remat_recomputes_the_forward_in_the_backward(model_name):
    if model_name == "aff":
        x = _images(2, 56)[0]
        make = lambda mode: AutoFocusFormer(remat=mode, **TINY).init_weights(
            torch.Generator().manual_seed(0))
    else:
        x = _images(2, 64)[0]
        make = lambda mode: build_model(_ud_cfg(mode), "cpu")
    counts = {mode: _backward_counts(make(mode).train(), x)
              for mode in ("", *MODES)}
    assert counts["blocks"][0] > counts["dots"][0] > counts[""][0], counts
    # every local block's attention, once in the forward and once again
    # in the backward's recompute
    local = counts[""][2]
    assert local == (LOCAL_AFF_BLOCKS if model_name == "aff" else 3)
    assert counts[""][1] == 0
    assert counts["blocks"][1:] == counts["dots"][1:] == (local, local)


def test_unknown_remat_mode_raises():
    with pytest.raises(ValueError, match="Unknown remat mode: 'bogus'"):
        AutoFocusFormer(remat="bogus", **TINY)
    with pytest.raises(ValueError, match="Unknown remat mode"):
        MixResViT(patch_sizes=(32,), n_layers=1, d_model=16, n_heads=2,
                  remat="full")
    with pytest.raises(ValueError, match="Unknown remat mode"):
        build_model(_ud_cfg("all"), "cpu")
