"""Attention dropout in training, the port against the JAX package (CPU).

* a ``ClusterAttention`` layer in training mode with ``attn_drop=0.25``:
  output and every gradient against JAX's layer with a "dropout" rng
  (its Pallas kernels in interpret mode), the seed JAX drew replayed into
  the port's ``draw_drop_seed``;
* one training step of the tiny Up-Down model with ``ATTN_DROP_RATE``
  0.25 on its local levels: loss and every gradient against
  ``jax.value_and_grad``, JAX's masks and dropout seeds replayed (the JAX
  side in ``torch_maskfiner_reference.py``, case ``ud_train_attn_drop``);
* the train state's ``attn_drop_generator``: one seed per call, the
  same masks on a replay, and a checkpoint that restores it, so a resumed
  run continues with the same loss;
* ``main``: the tiny Up-Down model trained for two epochs with attention
  dropout, and again from its first epoch's checkpoint with
  ``--resume``: the resumed epoch's loss is the uninterrupted run's.
"""

import os


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_autofocusformermod_torch import main as port_main
from ml_autofocusformermod_torch.ckpt.from_jax import state_dict_from_flax
from ml_autofocusformermod_torch.ckpt.io import (
    load_checkpoint, save_checkpoint,
)
from ml_autofocusformermod_torch.models import layers as tl
from ml_autofocusformermod_torch.models import maskfiner_ot, maskfiner_ud
from ml_autofocusformermod_torch.models.build import build_model
from ml_autofocusformermod_torch.ops import cluster_attention as ops
from ml_autofocusformermod_torch.train.losses import smooth_one_hot
from ml_autofocusformermod_torch.train.trainer import (
    create_train_state, make_train_step, model_loss,
)
from ml_autofocusformermod_tpu.models import layers as jl
from ml_autofocusformermod_tpu.ops import clusten_pallas
from test_torch_maskfiner import PORT_CFG, port_tiny_mr
from test_torch_maskfiner_train import _assert_grads_and_stats, _variables
from torch_maskfiner_reference import (
    SMOOTHING, TRAIN_DROP, run_reference,
)

torch.set_num_threads(1)
ATOL, RTOL = 1e-5, 1e-4
CASE = "ud_train_attn_drop"


def _replay_seeds(monkeypatch, seeds):
    """Make the port's dropout seeds the given ones, in call order;
    returns the list of the calls' seeds."""
    drawn = []

    def replay(generator=None):
        drawn.append(int(seeds[len(drawn)]))
        return drawn[-1]

    monkeypatch.setattr(ops, "draw_drop_seed", replay)
    return drawn


def test_cluster_attention_layer_dropout_matches_jax(monkeypatch):
    """n = 52 (padded last cluster), 2 heads of c_ = 8, nnc 3: the JAX
    layer's fused route drops inside its kernels with the seed it drew
    from the "dropout" stream; the port's layer, given that seed, gives
    the same output, input gradient and parameter gradients."""
    rng = np.random.default_rng(41)
    b, n, dim, heads, cs, nnc, R = 2, 52, 16, 2, 8, 3, 27
    k = -(-n // cs)
    ncc = np.argsort(rng.uniform(size=(b, n, k)), -1)[:, :, :nnc].astype(
        np.int32)
    pos = rng.integers(0, 28, size=(b, n, 2)).astype(np.float32)
    feat = rng.standard_normal((b, n, dim)).astype(np.float32)
    w = rng.standard_normal((b, n, dim)).astype(np.float32)
    member_idx = (ncc[..., None] * cs + np.arange(cs)).reshape(b, n, nnc * cs)
    cluster_mask = (member_idx < n).astype(np.int32)
    mod = jl.ClusterAttention(dim=dim, num_heads=heads, attn_drop=0.25,
                              use_pallas=True, rel_pos_width=R)
    jkw = dict(nearest_cluster=jnp.asarray(ncc), cluster_size=cs,
               pos=jnp.asarray(pos))
    jargs = (jnp.asarray(member_idx), jnp.asarray(cluster_mask), False, None)
    shapes = jax.eval_shape(lambda: mod.init(
        jax.random.PRNGKey(0), jnp.asarray(feat), *jargs, **jkw))
    variables = jax.tree_util.tree_map(
        lambda s: (0.3 * rng.standard_normal(s.shape)).astype(np.float32),
        shapes)

    seeds = []
    real = clusten_pallas.fused_cluster_attention

    def recording(*args, drop_seed=None, **kw):
        seeds.append(int(np.asarray(drop_seed)[0]))
        return real(*args, drop_seed=drop_seed, **kw)

    monkeypatch.setattr(clusten_pallas, "fused_cluster_attention", recording)

    def loss(params, x):
        out = mod.apply({"params": params}, x, *jargs, deterministic=False,
                        rngs={"dropout": jax.random.PRNGKey(5)}, **jkw)
        return (out * w).sum(), out

    with jax.default_matmul_precision("highest"):
        (_, ref), (g_params, g_x) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(variables["params"],
                                                jnp.asarray(feat))
    assert len(seeds) == 1

    port = tl.ClusterAttention(dim, heads, R, attn_drop=0.25)
    port.load_state_dict(state_dict_from_flax(variables))
    port.train()
    drawn = _replay_seeds(monkeypatch, seeds)
    x = torch.from_numpy(feat).requires_grad_(True)
    out = port(x, False, None, torch.from_numpy(ncc), cs,
               torch.from_numpy(pos))
    (out * torch.from_numpy(w)).sum().backward()
    assert drawn == seeds
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_x), atol=ATOL,
                               rtol=RTOL)
    g_ref = state_dict_from_flax({"params": g_params})
    for name, p in port.named_parameters():
        want = g_ref[name].numpy()
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=RTOL,
            atol=ATOL + RTOL * np.abs(want).max(), err_msg=name)


@pytest.fixture(scope="module")
def drop_refs(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("attn_drop_train"), [CASE])


def test_training_with_attention_dropout_matches_jax(drop_refs, monkeypatch):
    """The tiny Up-Down with ``ATTN_DROP_RATE`` 0.25 on levels 2-4: one
    training-mode loss and backward against ``jax.value_and_grad``, with
    JAX's upsampling masks and its three dropout seeds replayed."""
    preset, opts, ratios = TRAIN_DROP[CASE]
    port = build_model(port_tiny_mr(preset, **opts), "cpu",
                       upscale_ratios=ratios)
    port.load_state_dict(state_dict_from_flax(_variables(drop_refs, CASE)),
                         strict=True)

    def replay(model, j, b, n, device):
        return torch.from_numpy(drop_refs[f"{CASE}/mask/{j}"]).to(device)

    monkeypatch.setattr(maskfiner_ot, "random_upsampling_mask", replay)
    monkeypatch.setattr(maskfiner_ud, "random_upsampling_mask", replay)
    seeds = drop_refs[f"{CASE}/seeds"]
    assert len(seeds) == 3
    drawn = _replay_seeds(monkeypatch, seeds)
    port.train()
    x = torch.from_numpy(drop_refs[f"{CASE}/in/x"]).permute(0, 3, 1, 2)
    labels = torch.from_numpy(drop_refs[f"{CASE}/in/labels"])
    loss = model_loss(port(x.contiguous()),
                      smooth_one_hot(labels, 10, SMOOTHING))
    loss.backward()
    assert drawn == [int(s) for s in seeds]
    np.testing.assert_allclose(loss.item(), drop_refs[f"{CASE}/out/loss"],
                               atol=ATOL, rtol=RTOL)
    _assert_grads_and_stats(port, drop_refs, CASE)


def _tiny_drop_state(seed):
    preset, opts, _ = TRAIN_DROP[CASE]
    cfg = port_tiny_mr(preset, **opts)
    model = build_model(cfg, "cpu", seed=seed)
    state, schedule = create_train_state(cfg, model, 10, seed=seed)
    return state, make_train_step(cfg, state, schedule)


def test_attention_dropout_generator_draws_replays_and_resumes(tmp_path,
                                                               monkeypatch):
    """Every local attention call of a train step draws one seed from the
    train state's ``attn_drop_generator``; a reseeded generator draws the
    same ones; a checkpoint saves and restores the generator, so the
    resumed run takes the same next step as the run it was saved from."""
    state, step = _tiny_drop_state(0)
    assert all(m.attn_drop_generator is state.attn_drop_generator
               for m in state.model.modules()
               if isinstance(m, tl.ClusterAttention))
    real = ops.draw_drop_seed
    drawn = []

    def recording(generator=None):
        assert generator is state.attn_drop_generator
        drawn.append(real(generator))
        return drawn[-1]

    monkeypatch.setattr(ops, "draw_drop_seed", recording)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    y = torch.tensor([3, 7])
    step(x, y)
    assert len(drawn) == 3 and all(0 <= s < 2**31 - 1 for s in drawn)
    again = torch.Generator().manual_seed(2)  # create_train_state's seed + 2
    assert [real(again) for _ in drawn] == drawn
    monkeypatch.setattr(ops, "draw_drop_seed", real)

    save_checkpoint(str(tmp_path), 0, state, 0.0)
    want = step(x, y)["loss"].item()
    other, other_step = _tiny_drop_state(1)
    other, epoch, _ = load_checkpoint(str(tmp_path / "ckpt_epoch_0.pt"),
                                      other)
    assert epoch == 0
    assert torch.equal(other.attn_drop_generator.get_state(),
                       torch.load(tmp_path / "ckpt_epoch_0.pt",
                                  weights_only=False)["rng"]["attn_drop"])
    assert other_step(x, y)["loss"].item() == want


def test_main_resume_with_attention_dropout_reproduces_the_loss(tmp_path,
                                                                monkeypatch):
    """``main`` trains the tiny Up-Down model with attention dropout for
    two epochs; ``--resume`` of its first epoch's checkpoint trains the
    second epoch again (its ratios, its data, the restored generators):
    the same mean loss, last loss, gradient norm and validation loss as
    the uninterrupted run, each local attention call drawing its seed."""
    preset, opts, _ = TRAIN_DROP[CASE]
    cfg = port_tiny_mr(preset, **opts)
    mr = cfg.MODEL.MR
    flat = ["MODEL.NUM_CLASSES", str(cfg.MODEL.NUM_CLASSES),
            "DATA.IMG_SIZE", str(cfg.DATA.IMG_SIZE),
            "TPU.COMPUTE_DTYPE", cfg.TPU.COMPUTE_DTYPE]
    for k in ("EMBED_DIM", "DEPTHS", "NUM_HEADS", "MLP_RATIO",
              "ATTN_DROP_RATE"):
        flat += [f"MODEL.MR.{k}", str(list(mr[k]))]
    real = ops.draw_drop_seed
    drawn = []

    def counting(generator=None):
        drawn.append(real(generator))
        return drawn[-1]

    monkeypatch.setattr(ops, "draw_drop_seed", counting)

    def run(out, *extra):
        del drawn[:]
        result = port_main.main([
            "--cfg", os.path.join(PORT_CFG, preset), "--device", "cpu",
            "--batch-size", "16", "--epochs", "2",
            "--data-path", str(tmp_path / "no_dataset"),
            "--output", str(tmp_path / out), *extra, "--opts", *flat])
        return result["train"], list(drawn)

    full, full_seeds = run("full")
    assert full["state_step"] == 8 and full["skipped_steps"] == 0
    first = os.path.join(os.path.dirname(full["checkpoint"]),
                         "ckpt_epoch_0.pt")
    resumed, seeds = run("resumed", "--resume", first)
    assert resumed["start_epoch"] == 1 and resumed["state_step"] == 8
    assert len(full_seeds) == 2 * len(seeds) == 3 * 8  # 3 levels drop
    assert seeds == full_seeds[len(seeds):]
    for k in ("train_loss", "last_loss", "last_grad_norm", "val_loss"):
        assert resumed[k] == full[k], k
