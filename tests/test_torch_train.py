"""The port's training stack against the JAX package's (CPU).

* schedules at their endpoints, and the no-decay mask;
* clip + AdamW + MultiSteps + skip-on-non-finite + EMA fed the same
  gradients on both sides, against the optax chain and the JAX trainer's
  update rules, with accumulation 2 and one injected ``inf``;
* one full fp32 train step of the 56^2 AFF of ``tests/test_train.py:20``
  (drop_path_rate 0): loss and grad_norm against the JAX step;
* mixup/cutmix and DropPath by their properties (no RNG is shared with
  JAX);
* checkpoint save -> auto-resume restores an identical state;
* ``main`` trains on the CPU with ``--device cpu``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ml_autofocusformermod_torch import main as port_main
from ml_autofocusformermod_torch.ckpt.from_jax import state_dict_from_flax
from ml_autofocusformermod_torch.ckpt.io import (
    auto_resume_helper, load_checkpoint, save_checkpoint,
)
from ml_autofocusformermod_torch.config import load_config
from ml_autofocusformermod_torch.models.build import build_model
from ml_autofocusformermod_torch.models.layers import DropPath
from ml_autofocusformermod_torch.ops.cluster_attention import (
    cluster_attention_backward, fused_cluster_attention,
)
from ml_autofocusformermod_torch.train import losses, optim, schedulers
from ml_autofocusformermod_torch.train import trainer
from ml_autofocusformermod_tpu.config import load_config as jax_load_config
from ml_autofocusformermod_tpu.models.aff import AutoFocusFormer as JaxAFF
from ml_autofocusformermod_tpu.train import optim as jax_optim
from ml_autofocusformermod_tpu.train import schedulers as jax_schedulers
from ml_autofocusformermod_tpu.train import trainer as jax_trainer

import torch_optim_reference

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CFG = os.path.join(ROOT, "ml_autofocusformermod_torch", "configs",
                        "aff_mini.yaml")
JAX_CFG = os.path.join(ROOT, "ml_autofocusformermod_tpu", "configs",
                       "aff_mini.yaml")
TINY = {  # tests/test_train.py::tiny_config
    "MODEL.NUM_CLASSES": 10, "MODEL.AFF.EMBED_DIM": [16, 32, 48, 64],
    "MODEL.AFF.DEPTHS": [1, 1, 1, 1], "MODEL.AFF.NUM_HEADS": [2, 2, 4, 4],
    "DATA.IMG_SIZE": 56, "DATA.BATCH_SIZE": 8,
    "TPU.COMPUTE_DTYPE": "float32",
}


def _configs(**extra):
    """The same settings through each package's own config loader."""
    opts = []
    for k, v in {**TINY, **extra}.items():
        opts += [k, json.dumps(v) if not isinstance(v, str) else v]
    return load_config(PORT_CFG, opts=opts), jax_load_config(JAX_CFG,
                                                             opts=opts)


# ---------------------------------------------------------- schedules ----

@pytest.mark.parametrize("name", ["cosine", "linear", "step"])
def test_schedules_match_jax(name):
    port_cfg, jax_cfg = _configs(**{
        "TRAIN.LR_SCHEDULER.NAME": name, "TRAIN.EPOCHS": 30,
        "TRAIN.WARMUP_EPOCHS": 3, "TRAIN.LR_SCHEDULER.DECAY_EPOCHS": 10})
    port = schedulers.build_scheduler(port_cfg, 10)
    ref = jax_schedulers.build_scheduler(jax_cfg, 10)
    # JAX evaluates the schedule in float32 and the port in float64: the
    # cancellation near the end of the linear decay leaves ~1e-7 of the base
    base = port_cfg.TRAIN.BASE_LR
    for step in (0, 1, 29, 30, 31, 150, 299, 300):
        assert port(step) == pytest.approx(float(ref(step)), rel=1e-6,
                                           abs=1e-6 * base), step
    assert port(0) == pytest.approx(port_cfg.TRAIN.WARMUP_LR)


def test_no_weight_decay_mask_matches_jax():
    port_cfg, _ = _configs()
    model = build_model(port_cfg, "cpu")
    jmodel = JaxAFF(num_classes=10, embed_dim=(16, 32, 48, 64),
                    depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4), img_size=56)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 56, 56, 3)))
    ref = state_dict_from_flax({"params": jax_optim.no_weight_decay_mask(
        shapes["params"])})
    mask = optim.no_weight_decay_mask(dict(model.named_parameters()))
    assert mask == {k: bool(v) for k, v in ref.items()}
    assert mask["layers.0.blocks.0.attn.q.weight"] is True
    assert mask["layers.0.blocks.0.attn.blank_k"] is False


# -------------------------------------------------- the optimizer chain ----

class _Tiny(torch.nn.Module):
    def __init__(self, init):
        super().__init__()
        for k, v in init.items():
            setattr(self, k, torch.nn.Parameter(torch.from_numpy(v.copy())))
        self.register_buffer("stat", torch.full((3,), 2.0))


def test_optimizer_chain_matches_optax():
    """5 micro-steps, accumulation 2, clip 1.0 (some steps clip, some do
    not), the second gradient holds an ``inf``: the JAX trainer's rules
    (``trainer.py:130-165``) over the optax chain of ``optim.py`` on one
    side, :func:`trainer.apply_gradients` on the other, fed the same
    gradients. Everything in float32: rtol 1e-5."""
    extra = {"TRAIN.ACCUMULATION_STEPS": 2, "TRAIN.CLIP_GRAD": 1.0,
             "TRAIN.BASE_LR": 0.05, "TRAIN.WARMUP_LR": 0.01,
             "TRAIN.EPOCHS": 3, "TRAIN.WARMUP_EPOCHS": 1,
             "TRAIN.USE_EMA": True, "TRAIN.EMA_DECAY": 0.5}
    port_cfg, jax_cfg = _configs(**extra)
    rng = np.random.default_rng(0)
    init = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal((4,)).astype(np.float32),
            "v": rng.standard_normal((2, 3, 2)).astype(np.float32)}
    scales = [0.1, 1.0, 3.0, 0.05, 2.0]
    grads = [{k: (s * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in init.items()} for s in scales]
    grads[1]["b"][2] = np.inf

    # JAX: the optax chain and the trainer's skip / EMA rules
    schedule = jax_schedulers.build_scheduler(jax_cfg, 4)
    tx = jax_optim.build_optimizer(jax_cfg, schedule)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params)
    ema = dict(params)
    stat = jnp.full((3,), 2.0)
    ema_stat = stat

    model = _Tiny(init)
    state, _ = trainer.create_train_state(port_cfg, model, 4)
    for step, g in enumerate(grads):
        gj = {k: jnp.asarray(v) for k, v in g.items()}
        norm = optax.global_norm(gj)
        finite = bool(jnp.isfinite(norm))
        updates, new_opt = tx.update(gj, opt_state, params)
        if finite:
            params = optax.apply_updates(params, updates)
            opt_state = new_opt
        if (step + 1) % 2 == 0:
            ema = {k: ema[k] * 0.5 + params[k] * (1.0 - 0.5) for k in ema}
            ema_stat = ema_stat * 0.5 + stat * (1.0 - 0.5)

        port_norm, port_finite = trainer.apply_gradients(
            state, {k: torch.from_numpy(v) for k, v in g.items()}, 2, 0.5)
        assert port_finite == finite
        if finite:
            assert port_norm.item() == pytest.approx(float(norm), rel=1e-6)
        adam = opt_state.inner_opt_state[1][0]  # clip, (adam, decay, lr)
        for k in init:
            np.testing.assert_allclose(
                getattr(model, k).detach().numpy(), np.asarray(params[k]),
                rtol=1e-5, atol=1e-7, err_msg=f"param {k} at step {step}")
            np.testing.assert_allclose(
                state.ema[k].numpy(), np.asarray(ema[k]), rtol=1e-5,
                atol=1e-7, err_msg=f"ema {k} at step {step}")
            for moment in ("mu", "nu"):
                np.testing.assert_allclose(
                    state.optimizer.state[moment][k].numpy(),
                    np.asarray(getattr(adam, moment)[k]),
                    rtol=1e-5, atol=1e-12, err_msg=f"{moment} {k} at {step}")
        np.testing.assert_allclose(state.ema["stat"].numpy(),
                                   np.asarray(ema_stat))
        assert state.optimizer.state["count"] == int(adam.count)
        assert state.optimizer.state["mini_step"] == int(opt_state.mini_step)
        assert state.step == step + 1
    # 5 micro-steps, one skipped: two optimizer updates
    assert state.optimizer.state["count"] == 2


# --------------------------------------- the multi-tensor update ----

def _leaves_case(every_k, name="adamw", clip=1.0):
    """A train state over a tiny model with decayed (``w``, ``v``, ``c``)
    and undecayed (``b``, ``s``; ``stat`` aside) leaves, and 4
    micro-gradients whose norms are about 0.3, 0.1, 6 and 13: clip 1.0
    leaves the first two (and with ``every_k`` 2 their mean) as they are
    and clips the others. ``c``'s gradients have other strides than ``c``
    in its size-1 dim, as autograd may give them (UD-Mini's depthwise conv
    weights get such gradients)."""
    port_cfg, _ = _configs(**{
        "TRAIN.ACCUMULATION_STEPS": every_k, "TRAIN.CLIP_GRAD": clip,
        "TRAIN.OPTIMIZER.NAME": name, "TRAIN.BASE_LR": 0.05,
        "TRAIN.WARMUP_LR": 0.01, "TRAIN.EPOCHS": 3,
        "TRAIN.WARMUP_EPOCHS": 1, "TRAIN.USE_EMA": True,
        "TRAIN.EMA_DECAY": 0.5})
    rng = np.random.default_rng(3)
    init = {"w": rng.standard_normal((4, 5)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32),
            "v": rng.standard_normal((2, 3, 2)).astype(np.float32),
            "s": rng.standard_normal((3,)).astype(np.float32),
            "c": rng.standard_normal((1, 4)).astype(np.float32)}
    grads = [{k: torch.from_numpy((sc * rng.standard_normal(v.shape))
                                  .astype(np.float32)) for k, v in init.items()}
             for sc in (0.05, 0.02, 1.0, 2.0)]
    for g in grads:
        g["c"] = g["c"].as_strided((1, 4), (1, 1))
    model = _Tiny(init)
    state, _ = trainer.create_train_state(port_cfg, model, 4)
    return state, grads


@pytest.mark.parametrize("name", ["adamw", "sgd"])
@pytest.mark.parametrize("every_k", [1, 2])
def test_multi_tensor_update_is_the_per_leaf_rule(every_k, name):
    """4 micro-steps through :func:`trainer.apply_gradients` (clip 1.0,
    some steps clipped and some not, EMA on) give the parameters, moments
    and EMA of the per-leaf rules (``torch_optim_reference.py``) bit for
    bit: on the CPU each ``_foreach`` op runs the per-tensor op, so equal
    op sequences give equal bits. The one op that differs is the global
    norm (one multi-tensor norm against a Python sum of per-leaf sums):
    both sides clip with the port's, and
    :func:`test_global_norm_matches_the_per_leaf_sum` holds it to the sum.
    The update counters count every update and every leaf."""
    state, grads = _leaves_case(every_k, name)
    opt = state.optimizer
    ref = torch_optim_reference.PerLeaf(opt, norm=optim.global_norm)
    ema = {k: state.ema[k].clone() for k in opt.params}
    steps0 = optim.multi_tensor_update.steps
    leaves0 = optim.multi_tensor_update.leaves
    norms = []
    for i, g in enumerate(grads):
        norm, finite = trainer.apply_gradients(state, g, every_k, 0.5)
        assert finite and torch_optim_reference.apply_gradients(
            ref, ema, g, i, every_k, 0.5)
        norms.append(norm.item())
        for k, p in opt.params.items():
            assert torch.equal(p, ref.params[k]), (k, i)
            assert torch.equal(state.ema[k], ema[k]), (k, i)
            for moment in ("mu", "nu", "trace", "acc"):
                if moment in ref.state:
                    assert torch.equal(opt.state[moment][k],
                                       ref.state[moment][k]), (moment, k, i)
        assert {k: v for k, v in opt.state.items()
                if not isinstance(v, dict)} == \
            {k: v for k, v in ref.state.items() if not isinstance(v, dict)}
    assert max(norms[:2]) < 0.5 and min(norms[2:]) > 3.0
    updates = len(grads) // every_k
    assert optim.multi_tensor_update.steps - steps0 == updates
    assert optim.multi_tensor_update.leaves - leaves0 == 5 * updates


def test_global_norm_matches_the_per_leaf_sum():
    """The multi-tensor global norm equals the per-leaf sum of squares to
    rel 1e-6 (leaves of 1 to 200k entries, scales 1e-3 to 1e3), and stays
    non-finite where a leaf is."""
    rng = np.random.default_rng(5)
    shapes = [(), (3,), (64, 48), (7, 5, 3, 3), (200_000,), (2, 1)]
    leaves = [torch.from_numpy(np.asarray(
        10.0 ** rng.uniform(-3, 3) * rng.standard_normal(s), np.float32))
        for s in shapes]
    want = torch_optim_reference.global_norm(leaves).item()
    assert optim.global_norm(leaves).item() == pytest.approx(want, rel=1e-6)
    for bad in (np.inf, np.nan):
        leaves[2][1, 1] = bad
        got = optim.global_norm(leaves).item()
        assert not np.isfinite(got)
        assert np.isnan(got) == np.isnan(bad)


@pytest.mark.parametrize("every_k,norms", [(1, 1), (2, 3)])
def test_apply_gradients_computes_the_norm_once(monkeypatch, every_k, norms):
    """At ``every_k`` 1 the clip reuses :func:`trainer.apply_gradients`'
    norm: one global norm per step that clips; a step on another mapping
    than the last norm's takes its own. With accumulation the clip takes
    the norm of the accumulated mean: one more per update."""
    state, grads = _leaves_case(every_k)
    calls = []
    real = optim.global_norm
    monkeypatch.setattr(optim, "global_norm",
                        lambda ts: calls.append(1) or real(ts))
    for g in grads[2:2 + every_k]:  # norms over the clip
        trainer.apply_gradients(state, g, every_k, 0.5)
    assert state.optimizer.state["count"] == 1
    assert len(calls) == norms
    if every_k == 1:
        state.optimizer.global_norm(grads[2])
        state.optimizer.step(dict(grads[3]))
        assert len(calls) == norms + 2


# ----------------------------------------------------- one train step ----

def test_train_step_matches_jax_step():
    """One fp32 train step of the 56^2 AFF (stage 3 is a global-attention
    stage followed by a downsample): the JAX ``make_train_step`` (Pallas
    forward kernels in interpret mode, jitted) against the port's, from the
    same weights and batch."""
    port_cfg, jax_cfg = _configs()
    jmodel = JaxAFF(num_classes=10, embed_dim=(16, 32, 48, 64),
                    depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4), img_size=56,
                    drop_path_rate=0.0, use_pallas=True, merge_mode="pallas")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((8, 56, 56, 3)).astype(np.float32)
    y = np.arange(8) % 10
    # weights drawn on the variable tree's shapes (eval_shape, no compile)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 56, 56, 3)))
    variables = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (
            rng.uniform(0.5, 1.5, leaf.shape) if path[-1].key == "var"
            else (path[-1].key == "scale") + 0.1 * rng.standard_normal(
                leaf.shape)).astype(np.float32), shapes)
    jstate, tx, schedule = jax_trainer.create_train_state(
        jax_cfg, jmodel, None, None, n_steps_per_epoch=10,
        variables=variables)
    step = jax.jit(jax_trainer.make_train_step(jax_cfg, jmodel, tx, schedule))
    with jax.default_matmul_precision("highest"):
        _, ref = step(jstate, {"image": jnp.asarray(x), "label": jnp.asarray(y)},
                      jax.random.PRNGKey(42))

    model = build_model(port_cfg, "cpu")
    model.load_state_dict(state_dict_from_flax(variables))
    state, port_schedule = trainer.create_train_state(port_cfg, model, 10)
    train_step = trainer.make_train_step(port_cfg, state, port_schedule)
    out = train_step(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(),
                     torch.from_numpy(y))
    assert out["grads_finite"] and bool(ref["grads_finite"])
    assert out["loss"].item() == pytest.approx(float(ref["loss"]), rel=1e-4)
    assert out["grad_norm"].item() == pytest.approx(float(ref["grad_norm"]),
                                                    rel=1e-4)
    assert out["lr"] == pytest.approx(float(ref["lr"]), rel=1e-6)
    assert state.step == 1 and state.optimizer.state["count"] == 1


# ------------------------------------------------------ by properties ----

@pytest.mark.parametrize("mixup,cutmix", [(0.8, 0.0), (0.0, 1.0), (0.8, 1.0)])
def test_mixup_cutmix_properties(mixup, cutmix):
    gen = torch.Generator().manual_seed(0)
    images = torch.randn(4, 3, 16, 16, generator=gen)
    labels = torch.tensor([0, 1, 2, 3])
    for _ in range(4):
        mixed, target = losses.mixup_cutmix(gen, images, labels, 10,
                                            mixup_alpha=mixup,
                                            cutmix_alpha=cutmix,
                                            smoothing=0.1)
        assert mixed.shape == images.shape
        torch.testing.assert_close(target.sum(-1), torch.ones(4))
        # one lambda per batch: own label and flip partner share the mass
        own = target[torch.arange(4), labels] - 0.01
        partner = target[torch.arange(4), labels.flip(0)] - 0.01
        torch.testing.assert_close(own + partner, torch.full((4,), 0.9))
        lam = own[0].item() / 0.9
        # each pixel is the image's own, its partner's, or (mixup) a blend
        flipped = images.flip(0)
        blend = images * lam + flipped * (1 - lam)
        is_cut = (mixed == images) | (mixed == flipped)
        assert bool(is_cut.all()) or torch.allclose(mixed, blend, atol=1e-6)
        if bool(is_cut.all()) and cutmix > 0:
            area = (mixed != images).any(1).float().mean((1, 2))
            # the box holds 1 - lam of the pixels (where the images differ)
            assert area.max().item() <= 1 - lam + 1e-6


def test_drop_path_properties():
    dp = DropPath(0.3).train()
    dp.generator = torch.Generator().manual_seed(0)
    x = torch.ones(20000, 2, 3)
    y = dp(x)
    values = torch.unique(y)
    torch.testing.assert_close(values, torch.tensor([0.0, 1 / 0.7]))
    per_sample = y[:, 0, 0]
    assert bool((y == per_sample[:, None, None]).all())  # whole samples
    assert abs((per_sample > 0).float().mean().item() - 0.7) < 0.02
    assert abs(y.mean().item() - 1.0) < 0.03  # unbiased in expectation
    dp.generator = torch.Generator().manual_seed(0)
    assert torch.equal(dp(x), y)  # the generator alone decides the mask
    assert torch.equal(dp.eval()(x), x)
    assert torch.equal(DropPath(0.0).train()(x), x)


# ------------------------------------------------------- checkpoints ----

def test_checkpoint_auto_resume_restores_state(tmp_path):
    port_cfg, _ = _configs(**{"TRAIN.USE_EMA": True,
                              "TRAIN.ACCUMULATION_STEPS": 2})
    gen = torch.Generator().manual_seed(3)
    x = torch.randn(8, 3, 56, 56, generator=gen)
    y = torch.arange(8) % 10

    def fresh(seed):
        model = build_model(port_cfg, "cpu", seed=seed)
        state, schedule = trainer.create_train_state(port_cfg, model, 10,
                                                     seed=seed)
        return state, trainer.make_train_step(port_cfg, state, schedule)

    state, step = fresh(0)
    for _ in range(3):
        step(x, y)
    for epoch in range(7):
        path = save_checkpoint(str(tmp_path), epoch, state, 12.5,
                               keep_every=5)
    names = sorted(os.listdir(tmp_path))
    assert names == ["ckpt_epoch_0.pt", "ckpt_epoch_5.pt", "ckpt_epoch_6.pt"]
    assert auto_resume_helper(str(tmp_path)) == path

    other, other_step = fresh(1)
    other, epoch, max_acc = load_checkpoint(auto_resume_helper(str(tmp_path)),
                                            other)
    assert (epoch, max_acc, other.step) == (6, 12.5, 3)
    want = state.model.state_dict()
    for k, t in other.model.state_dict().items():
        assert torch.equal(t, want[k]), k
    for k, t in other.ema.items():
        assert torch.equal(t, state.ema[k]), k
    for k in ("count", "sched_count", "mini_step", "gradient_step"):
        assert other.optimizer.state[k] == state.optimizer.state[k], k
    for moment in ("mu", "nu", "acc"):
        for k, t in other.optimizer.state[moment].items():
            assert torch.equal(t, state.optimizer.state[moment][k]), k
    # the resumed run continues bit for bit
    a, b = step(x, y), other_step(x, y)
    assert a["loss"].item() == b["loss"].item()
    for k, t in other.model.state_dict().items():
        assert torch.equal(t, state.model.state_dict()[k]), k


# ------------------------------------------------------------- main ----

def test_main_trains_on_cpu(tmp_path, capsys):
    """4 synthetic micro-steps (64 items, batch 16) with accumulation 2,
    so 2 optimizer updates; a checkpoint; a validation."""
    opts = []
    for k, v in {**TINY, "TRAIN.USE_EMA": True}.items():
        if k != "DATA.BATCH_SIZE":
            opts += [k, json.dumps(v) if not isinstance(v, str) else v]
    launches = (fused_cluster_attention.launches,
                cluster_attention_backward.launches)
    result = port_main.main([
        "--cfg", PORT_CFG, "--device", "cpu", "--batch-size", "16",
        "--data-path", str(tmp_path / "no_dataset"), "--epochs", "1",
        "--accumulation-steps", "2", "--output", str(tmp_path / "out"),
        "--opts", *opts,
    ])
    assert launches == (fused_cluster_attention.launches,
                        cluster_attention_backward.launches)  # CPU: plain
    train = result["train"]
    assert train["steps"] == 4 and train["state_step"] == 4
    assert train["skipped_steps"] == 0
    assert np.isfinite(train["train_loss"]) and 1.0 < train["train_loss"] < 5.0
    assert os.path.exists(train["checkpoint"])
    assert 0.0 <= train["acc1"] <= train["acc5"] <= 100.0
    assert "ema_acc1" in train
    out_dir = os.path.dirname(train["checkpoint"])
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert any("val/acc1" in r for r in records)
    assert "Start training" in capsys.readouterr().out
