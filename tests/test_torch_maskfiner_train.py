"""The port's MaskFiner training against the JAX package's on the CPU.

* one training-mode loss and backward of the tiny Oracle-Teacher, Up-Down
  and Up-Down ``AUX_LOSS`` models of ``tests/test_maskfiner.py::tiny_mr``
  (64^2, depth 1), drop rates 0, and of Up-Down at ratio 1.0 (the
  curriculum's first epoch): the loss and every parameter gradient against
  ``jax.value_and_grad`` with JAX's own training masks replayed, within
  atol 1e-5 + rtol 1e-4 of each tensor's largest entry; a first-layer
  MixResNeighbour level, whose patch embedding's BatchNorm updates its
  running statistics;
* the curriculum: ``main`` trains a tiny Up-Down on the CPU for two
  epochs, at two ratio sets, and setting the second keeps the parameters
  and the AdamW moments;
* fresh upsampling masks per training step, fixed ones at eval;
* :class:`Dropout`: keep share, scale, reproducibility from its generator.

The JAX side runs once for the module, in processes of its own
(``torch_maskfiner_reference.py``: XLA at optimisation level 0).
"""

import os

import numpy as np
import pytest
import torch

from ml_autofocusformermod_torch import main as port_main
from ml_autofocusformermod_torch.ckpt.from_jax import state_dict_from_flax
from ml_autofocusformermod_torch.models import maskfiner_ot, maskfiner_ud
from ml_autofocusformermod_torch.models.build import build_model
from ml_autofocusformermod_torch.models.layers import Dropout, DropPath
from ml_autofocusformermod_torch.models.mixres_neighbour import (
    MixResNeighbour,
)
from ml_autofocusformermod_torch.train import curriculum
from ml_autofocusformermod_torch.train.losses import smooth_one_hot
from ml_autofocusformermod_torch.train.trainer import (
    create_train_state, make_train_step, model_loss,
)
from test_torch_maskfiner import PORT_CFG, port_tiny_mr
from torch_maskfiner_reference import (
    FIRST_TRAIN, LEVEL_D, SMOOTHING, TRAIN, run_reference, unflatten,
)

torch.set_num_threads(1)
ATOL, RTOL = 1e-5, 1e-4
TINY_UD = port_tiny_mr("maskfiner_up_down_mini.yaml")


@pytest.fixture(scope="module")
def train_refs(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("maskfiner_train"),
                         ["ot_train", FIRST_TRAIN], ["ud_train", "ud_train_r1"],
                         ["ud_aux_train"])


def _variables(refs, case):
    return {"params": unflatten(refs, f"{case}/params"),
            "batch_stats": unflatten(refs, f"{case}/batch_stats")}


def _assert_grads_and_stats(port, refs, case):
    """Every parameter gradient of ``port`` and its BatchNorm running
    statistics against the JAX case's."""
    g_ref = state_dict_from_flax({"params": unflatten(refs, f"{case}/grad")})
    params = dict(port.named_parameters())
    assert set(params) == set(g_ref)
    for name, p in params.items():
        want = g_ref[name].numpy()
        got = p.grad if p.grad is not None else torch.zeros_like(p)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=RTOL,
            atol=ATOL + RTOL * np.abs(want).max(), err_msg=name)
    stats = {k: v for k, v in state_dict_from_flax(
        {"batch_stats": unflatten(refs, f"{case}/new_stats")}).items()
        if not k.endswith("num_batches_tracked")}
    buffers = {k: b for k, b in port.named_buffers()
               if not k.endswith("num_batches_tracked")}
    assert set(buffers) == set(stats)
    for name, want in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), want.numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("case", list(TRAIN))
def test_maskfiner_training_gradients_match_jax(case, train_refs,
                                                monkeypatch):
    preset, opts, ratios = TRAIN[case]
    port = build_model(port_tiny_mr(preset, **opts), "cpu",
                       upscale_ratios=ratios)
    port.load_state_dict(state_dict_from_flax(_variables(train_refs, case)),
                         strict=True)
    masks = []

    def replay(model, j, b, n, device):
        assert model.training
        m = torch.from_numpy(train_refs[f"{case}/mask/{j}"])
        assert tuple(m.shape) == (b, n)
        masks.append(j)
        return m.to(device)

    monkeypatch.setattr(maskfiner_ot, "random_upsampling_mask", replay)
    monkeypatch.setattr(maskfiner_ud, "random_upsampling_mask", replay)
    port.train()
    x = torch.from_numpy(train_refs[f"{case}/in/x"]).permute(0, 3, 1, 2)
    labels = torch.from_numpy(train_refs[f"{case}/in/labels"])
    outputs = port(x.contiguous())
    if case == "ud_aux_train":
        assert isinstance(outputs, list) and len(outputs) == 4
    loss = model_loss(outputs, smooth_one_hot(labels, 10, SMOOTHING))
    loss.backward()
    assert masks == [0, 1, 2]
    np.testing.assert_allclose(loss.item(), train_refs[f"{case}/out/loss"],
                               atol=ATOL, rtol=RTOL)
    _assert_grads_and_stats(port, train_refs, case)


def test_first_level_batchnorm_training_matches_jax(train_refs):
    """A first-layer MixResNeighbour (BatchNorm patch embedding, then a
    clustered attention stage) in training mode: the batch statistics
    normalise, the running ones update with flax's momentum 0.9 and biased
    variance, and every gradient matches."""
    case = FIRST_TRAIN
    level = MixResNeighbour(
        patch_sizes=(8,), n_layers=1, d_model=LEVEL_D, n_heads=2,
        mlp_ratio=2.0, n_scales=4, cluster_size=8, nbhd_size=32,
        min_patch_size=4, upscale_ratio=0.0, scale=0, first_layer=True,
        drop_path_rate=(0.0,))
    level.load_state_dict(
        state_dict_from_flax(_variables(train_refs, case)), strict=True)
    level.train()
    im = torch.from_numpy(train_refs[f"{case}/in/im"])
    outs, _ = level(im, 0, None, None, None, {})
    loss = (outs["res5"] * torch.from_numpy(train_refs[f"{case}/in/w"])).sum()
    loss.backward()
    np.testing.assert_allclose(loss.item(), train_refs[f"{case}/out/loss"],
                               atol=ATOL, rtol=RTOL)
    _assert_grads_and_stats(level, train_refs, case)


def test_main_trains_maskfiner_through_the_curriculum_on_cpu(tmp_path,
                                                            capsys,
                                                            monkeypatch):
    """Two synthetic epochs of 4 steps: ratio 1.0, then the quantised
    0.875 -> 0.9. Setting the second ratios leaves the parameters, the
    BatchNorm statistics and the AdamW moments as the first epoch left
    them, and the optimizer counts on."""
    states, seen = [], []
    real_make, real_set = port_main.make_train_step, \
        curriculum.set_upsample_ratios

    def make(config, state, schedule):
        states.append(state)
        return real_make(config, state, schedule)

    def snapshot(state):
        opt = state.optimizer.state
        return ({k: t.clone() for k, t in state.model.state_dict().items()},
                {m: {k: t.clone() for k, t in opt[m].items()}
                 for m in ("mu", "nu")}, opt["count"])

    def set_ratios(model, ratios):
        before = snapshot(states[-1])
        real_set(model, ratios)
        seen.append((list(ratios), before, snapshot(states[-1])))

    monkeypatch.setattr(port_main, "make_train_step", make)
    monkeypatch.setattr(curriculum, "set_upsample_ratios", set_ratios)
    mr = TINY_UD.MODEL.MR
    result = port_main.main([
        "--cfg", os.path.join(PORT_CFG, "maskfiner_up_down_mini.yaml"),
        "--device", "cpu", "--batch-size", "16", "--epochs", "2",
        "--data-path", str(tmp_path / "no_dataset"),
        "--output", str(tmp_path / "out"),
        "--opts", "MODEL.NUM_CLASSES", "10", "DATA.IMG_SIZE", "64",
        "TPU.COMPUTE_DTYPE", "float32",
        "MODEL.MR.EMBED_DIM", str(list(mr.EMBED_DIM)),
        "MODEL.MR.DEPTHS", str(list(mr.DEPTHS)),
        "MODEL.MR.NUM_HEADS", str(list(mr.NUM_HEADS)),
    ])
    printed = capsys.readouterr().out
    first, second = [0.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0], \
        [0.0, 0.9, 0.9, 0.9, 0.0, 0.0, 0.0]
    assert f"Upsampling ratios now {first}" in printed
    assert f"Upsampling ratios now {second}" in printed
    train = result["train"]
    assert [(e["epoch"], e["ratios"]) for e in train["epochs"]] == [
        (0, first), (1, second)]
    assert [r for r, _, _ in seen] == [first, second]
    assert train["state_step"] == 8 and train["skipped_steps"] == 0
    assert np.isfinite(train["train_loss"]) and 1.0 < train["train_loss"] < 5.0
    _, (params0, moments0, count0), _ = seen[0]
    _, (params, moments, count), (params_after, moments_after,
                                  count_after) = seen[1]
    assert count0 == 0 and count == count_after == 4
    for k, t in params.items():
        assert torch.equal(t, params_after[k]), k
    assert any(not torch.equal(t, params0[k]) for k, t in params.items())
    for m in ("mu", "nu"):
        for k, t in moments[m].items():
            assert torch.equal(t, moments_after[m][k]), (m, k)
        assert any(t.abs().max() > 0 for t in moments[m].values()), m
    assert states[-1].optimizer.state["count"] == 8
    assert os.path.exists(train["checkpoint"])


def test_upsampling_masks_are_fresh_in_training_and_fixed_at_eval(
        monkeypatch):
    """In training each forward draws new masks from the train state's
    CPU generator (so a generator state replays them); at eval the masks
    are fixed per shape. Two train steps split different tokens."""
    model = build_model(TINY_UD, "cpu")
    state, schedule = create_train_state(TINY_UD, model, 4)
    assert model.upsample_generator is state.upsample_generator
    draw = maskfiner_ot.random_upsampling_mask
    model.train()
    start = state.upsample_generator.get_state()
    a, b = draw(model, 0, 2, 16, "cpu"), draw(model, 0, 2, 16, "cpu")
    assert not torch.equal(a, b)
    state.upsample_generator.set_state(start)
    assert torch.equal(draw(model, 0, 2, 16, "cpu"), a)
    model.eval()
    c, d = draw(model, 0, 2, 16, "cpu"), draw(model, 0, 2, 16, "cpu")
    assert torch.equal(c, d)
    assert torch.equal(c, draw(build_model(TINY_UD, "cpu"), 0, 2, 16, "cpu"))

    drawn = []
    real = maskfiner_ud.random_upsampling_mask
    monkeypatch.setattr(maskfiner_ud, "random_upsampling_mask",
                        lambda *args: drawn.append(real(*args)) or drawn[-1])
    step = make_train_step(TINY_UD, state, schedule)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 3, 64, 64)).astype(np.float32))
    y = torch.tensor([1, 2])
    step(x, y)
    step(x, y)
    assert len(drawn) == 6
    for j in range(3):
        assert not torch.equal(drawn[j], drawn[3 + j]), j


@pytest.mark.parametrize("p", [0.2, 0.5])
def test_dropout_keeps_its_share_scales_and_replays(p):
    n = 200_000
    drop = Dropout(p).train()
    drop.generator = torch.Generator().manual_seed(3)
    x = torch.ones(n)
    y = drop(x)
    kept = y != 0
    share = kept.float().mean().item()
    assert abs(share - (1 - p)) < 5 * (p * (1 - p) / n) ** 0.5
    assert torch.all(y[kept] == 1.0 / (1.0 - p))
    drop.generator.manual_seed(3)
    assert torch.equal(drop(x), y)
    assert not torch.equal(drop(x), y)  # the generator moved on
    assert torch.equal(drop.eval()(x), x)


def test_dropout_edges_and_the_trainers_generator():
    x = torch.randn(4, 8)
    assert torch.equal(Dropout(0.0).train()(x), x)
    assert torch.equal(Dropout(1.0).train()(x), torch.zeros_like(x))
    cfg = port_tiny_mr("maskfiner_oracle_teacher.yaml")  # drops 0.2 at 1
    model = build_model(cfg, "cpu")
    state, _ = create_train_state(cfg, model, 4)
    drops = [m for m in model.modules() if isinstance(m, (Dropout, DropPath))]
    assert any(isinstance(m, Dropout) and m.p == 0.2 for m in drops)
    assert all(m.generator is state.drop_generator for m in drops)
    assert not any(isinstance(m, torch.nn.Dropout) for m in model.modules())


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a GPU")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_on_card(dtype):
    """The mask is drawn on the activations' device from a CUDA generator:
    keep share, exact scale, and the same mask from the same seed."""
    n, p = 1 << 20, 0.2
    drop = Dropout(p).train()
    drop.generator = torch.Generator(device="cuda").manual_seed(5)
    x = torch.ones(n, device="cuda", dtype=dtype)
    y = drop(x)
    kept = y != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 5 * (
        p * (1 - p) / n) ** 0.5
    assert bool((y[kept] == 1.0 / (1.0 - p)).all()) and y.dtype == dtype
    drop.generator.manual_seed(5)
    assert torch.equal(drop(x), y)
