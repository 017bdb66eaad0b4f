"""The plain reference against the measured package's plain (CPU) path at
the configurations' published widths and a small batch, in float32: the
eval forward of AFF-Mini and UD-Mini and one training step of each; and
the import hygiene of the benchmark as a whole."""

import ast
import json
import statistics
from pathlib import Path

import pytest
import torch

from h100bench import check, data, reference
from h100bench.reference.train import replay_steps

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "h100bench"
JAX_NAMES = {"jax", "jaxlib", "flax", "ml_autofocusformermod_tpu"}
PORT = "ml_autofocusformermod_torch"


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def _port(cfg):
    from ml_autofocusformermod_torch.config import load_config
    from ml_autofocusformermod_torch.models.build import build_model
    from ml_autofocusformermod_torch.train.curriculum import (
        set_upsample_ratios)

    opts = []
    for k, v in cfg["opts"].items():
        opts += [k, str(v)]
    opts += ["TPU.COMPUTE_DTYPE", "float32"]
    config = load_config(str(ROOT / cfg["preset"]), opts=opts)
    model = build_model(config, device="cpu")
    if "upscale_ratios" in cfg["model"]:
        set_upsample_ratios(model, cfg["model"]["upscale_ratios"])
    return config, model


@pytest.mark.parametrize("name", ["aff_mini", "ud_mini"])
def test_reference_forward_equals_port(name):
    cfg = _cfg(name)
    _, port = _port(cfg)
    ref = reference.build(cfg["model"])
    assert set(ref.state_dict()) == set(port.state_dict())
    w = data.make_weights(data.float_state_shapes(port), 3, "cpu")
    port.load_state_dict(w, strict=False)
    ref.load_state_dict(w, strict=False)
    (x, _), = data.make_batches(3, 1, 2, cfg["img_size"], 1000, "cpu")
    with torch.no_grad():
        gap = check.logit_gap(port(x).float(), ref(x))
    assert gap < 1e-5


@pytest.mark.parametrize("name", ["aff_mini", "ud_mini"])
def test_reference_train_step_equals_port(name):
    from ml_autofocusformermod_torch.train.trainer import (
        create_train_state, make_train_step)

    cfg = _cfg(name)
    config, port = _port(cfg)
    w = data.make_weights(data.float_state_shapes(port), 4, "cpu")
    port.load_state_dict(w, strict=False)
    start = {k: p.detach().clone() for k, p in port.named_parameters()}
    batches = data.make_batches(4, 2, 2, cfg["img_size"], 1000, "cpu")
    hp = cfg["train"]
    state, schedule = create_train_state(
        config, port, n_steps_per_epoch=hp["steps_per_epoch"])
    state.optimizer.load_state_dict({"sched_count": hp["start_step"]})
    port.upsample_generator = torch.Generator().manual_seed(9)
    step = make_train_step(config, state, schedule)
    losses = []
    for i, (x, y) in enumerate(batches):
        losses.append(float(step(x, y)["loss"]))
        if i == 0:
            grads = {k: m / (1 - hp["betas"][0])
                     for k, m in state.optimizer.state["mu"].items()}
    end = {k: p.detach().clone() for k, p in port.named_parameters()}

    ref = reference.build(cfg["model"])
    ref.load_state_dict(w, strict=False)
    ref.upsample_generator = torch.Generator().manual_seed(9)
    out = replay_steps(ref, batches, hp, 1000)
    r = check.train_readings(losses, grads, start, end, out)
    assert r["loss_gap"] < 1e-6
    assert r["grad_gap"] < 1e-4
    assert r["update_gap"] < 1e-4


def test_reference_checkpointed_blocks_give_the_same_step():
    cfg = _cfg("aff_mini")
    w = data.make_weights(data.float_state_shapes(
        reference.build(cfg["model"])), 5, "cpu")
    batches = data.make_batches(5, 1, 2, cfg["img_size"], 1000, "cpu")
    outs = []
    for ckpt in (False, True):
        ref = reference.build(cfg["model"])
        ref.load_state_dict(w, strict=False)
        ref.set_checkpoint(ckpt)
        outs.append(replay_steps(ref, batches, cfg["train"], 1000))
    assert outs[0]["losses"] == outs[1]["losses"]
    # to rounding, against the larger of the leaf's norm and the median
    # leaf's: the bias ahead of the batch-statistics BatchNorm has a
    # gradient of round-off alone, which differs from run to run
    norms = {k: float(g.norm()) for k, g in outs[1]["grads"].items()}
    median = statistics.median(norms.values())
    for k, g in outs[0]["grads"].items():
        diff = float((g - outs[1]["grads"][k]).norm())
        assert diff <= 1e-5 * max(norms[k], median), k


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        for mod in _imports(f):
            assert mod.split(".")[0] not in JAX_NAMES, (f, mod)


def test_reference_imports_nothing_of_the_port():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top != PORT and top not in JAX_NAMES, (f, mod)
            if top == "h100bench":  # only the reference itself
                assert mod.startswith("h100bench.reference"), (f, mod)


def test_a_run_loads_no_jax_module(tmp_path):
    """A fresh process that imports the benchmark's modules, the port and
    the reference finds none of the forbidden names in sys.modules."""
    import subprocess
    import sys

    code = ("import sys, h100bench.run as r, h100bench.loops, "
            "h100bench.calibrate, h100bench.program as p, "
            "ml_autofocusformermod_torch.train.trainer, "
            "ml_autofocusformermod_torch.models.build, "
            "ml_autofocusformermod_torch.utils.flops\n"
            "print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
