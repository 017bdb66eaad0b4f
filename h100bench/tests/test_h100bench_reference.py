"""The plain reference against the measured package's plain (CPU) path at
the configurations' published widths and a small batch, in float32: the
eval forward of AFF-Mini and UD-Mini and one training step of each; the
training check (``loops.TrainLoop``) of a small AFF with each feature of
the published presets on (layer scale, stochastic depth, mixup and
cutmix, gradient accumulation, clusters of 24 in neighbourhoods of 144)
and of a small UD with layer scale and stochastic depth; the chunked
local attention; the faults of those features; and the import hygiene of
the benchmark as a whole."""

import ast
import json
import statistics
from pathlib import Path

import pytest
import torch

from h100bench import check, data, faults, loops, reference
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


# the Mini tests' tolerances of a sound float32 step
TOLERANCE = {"loss_gap": 1e-6, "grad_gap": 1e-4, "update_gap": 1e-4}


def _aff(img=64, depths=(1, 1, 2, 1), layer_scale=0.0, drop_path=0.0,
         mixup=0.0, cutmix=0.0, accum=1, cs=8, nbhd=(48, 48, 48, 49),
         chunk=0):
    """AFF-Mini's widths with fewer blocks at a small image, the features
    set alike in the program's opts and the reference's blocks."""
    cfg = _cfg("aff_mini")
    cfg["model"]["arch"].update(
        img_size=img, depths=list(depths), cluster_size=cs,
        nbhd_size=list(nbhd), layer_scale=layer_scale,
        drop_path_rate=drop_path)
    if chunk:
        cfg["model"]["ref_query_chunk"] = chunk
    cfg["img_size"] = img
    cfg["train"].update(mixup=mixup, cutmix=cutmix, accumulation_steps=accum)
    cfg["opts"].update({
        "DATA.IMG_SIZE": img, "MODEL.AFF.DEPTHS": list(depths),
        "MODEL.AFF.CLUSTER_SIZE": cs, "MODEL.AFF.NBHD_SIZE": list(nbhd),
        "MODEL.AFF.LAYER_SCALE": layer_scale,
        "MODEL.DROP_PATH_RATE": drop_path, "AUG.MIXUP": mixup,
        "AUG.CUTMIX": cutmix, "TRAIN.ACCUMULATION_STEPS": accum,
        "TPU.COMPUTE_DTYPE": "float32"})
    return cfg


def _ud(img=128, depths=(1, 1, 1, 2, 1, 2, 1), layer_scale=1e-5,
        drop_path=0.3):
    cfg = _cfg("ud_mini")
    cfg["model"]["mr"].update(depths=list(depths), layer_scale=layer_scale,
                              drop_path_rate=drop_path)
    cfg["img_size"] = img
    cfg["opts"].update({
        "DATA.IMG_SIZE": img, "MODEL.MR.DEPTHS": list(depths),
        "MODEL.MR.LAYER_SCALE": layer_scale,
        "MODEL.MR.DROP_PATH_RATE": drop_path,
        "TPU.COMPUTE_DTYPE": "float32"})
    return cfg


def _readings(cfg, seed, steps, fault=None):
    """The training check's numbers after ``steps`` micro-steps at b2."""
    traffic = {"kind": "train", "batch": 2, "pool": steps,
               "check_steps": steps, "warmup_steps": steps, "trace_steps": 1}
    loop = loops.TrainLoop(cfg, traffic, seed, "cpu", fault)
    loop.setup()
    return loop.check()


def _cut_coins(seed, steps, img):
    """Whether each micro-step's coin picks cutmix, for the run ``seed``:
    the program's mixup draws (``train/losses.py::mixup_cutmix``) with
    both alphas on and every mix applied."""
    gen = torch.Generator().manual_seed(data.stream_seed(seed, data.MASKS))
    coins = []
    for _ in range(steps):
        torch.rand((), generator=gen)
        coins.append(float(torch.rand((), generator=gen)) < 0.5)
        torch.randint(0, 2**62, (), generator=gen)
        if coins[-1]:
            torch.randint(0, img, (), generator=gen)
            torch.randint(0, img, (), generator=gen)
    return coins


def _seed_with(cut: bool, steps: int, img: int) -> int:
    return next(s for s in range(2**31, 2**31 + 200)
                if _cut_coins(s, steps, img) == [cut] * steps)


FEATURES = {
    "layer_scale": dict(layer_scale=1e-5),
    "drop_path": dict(drop_path=0.2),
    "mixup": dict(mixup=0.8, cutmix=1.0),
    "cutmix": dict(mixup=0.8, cutmix=1.0),
    "accumulation": dict(accum=2),
    "clusters_of_24": dict(img=128, cs=24, nbhd=(144, 144, 144, 144)),
}


@pytest.mark.parametrize("feature", FEATURES)
def test_training_check_of_a_feature_equals_port(feature):
    cfg = _aff(**FEATURES[feature])
    steps = 4 if feature == "accumulation" else 2
    seed = 2**31 + 17
    if feature in ("mixup", "cutmix"):  # every micro-step on the branch
        seed = _seed_with(feature == "cutmix", steps, cfg["img_size"])
    r = _readings(cfg, seed, steps)
    for name, tol in TOLERANCE.items():
        assert r[name] < tol, (name, r)


def test_training_check_of_ud_with_layer_scale_and_drop_path_equals_port():
    r = _readings(_ud(), 2**31 + 5, 2)
    for name, tol in TOLERANCE.items():
        assert r[name] < tol, (name, r)


@pytest.mark.parametrize("make", [_aff, _ud], ids=["aff", "ud"])
def test_layer_scale_leaves_in_the_ports_order(make):
    """One flat draw over the state dict gives both sides the same
    tensors only if their leaves come in one order; the gammas are drawn
    as a norm's scale."""
    from ml_autofocusformermod_torch.config import load_config
    from ml_autofocusformermod_torch.models.build import build_model

    cfg = make(layer_scale=1e-5)
    opts = [x for k, v in cfg["opts"].items() for x in (k, str(v))]
    port = build_model(load_config(str(ROOT / cfg["preset"]), opts=opts),
                       device="cpu")
    ref = reference.build(cfg["model"])
    assert list(ref.state_dict()) == list(port.state_dict())
    w = data.make_weights(data.float_state_shapes(ref), 6, "cpu")
    gammas = torch.cat([t for k, t in w.items() if "gamma" in k])
    assert gammas.numel() > 0
    assert abs(float(gammas.mean()) - 1.0) < 0.05
    assert abs(float(gammas.std()) - 0.1) < 0.02


def test_chunked_local_attention_gives_the_unchunked_step():
    """Queries in checkpointed chunks of 100 (a ragged last one, at 1024
    and 256 tokens in the local stages) against all at once."""
    batches = data.make_batches(8, 1, 2, 128, 1000, "cpu")
    outs = []
    for chunk in (0, 100):
        cfg = _aff(img=128, cs=24, nbhd=(144, 144, 144, 144),
                   layer_scale=1e-5, chunk=chunk)
        ref = reference.build(cfg["model"])
        ref.load_state_dict(data.make_weights(
            data.float_state_shapes(ref), 8, "cpu"), strict=False)
        ref.set_checkpoint(True)
        outs.append(replay_steps(ref, batches, cfg["train"], 1000))
    assert outs[0]["losses"] == pytest.approx(outs[1]["losses"], rel=1e-6)
    norms = {k: float(g.norm()) for k, g in outs[0]["grads"].items()}
    median = statistics.median(norms.values())
    for k, g in outs[0]["grads"].items():
        diff = float((g - outs[1]["grads"][k]).norm())
        assert diff <= 1e-5 * max(norms[k], median), k


ALL_FEATURES = dict(layer_scale=1e-5, drop_path=0.2, mixup=0.8, cutmix=1.0,
                    accum=2)


@pytest.mark.parametrize("fault", [None, *faults.FEATURES])
def test_feature_faults_read_ten_times_a_sound_step(fault):
    """With every feature on, the sound program reads under the tolerances,
    and each feature's fault reads ten times one of them or more."""
    cfg = _aff(**ALL_FEATURES)
    assert set(faults.planted(cfg, "train")) >= set(faults.FEATURES)
    planted = faults.FEATURES[fault][0] if fault else None
    r = _readings(cfg, 2**31 + 23, 4, planted)
    over = max(r[name] / tol for name, tol in TOLERANCE.items())
    if fault is None:
        assert over < 1, r
    else:
        assert over >= 10, r


def test_check_steps_must_fill_whole_updates():
    traffic = {"kind": "train", "batch": 2, "pool": 3, "check_steps": 3,
               "warmup_steps": 3, "trace_steps": 1}
    loop = loops.TrainLoop(_aff(accum=2), traffic, 1, "cpu")
    with pytest.raises(ValueError, match="multiple"):
        loop.setup()


def test_the_aff_reference_refuses_keys_it_lacks():
    arch = dict(_cfg("aff_mini")["model"]["arch"], patch_norm=False)
    with pytest.raises(ValueError, match="patch_norm"):
        reference.build({"type": "aff", "arch": arch})


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
