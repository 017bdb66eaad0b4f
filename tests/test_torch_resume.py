"""Where ``main`` takes its weights from (JAX ``main.py:168-211``), on the
CPU: a port checkpoint given by ``--resume`` (or found by
``TRAIN.AUTO_RESUME``) is loaded before the throughput, the evaluation and
the training; reference ``.pth`` weights (``--resume x.pth``,
``MODEL.PRETRAINED``, ``MODEL.AFF.PRETRAINED``, which wins over
``MODEL.PRETRAINED``) are loaded before the throughput in every mode; a
path that does not exist, or a URL, raises before any work."""

import json
import os

import pytest
import torch

from ml_autofocusformermod_torch import main as port_main
from ml_autofocusformermod_torch.config import load_config
from ml_autofocusformermod_torch.data.imagenet import build_loaders
from ml_autofocusformermod_torch.models.build import build_model
from ml_autofocusformermod_torch.train.trainer import make_eval_step
from test_torch_train import PORT_CFG, TINY

torch.set_num_threads(1)


def _argv(tmp_path, *extra, opts=()):
    flat = []
    for k, v in TINY.items():
        if k != "DATA.BATCH_SIZE":
            flat += [k, json.dumps(v) if not isinstance(v, str) else v]
    return ["--cfg", PORT_CFG, "--device", "cpu", "--batch-size", "16",
            "--data-path", str(tmp_path / "no_dataset"),
            "--output", str(tmp_path / "out"), *extra,
            "--opts", *flat, *opts]


def test_main_eval_resume_reproduces_the_saved_models_loss(tmp_path,
                                                           capsys):
    """Train the tiny AFF for one epoch; ``--eval --resume`` of its
    checkpoint prints the loss the training run's own validation printed
    for it, and auto-resume finds the same checkpoint."""
    trained = port_main.main(_argv(tmp_path, "--epochs", "1"))["train"]
    capsys.readouterr()
    ckpt = trained["checkpoint"]
    evaluated = port_main.main(_argv(tmp_path / "eval", "--eval",
                                     "--resume", ckpt))
    printed = capsys.readouterr().out
    assert f"=> loaded {ckpt} (epoch 0)" in printed
    assert f"loss {trained['val_loss']:.4f}" in printed
    assert evaluated["loss"] == trained["val_loss"]
    assert evaluated["acc1"] == trained["acc1"]
    # the same output directory: auto-resume takes the newest checkpoint
    auto = port_main.main(_argv(tmp_path, "--eval"))
    assert f"=> loaded {ckpt}" in capsys.readouterr().out
    assert auto["loss"] == trained["val_loss"]
    # a random init reports another loss
    fresh = port_main.main(_argv(tmp_path / "fresh", "--eval"))
    assert fresh["loss"] != trained["val_loss"]


def _tiny_config(tmp_path):
    """The config ``_argv`` gives ``main`` (batch 16, synthetic data)."""
    opts = ["DATA.BATCH_SIZE", "16",
            "DATA.DATA_PATH", str(tmp_path / "no_dataset")]
    for k, v in TINY.items():
        if k != "DATA.BATCH_SIZE":
            opts += [k, json.dumps(v) if not isinstance(v, str) else v]
    return load_config(PORT_CFG, opts=opts)


@pytest.mark.parametrize("mode", ["--eval", "--throughput", "train"])
@pytest.mark.parametrize("case", ["pth", "pretrained", "aff_pretrained"])
def test_main_loads_reference_weights(tmp_path, monkeypatch, case, mode):
    """Reference weights (a ``{'model': state_dict}`` file of the tiny AFF
    built from seed 1; ``main`` builds from seed 0) reach the model before
    the throughput in every mode: the logits the throughput's model gives
    on its batch equal those of the seed-1 model, and ``--eval``'s loss
    equals the seed-1 model's. ``MODEL.AFF.PRETRAINED`` wins over
    ``MODEL.PRETRAINED`` (a seed-2 file there); ``--resume x.pth`` loads
    weights only, so training still starts at epoch 0."""
    cfg = _tiny_config(tmp_path)
    ref = build_model(cfg, "cpu", seed=1)
    torch.save({"model": ref.state_dict()}, tmp_path / "seed1.pth")
    torch.save({"model": build_model(cfg, "cpu", seed=2).state_dict()},
               tmp_path / "seed2.pth")
    extra, opts = {
        "pth": (["--resume", str(tmp_path / "seed1.pth")], []),
        "pretrained": ([], ["MODEL.PRETRAINED", str(tmp_path / "seed1.pth")]),
        "aff_pretrained": ([], ["MODEL.PRETRAINED",
                                str(tmp_path / "seed2.pth"),
                                "MODEL.AFF.PRETRAINED",
                                str(tmp_path / "seed1.pth")]),
    }[case]
    seen = {}

    def fake_throughput(model, images):
        with torch.no_grad():
            seen["logits"] = model.eval()(images)
        seen["images"] = images
        return 1.0

    monkeypatch.setattr(port_main, "throughput", fake_throughput)
    if mode != "train":
        extra = [mode] + extra
    result = port_main.main(_argv(tmp_path, "--epochs", "1", *extra,
                                  opts=opts))
    with torch.no_grad():
        want = ref.eval()(seen["images"])
    assert torch.equal(seen["logits"], want)
    loaded = result["weights"]["resume_pth" if case == "pth"
                               else "pretrained"]
    assert loaded["path"] == str(tmp_path / "seed1.pth")
    assert loaded["missing"] == [] and loaded["unexpected"] == []
    if mode == "--eval":
        _, val, _ = build_loaders(cfg)
        want = port_main.validate(make_eval_step(None, ref), val, "cpu")
        assert result["val_count"] == want["count"] == 64
        assert result["loss"] == want["loss"]
    if mode == "train":
        assert result["train"]["start_epoch"] == 0
        assert result["train"]["steps"] == 4


@pytest.mark.parametrize("mode", ["--eval", "--throughput", "train"])
@pytest.mark.parametrize("case", ["missing", "missing_pretrained", "url"])
def test_main_refuses_weights_it_cannot_load(tmp_path, case, mode):
    """A weights path that does not exist (``--resume`` or
    ``MODEL.PRETRAINED``) or a URL raises before any work, in every
    mode."""
    missing = str(tmp_path / "nowhere.pt")
    extra, opts, error, match = {
        "missing": (["--resume", missing], [], FileNotFoundError,
                    "nowhere.pt"),
        "missing_pretrained": ([], ["MODEL.PRETRAINED",
                                    str(tmp_path / "w.pth")],
                               FileNotFoundError, "MODEL.PRETRAINED.*w.pth"),
        "url": ([], ["MODEL.AFF.PRETRAINED", "https://example.org/w.pth"],
                ValueError, "MODEL.AFF.PRETRAINED.*URL"),
    }[case]
    if mode != "train":
        extra = [mode] + extra
    with pytest.raises(error, match=match):
        port_main.main(_argv(tmp_path, "--epochs", "1", *extra, opts=opts))
    assert not os.path.exists(tmp_path / "out")
