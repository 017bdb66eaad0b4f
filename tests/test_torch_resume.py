"""Where ``main`` takes its weights from (JAX ``main.py:168-211``), on the
CPU: a port checkpoint given by ``--resume`` (or found by
``TRAIN.AUTO_RESUME``) is loaded before the throughput, the evaluation and
the training, and what the port cannot load raises instead of being
ignored: a reference ``.pth``, ``MODEL.PRETRAINED``,
``MODEL.AFF.PRETRAINED`` (ROADMAP A8) and a path that does not exist."""

import json
import os

import pytest
import torch

from ml_autofocusformermod_torch import main as port_main
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


@pytest.mark.parametrize("mode", ["--eval", "--throughput", "train"])
@pytest.mark.parametrize("case", ["pth", "pretrained", "aff_pretrained",
                                  "missing"])
def test_main_refuses_weights_it_cannot_load(tmp_path, case, mode):
    """Each source the port cannot load raises before any work, in every
    mode; the message names ROADMAP A8 (or the missing file)."""
    missing = str(tmp_path / "nowhere.pt")
    extra, opts, error, match = {
        "pth": (["--resume", str(tmp_path / "ref.pth")], [],
                NotImplementedError, "queue A item 8"),
        "pretrained": ([], ["MODEL.PRETRAINED", str(tmp_path / "w.pth")],
                       NotImplementedError, "MODEL.PRETRAINED.*item 8"),
        "aff_pretrained": ([], ["MODEL.AFF.PRETRAINED", "w.pth"],
                           NotImplementedError,
                           "MODEL.AFF.PRETRAINED.*item 8"),
        "missing": (["--resume", missing], [], FileNotFoundError,
                    "nowhere.pt"),
    }[case]
    if mode != "train":
        extra = [mode] + extra
    with pytest.raises(error, match=match):
        port_main.main(_argv(tmp_path, "--epochs", "1", *extra, opts=opts))
    assert not os.path.exists(tmp_path / "out")
