"""The port's entry point, config copy and import hygiene.

* ``main --eval --device cpu`` on a tiny config over the synthetic data;
* the copied presets are byte-equal to the JAX package's and load with the
  port's config loader;
* importing the whole port (and ``chip_smoke.py``) loads no ``jax*`` and no
  ``ml_autofocusformermod_tpu*`` module;
* entry points refuse CUDA when there is no GPU instead of running on CPU.
"""

import math
import os
import subprocess
import sys

import pytest
import torch
import yaml

from ml_autofocusformermod_torch import main as port_main
from ml_autofocusformermod_torch import resolve_device
from ml_autofocusformermod_torch.config import load_config
from ml_autofocusformermod_torch.models.build import build_model

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CFG = os.path.join(ROOT, "ml_autofocusformermod_tpu", "configs")
PORT_CFG = os.path.join(ROOT, "ml_autofocusformermod_torch", "configs")
TINY_OPTS = [
    "MODEL.AFF.DEPTHS", "[1, 1, 1, 1]",
    "MODEL.AFF.EMBED_DIM", "[16, 32, 48, 64]",
    "MODEL.AFF.NUM_HEADS", "[2, 2, 4, 4]",
    "MODEL.NUM_CLASSES", "10",
    "DATA.IMG_SIZE", "112",
    "TPU.COMPUTE_DTYPE", "float32",
]


def test_main_eval_on_cpu(tmp_path, capsys):
    result = port_main.main([
        "--cfg", os.path.join(PORT_CFG, "aff_mini.yaml"), "--eval",
        "--device", "cpu", "--batch-size", "8",
        "--data-path", str(tmp_path / "no_dataset"),
        "--opts", *TINY_OPTS,
    ])
    printed = capsys.readouterr().out
    assert "throughput averaged with 30 times" in printed
    assert "Accuracy of the network on 64 images" in printed
    assert result["throughput_img_s"] > 0
    assert 0.0 <= result["acc1"] <= result["acc5"] <= 100.0
    # random weights over 10 classes: the loss sits near log(10)
    assert math.isfinite(result["loss"]) and 1.0 < result["loss"] < 5.0


def test_presets_are_copies_of_the_jax_package():
    """Every preset (AFF and MaskFiner) is copied byte for byte, and
    loads. PyYAML is installed wherever the port runs, so the copies are
    read with it."""
    jax_presets = sorted(n for n in os.listdir(JAX_CFG)
                         if n.endswith(".yaml"))
    assert sorted(os.listdir(PORT_CFG)) == jax_presets
    assert sum(n.startswith("maskfiner_") for n in jax_presets) == 6
    for name in jax_presets:
        with open(os.path.join(JAX_CFG, name), "rb") as f:
            want = f.read()
        with open(os.path.join(PORT_CFG, name), "rb") as f:
            assert f.read() == want, name
        assert isinstance(yaml.safe_load(want), dict)
        c = load_config(os.path.join(PORT_CFG, name))
        family = {"aff": "aff", "maskfiner_oracle": "maskfinerOT",
                  "maskfiner_up": "maskfinerUD"}
        assert c.MODEL.TYPE == next(t for p, t in family.items()
                                    if name.startswith(p))


def test_config_overrides_match_the_jax_loader():
    c = load_config(os.path.join(PORT_CFG, "aff_mini.yaml"),
                    opts=["TRAIN.EPOCHS", "5", "MODEL.AFF.DS_RATE", "0.2"],
                    batch_size=64, eval=True)
    assert c.MODEL.AFF.EMBED_DIM == [32, 128, 256, 384]
    assert c.MODEL.AFF.NUM_HEADS == [2, 4, 8, 16]
    assert c.TRAIN.EPOCHS == 5 and c.MODEL.AFF.DS_RATE == 0.2
    assert c.DATA.BATCH_SIZE == 64 and c.EVAL_MODE is True
    assert c.TRAIN.BASE_LR == 5e-4  # "5e-4" is a string to PyYAML


def test_import_hygiene():
    """The port and chip_smoke.py import neither JAX nor the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ml_autofocusformermod_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "new = {'ml_autofocusformermod_torch.models.' + m for m in\n"
        "       ('mixres_common', 'mixres_vit', 'mixres_neighbour',\n"
        "        'maskfiner_ot', 'maskfiner_ud')}\n"
        "new |= {'ml_autofocusformermod_torch.' + m for m in\n"
        "        ('data.imagenet', 'data.transforms', 'data.native_jpeg',\n"
        "         'data.prefetch', 'ckpt.pth_import')}\n"
        "assert new <= set(sys.modules), new - set(sys.modules)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'ml_autofocusformermod_tpu'))\n"
        "assert not bad, bad\n"
        "assert 'PIL' not in sys.modules, 'Pillow is imported lazily'\n"
        "print('clean', len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("clean")


def test_cuda_entry_points_refuse_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA is a valid device here")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(load_config(os.path.join(PORT_CFG, "aff_mini.yaml")))


def test_unknown_model_type_raises():
    """An unknown ``MODEL.TYPE`` raises. (MaskFiner training, which this
    test once checked was refused, runs since ROADMAP A10b:
    ``test_torch_maskfiner_train.py::
    test_main_trains_maskfiner_through_the_curriculum_on_cpu``.)"""
    c = load_config(os.path.join(PORT_CFG, "aff_mini.yaml"),
                    opts=["MODEL.TYPE", "nosuchmodel"])
    with pytest.raises(NotImplementedError, match="nosuchmodel"):
        build_model(c, device="cpu")
