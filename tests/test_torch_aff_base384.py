"""AFF-Base-384 fine-tuning, the preset ``aff_base_22kto1k_384.yaml``,
and the benchmark's configuration file of it
(``h100bench/configs/aff_base384.json``), on the CPU:

* the file holds the preset as published (widths, depths, heads, MLP
  ratio, clusters and neighbourhoods, layer scale, DropPath,
  accumulation, mixup / cutmix, learning rates and weight decay), both
  in the program's options and in the reference's blocks, and the port
  builds it from the preset and those options with 75.34 M parameters
  (no forward);
* at its block settings (clusters of 24 in neighbourhoods of 144, MLP
  ratio 3, heads of 32 channels, layer scale, DropPath 0.2, mixup and
  cutmix, 4 micro-steps per update) with one block a stage, half the
  widths and a 128² image (n = 1024 and 256 in the local stages), the
  port's training step matches the benchmark's plain reference
  (``h100bench/reference``) over one update, at the Mini tests'
  tolerances; the seed takes both the mixup and the cutmix branch.
"""

import json
from pathlib import Path

import torch
import yaml

from h100bench import loops
from ml_autofocusformermod_torch.config import load_config
from ml_autofocusformermod_torch.models.build import build_model
from ml_autofocusformermod_torch.train import losses
from ml_autofocusformermod_torch.utils.flops import count_params

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PRESET = "ml_autofocusformermod_torch/configs/aff_base_22kto1k_384.yaml"
CONFIG = ROOT / "h100bench/configs/aff_base384.json"
# the Mini tests' tolerances of a sound float32 step
TOLERANCE = {"loss_gap": 1e-6, "grad_gap": 1e-4, "update_gap": 1e-4}


def _preset():
    with open(ROOT / PRESET) as f:
        return yaml.safe_load(f)


def _file():
    return json.loads(CONFIG.read_text())


def test_configuration_file_is_the_preset():
    cfg, preset = _file(), _preset()
    aff, train, aug = preset["MODEL"]["AFF"], preset["TRAIN"], preset["AUG"]
    assert cfg["preset"] == PRESET and cfg["reduced"] == []
    arch, hp = cfg["model"]["arch"], cfg["train"]
    assert (arch["depths"], arch["embed_dim"], arch["num_heads"]) == (
        aff["DEPTHS"], aff["EMBED_DIM"], aff["NUM_HEADS"])
    assert arch["mlp_ratio"] == aff["MLP_RATIO"]
    assert (arch["cluster_size"], arch["nbhd_size"]) == (
        aff["CLUSTER_SIZE"], aff["NBHD_SIZE"])
    assert (arch["alpha"], arch["ds_rate"]) == (aff["ALPHA"], aff["DS_RATE"])
    assert arch["layer_scale"] == float(aff["LAYER_SCALE"])
    assert arch["drop_path_rate"] == preset["MODEL"]["DROP_PATH_RATE"]
    assert arch["img_size"] == cfg["img_size"] == preset["DATA"]["IMG_SIZE"]
    assert hp["accumulation_steps"] == train["ACCUMULATION_STEPS"]
    assert (hp["mixup"], hp["cutmix"]) == (aug["MIXUP"], aug["CUTMIX"])
    # 16 a card over 8 cards and 4 micro-steps: the global 512 the
    # learning rates are stated for, so they are taken as they are
    for k in ("base_lr", "warmup_lr", "min_lr", "weight_decay"):
        assert hp[k] == float(train[k.upper()]), k
    assert (hp["epochs"], hp["warmup_epochs"]) == (
        train["EPOCHS"], train["WARMUP_EPOCHS"])
    # epoch 15 of 30: 1281167 images over 128 a micro-step, 4 an update
    assert hp["steps_per_epoch"] == 1281167 // 128
    assert hp["start_step"] == 15 * (hp["steps_per_epoch"] // 4)
    # the program reads the same numbers from the options
    config = load_config(str(ROOT / PRESET), opts=_opts(cfg))
    assert config.DATA.BATCH_SIZE == preset["DATA"]["BATCH_SIZE"]
    assert config.TRAIN.ACCUMULATION_STEPS == hp["accumulation_steps"]
    assert (config.AUG.MIXUP, config.AUG.CUTMIX) == (hp["mixup"],
                                                     hp["cutmix"])
    assert config.MODEL.DROP_PATH_RATE == arch["drop_path_rate"]
    assert config.MODEL.AFF.LAYER_SCALE == arch["layer_scale"]
    assert (config.TRAIN.BASE_LR, config.TRAIN.WARMUP_LR,
            config.TRAIN.MIN_LR, config.TRAIN.WEIGHT_DECAY) == (
        hp["base_lr"], hp["warmup_lr"], hp["min_lr"], hp["weight_decay"])
    assert config.TRAIN.CLIP_GRAD == hp["clip_grad"]
    assert config.MODEL.LABEL_SMOOTHING == hp["label_smoothing"]


def _opts(cfg):
    opts = []
    for k, v in cfg["opts"].items():
        opts += [k, str(v)]
    return opts


def test_preset_is_published_aff_base_with_75_34m_parameters(monkeypatch):
    # the preset with the configuration file's options, as the
    # benchmark's program.build loads it
    config = load_config(str(ROOT / PRESET), opts=_opts(_file()))
    aff, train = config.MODEL.AFF, config.TRAIN
    assert list(aff.DEPTHS) == [3, 4, 18, 2]
    assert list(aff.EMBED_DIM) == [128, 256, 512, 1024]
    assert list(aff.NUM_HEADS) == [4, 8, 16, 32]
    assert aff.MLP_RATIO == 3.0
    assert aff.CLUSTER_SIZE == 24 and list(aff.NBHD_SIZE) == [144] * 4
    assert aff.LAYER_SCALE == 1e-5
    assert config.MODEL.DROP_PATH_RATE == 0.2
    assert config.DATA.IMG_SIZE == 384 and config.DATA.BATCH_SIZE == 16
    assert train.ACCUMULATION_STEPS == 4
    assert (config.AUG.MIXUP, config.AUG.CUTMIX) == (0.8, 1.0)
    assert (train.BASE_LR, train.WARMUP_LR, train.MIN_LR) == (
        2e-5, 2e-8, 2e-7)
    assert train.WEIGHT_DECAY == 1e-8
    # the count needs no initial values: skip the random init's draws
    monkeypatch.setattr(torch.nn.init, "trunc_normal_", lambda t, **_: t)
    model = build_model(config, device="cpu")
    assert round(count_params(model) / 1e6, 2) == 75.34


def _small():
    """The benchmark's configuration file with fewer blocks, narrower
    stages (heads of 32 channels, as published) and a small image, in
    float32, set alike in the program's options and the reference's
    blocks; every other setting is the file's."""
    depths, widths, heads, img = [1] * 4, [64, 128, 256, 512], \
        [2, 4, 8, 16], 128
    cfg = _file()
    cfg["img_size"] = img
    cfg["model"]["arch"].update(img_size=img, depths=depths,
                                embed_dim=widths, num_heads=heads)
    cfg["opts"].update({
        "DATA.IMG_SIZE": img, "MODEL.AFF.DEPTHS": depths,
        "MODEL.AFF.EMBED_DIM": widths, "MODEL.AFF.NUM_HEADS": heads,
        "TPU.COMPUTE_DTYPE": "float32"})
    return cfg


def test_train_step_at_its_block_settings_equals_reference(monkeypatch):
    cfg = _small()
    traffic = {"kind": "train", "batch": 2, "pool": 4, "check_steps": 4,
               "warmup_steps": 4, "trace_steps": 1}
    loop = loops.TrainLoop(cfg, traffic, 2**31 + 41, "cpu")
    # a lambda is drawn for every mixed batch, a box for every cutmix one
    drawn = {"_beta": 0, "_rand_bbox": 0}
    for name in drawn:
        def counted(*a, _f=getattr(losses, name), _n=name):
            drawn[_n] += 1
            return _f(*a)
        monkeypatch.setattr(losses, name, counted)
    loop.setup()
    assert (drawn["_beta"] - drawn["_rand_bbox"], drawn["_rand_bbox"]) \
        == (2, 2), drawn
    r = loop.check()
    for name, tol in TOLERANCE.items():
        assert r[name] < tol, (name, r)
