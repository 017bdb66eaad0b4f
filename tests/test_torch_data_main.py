"""``main`` on a real ImageFolder, on the CPU: the tiny AFF of
``test_torch_train.py`` trains one epoch on a fabricated folder (two worker
processes decode it) from a reference ``.pth`` given as
``MODEL.PRETRAINED``, then ``--eval --resume`` reloads the epoch's
checkpoint. ``MODEL.NUM_CLASSES`` comes from the folder; the first batch
the train step receives is the JAX ``Loader``'s first batch; the
validation weights its short last batch by its rows."""

import json

import numpy as np
import pytest
import torch

from ml_autofocusformermod_torch import main as port_main
from ml_autofocusformermod_torch.config import load_config
from ml_autofocusformermod_torch.data.imagenet import Loader, build_dataset
from ml_autofocusformermod_torch.models.build import build_model
from ml_autofocusformermod_torch.train import trainer
from ml_autofocusformermod_tpu.config import load_config as jax_load_config
from ml_autofocusformermod_tpu.data import imagenet as jax_data
from test_torch_data import JAX_CFG, PORT_CFG, make_fake_imagenet
from test_torch_train import TINY

torch.set_num_threads(1)
BATCH = 6  # 16 train images: 2 steps; 16 val images: 6 + 6 + 4


def _opts(root):
    opts = []
    for k, v in TINY.items():
        if k not in ("DATA.BATCH_SIZE", "MODEL.NUM_CLASSES"):
            opts += [k, json.dumps(v) if not isinstance(v, str) else v]
    return opts + ["DATA.DATA_PATH", root, "DATA.BATCH_SIZE", str(BATCH)]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("folder_main")
    root = str(tmp / "imagenet")
    make_fake_imagenet(root)
    cfg = load_config(PORT_CFG, opts=_opts(root) + ["MODEL.NUM_CLASSES",
                                                    "3"])
    torch.save({"model": build_model(cfg, "cpu", seed=5).state_dict()},
               tmp / "ref.pth")
    received = []
    real = port_main.make_train_step

    def recording(config, state, schedule):
        step = real(config, state, schedule)

        def wrapped(images, labels):
            received.append((images.clone(), labels.clone()))
            return step(images, labels)
        return wrapped

    port_main.make_train_step = recording
    try:
        result = port_main.main([
            "--cfg", PORT_CFG, "--device", "cpu", "--epochs", "1",
            "--output", str(tmp / "out"), "--opts", *_opts(root),
            "MODEL.PRETRAINED", str(tmp / "ref.pth"),
            "DATA.NUM_WORKERS", "2"])
    finally:
        port_main.make_train_step = real
    return dict(root=root, tmp=tmp, result=result, received=received,
                cfg=cfg)


def test_num_classes_and_weights_come_from_the_folder_and_pth(trained):
    result = trained["result"]
    assert result["num_classes"] == 3
    loaded = result["weights"]["pretrained"]
    assert loaded["missing"] == [] and loaded["unexpected"] == []
    assert result["train"]["steps"] == 2
    # every JPEG natively, the PNG (sample 1 of each split) by Pillow: the
    # 2 x 6 train items, and the throughput's 6 and the validation's 16
    train, val = result["decoded"]["train"], result["decoded"]["val"]
    assert sum(train.values()) == 12 and train["native"] >= 11
    assert set(train) <= {"native", "pil"}
    assert val == {"native": 20, "pil": 2}


def test_first_train_batch_is_the_jax_loaders(trained):
    jax_cfg = jax_load_config(JAX_CFG, opts=_opts(trained["root"]) + [
        "DATA.NUM_WORKERS", "0"])
    ref_train, _, n = jax_data.build_loaders(jax_cfg)
    ref_train.set_epoch(0)
    want = next(iter(ref_train))
    images, labels = trained["received"][0]
    assert n == 3 and len(trained["received"]) == 2
    np.testing.assert_array_equal(images.numpy().transpose(0, 2, 3, 1),
                                  want["image"])
    np.testing.assert_array_equal(labels.numpy(), want["label"])


def test_validation_weights_the_short_batch_by_its_rows(trained):
    """The epoch's val loss and acc@1 equal those of the saved model over
    all 16 val images in one batch: a mean over images, not over the
    batches 6 + 6 + 4; ``--eval --resume`` of the checkpoint reproduces
    them."""
    train = trained["result"]["train"]
    model = build_model(trained["cfg"], "cpu")
    ckpt = torch.load(train["checkpoint"], weights_only=False)
    model.load_state_dict(ckpt["state"]["model"])
    val, _ = build_dataset(trained["cfg"], is_train=False)
    batch = next(iter(Loader(val, 16, shuffle=False, drop_last=False,
                             stride_shard=True)))
    out = trainer.make_eval_step(None, model)(batch["image"], batch["label"])
    assert out["count"].item() == 16
    assert train["val_loss"] == pytest.approx(out["loss_sum"].item() / 16,
                                              rel=1e-5)
    assert train["acc1"] == pytest.approx(100.0 * out["top1"].item() / 16)

    evaluated = port_main.main([
        "--cfg", PORT_CFG, "--device", "cpu", "--eval", "--resume",
        train["checkpoint"], "--output", str(trained["tmp"] / "eval"),
        "--opts", *_opts(trained["root"]), "DATA.NUM_WORKERS", "0"])
    assert evaluated["val_count"] == 16
    assert evaluated["loss"] == pytest.approx(train["val_loss"], rel=1e-6)
    assert evaluated["acc1"] == train["acc1"]
