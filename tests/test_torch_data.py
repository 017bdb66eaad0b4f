"""The port's data feed against the JAX package's, on the CPU, on an
ImageFolder fabricated as ``tests/test_data_ckpt.py::make_fake_imagenet``
does (plus a grayscale JPEG, a PNG and a few photo-sized JPEGs per split):

* the sample list and class ids;
* ``TrainTransform`` / ``EvalTransform`` items for several (seed, epoch,
  idx) keys, on the Pillow path (the same code on the same Pillow) and on
  the native path (the same C++ code): equal bytes;
* ``Loader`` batches: the per-epoch shuffle, two hosts, ``drop_last``, the
  strided and padded validation split with ``valid``, the float16
  transport, and worker processes against none;
* the synthetic fallback and ``build_loaders``' class count.

The port's batches are NCHW torch tensors where JAX's are NHWC numpy.
"""

import os
import random

import numpy as np
import pytest
import torch
from PIL import Image

from ml_autofocusformermod_torch.config import load_config
from ml_autofocusformermod_torch.data import imagenet as port_data
from ml_autofocusformermod_torch.data import transforms as port_tf
from ml_autofocusformermod_tpu.config import load_config as jax_load_config
from ml_autofocusformermod_tpu.data import imagenet as jax_data
from ml_autofocusformermod_tpu.data import transforms as jax_tf

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CFG = os.path.join(ROOT, "ml_autofocusformermod_torch", "configs",
                        "aff_mini.yaml")
JAX_CFG = os.path.join(ROOT, "ml_autofocusformermod_tpu", "configs",
                       "aff_mini.yaml")
KEYS = [(0, 0, 0), (0, 0, 5), (0, 1, 5), (3, 2, 11), (7, 0, 14)]


def make_fake_imagenet(root, n_classes=3, n_per_class=4, size=64):
    """``tests/test_data_ckpt.py:19``'s folder, plus per split a grayscale
    JPEG, a PNG and two photo-sized JPEGs in class_0."""
    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        for c in range(n_classes):
            d = os.path.join(root, split, f"class_{c}")
            os.makedirs(d, exist_ok=True)
            for i in range(n_per_class):
                arr = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
                Image.fromarray(arr).save(os.path.join(d, f"img_{i}.jpg"))
        d = os.path.join(root, split, "class_0")
        gray = rng.integers(0, 255, (48, 80), dtype=np.uint8)
        Image.fromarray(gray).save(os.path.join(d, "gray.jpg"), quality=90)
        png = rng.integers(0, 255, (70, 50, 3), dtype=np.uint8)
        Image.fromarray(png).save(os.path.join(d, "img.png"))
        for w, h in ((150, 112), (112, 150)):
            x = np.linspace(0, 9, w)[None, :, None]
            y = np.linspace(0, 6, h)[:, None, None]
            arr = (np.sin(x + y * np.array([1.0, 0.5, 2.0])) * 100 + 128
                   + rng.uniform(0, 20, (h, w, 3)))
            Image.fromarray(arr.astype(np.uint8)).save(
                os.path.join(d, f"photo_{w}x{h}.jpg"), quality=90)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("imagenet"))
    make_fake_imagenet(root)
    return root


def _configs(root, **extra):
    opts = ["DATA.DATA_PATH", root, "DATA.IMG_SIZE", "32",
            "DATA.BATCH_SIZE", "4", "DATA.NUM_WORKERS", "0"]
    for k, v in extra.items():
        opts += [k, str(v)]
    return load_config(PORT_CFG, opts=opts), jax_load_config(JAX_CFG,
                                                             opts=opts)


def _nhwc(batch):
    return batch["image"].numpy().transpose(0, 2, 3, 1)


def test_sample_list_and_class_ids_match_jax(folder):
    port_cfg, jax_cfg = _configs(folder)
    for split, is_train in (("train", True), ("val", False)):
        port, n = port_data.build_dataset(port_cfg, is_train)
        ref, n_ref = jax_data.build_dataset(jax_cfg, is_train)
        assert isinstance(port, port_data.ImageFolderDataset)
        assert n == n_ref == 3
        assert port.samples == ref.samples and len(port) == 16
        assert port.class_to_idx == ref.class_to_idx


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
def test_pil_path_items_match_jax(folder, is_train):
    """The Pillow path (every file, JPEG or not), key by key: the same
    bytes, and the same rng state after the item."""
    port_cfg, jax_cfg = _configs(folder)
    port, _ = port_data.build_dataset(port_cfg, is_train)
    ref, _ = jax_data.build_dataset(jax_cfg, is_train)
    assert (type(port.transform).__name__
            == ("TrainTransform" if is_train else "EvalTransform"))
    port.native = False
    for seed, epoch, idx in KEYS:
        port.seed, port.epoch = seed, epoch
        arr, label, decoder = port.load(idx)
        path, want_label = ref.samples[idx]
        key = hash((seed, epoch, idx))
        r_port, r_ref = random.Random(key), random.Random(key)
        with Image.open(path) as img:
            want = ref.transform(img, r_ref)
        with Image.open(path) as img:
            again = port.transform(img, r_port)
        assert decoder == "pil" and label == want_label
        np.testing.assert_array_equal(arr, want.astype(np.float32))
        np.testing.assert_array_equal(again, want)
        assert r_port.getstate() == r_ref.getstate()


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
def test_native_path_items_match_jax(folder, is_train):
    """Through each package's dataset (the native library for the JPEGs,
    Pillow for the PNG): the same bytes for every item and key."""
    port_cfg, jax_cfg = _configs(folder)
    port, _ = port_data.build_dataset(port_cfg, is_train)
    ref, _ = jax_data.build_dataset(jax_cfg, is_train)
    assert port.native
    decoders = []
    for seed, epoch in ((0, 0), (5, 3)):
        port.seed, port.epoch, ref.seed, ref.epoch = seed, epoch, seed, epoch
        for idx in range(len(port)):
            arr, label, decoder = port.load(idx)
            want, want_label = ref[idx]
            np.testing.assert_array_equal(arr, want)
            assert label == want_label
            decoders.append((os.path.basename(port.samples[idx][0]), decoder))
    assert {d for n, d in decoders if n.endswith(".png")} == {"pil"}
    assert {d for n, d in decoders if n.endswith(".jpg")} == {"native"}


def test_train_loader_matches_jax_per_epoch_and_host(folder):
    """Shuffled per epoch, two hosts, drop_last: the port's batches are the
    JAX loader's, transposed to NCHW, with int64 labels."""
    port_cfg, jax_cfg = _configs(folder)
    port_ds, _ = port_data.build_dataset(port_cfg, True)
    ref_ds, _ = jax_data.build_dataset(jax_cfg, True)
    for host in (0, 1):
        port = port_data.Loader(port_ds, 3, shuffle=True, host=host,
                                num_hosts=2, seed=4)
        ref = jax_data.Loader(ref_ds, 3, shuffle=True, host=host,
                              num_hosts=2, seed=4)
        assert len(port) == len(ref) == 2  # 8 per host, drop_last
        firsts = []
        for epoch in (0, 1):
            port.set_epoch(epoch)
            ref.set_epoch(epoch)
            got, want = list(port), list(ref)
            assert len(got) == len(want) == 2
            for g, w in zip(got, want):
                assert set(g) == {"image", "label"}
                assert g["image"].shape == (3, 3, 32, 32)
                assert g["image"].dtype == torch.float32
                assert g["label"].dtype == torch.int64
                np.testing.assert_array_equal(_nhwc(g), w["image"])
                np.testing.assert_array_equal(g["label"].numpy(), w["label"])
            firsts.append(got[0]["image"])
        # a fresh shuffle and fresh augmentations each epoch
        assert not torch.equal(firsts[0], firsts[1])
        assert sum(port.decode_counts.values()) == 12


def test_val_loader_padded_split_matches_jax(folder):
    """The strided validation split over 3 hosts (16 items: 6 / 5 / 5 with
    a ``-1`` pad), batch 4: equal batch counts on every host, the pad row
    flagged in ``valid``, and the same bytes as JAX's."""
    port_cfg, jax_cfg = _configs(folder)
    port_ds, _ = port_data.build_dataset(port_cfg, False)
    ref_ds, _ = jax_data.build_dataset(jax_cfg, False)
    n_valid = 0
    for host in range(3):
        port = port_data.Loader(port_ds, 4, shuffle=False, host=host,
                                num_hosts=3, drop_last=False,
                                stride_shard=True)
        ref = jax_data.Loader(ref_ds, 4, shuffle=False, host=host,
                              num_hosts=3, drop_last=False, stride_shard=True)
        got, want = list(port), list(ref)
        assert len(got) == len(want) == len(port) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_nhwc(g), w["image"])
            np.testing.assert_array_equal(g["label"].numpy(), w["label"])
            assert ("valid" in g) == ("valid" in w)
            if "valid" in w:
                np.testing.assert_array_equal(g["valid"].numpy(), w["valid"])
            n_valid += int(g.get("valid", torch.ones(len(g["label"]),
                                                     dtype=torch.bool)).sum())
        if host > 0:
            assert not bool(got[-1]["valid"][-1])
    assert n_valid == 16


def test_float16_transport_and_workers_match(folder):
    """``DATA.TRANSPORT_DTYPE`` float16: the JAX loader's bytes, cast in
    the worker; two worker processes give the batches of none,
    byte for byte, and count the decoders the same."""
    port_cfg, jax_cfg = _configs(folder)
    port_ds, _ = port_data.build_dataset(port_cfg, True)
    ref_ds, _ = jax_data.build_dataset(jax_cfg, True)
    kw = dict(shuffle=True, seed=2, transport_dtype="float16")
    serial = port_data.Loader(port_ds, 5, **kw)
    workers = port_data.Loader(port_ds, 5, num_workers=2, **kw)
    ref = jax_data.Loader(ref_ds, 5, **kw)
    for loader in (serial, workers, ref):
        loader.set_epoch(1)
    got, par, want = list(serial), list(workers), list(ref)
    assert len(got) == len(par) == len(want) == 3
    for g, p, w in zip(got, par, want):
        assert g["image"].dtype == torch.float16
        np.testing.assert_array_equal(_nhwc(g), w["image"])
        assert torch.equal(g["image"], p["image"])
        assert torch.equal(g["label"], p["label"])
    assert serial.decode_counts == workers.decode_counts
    assert serial.decode_counts["native"] + serial.decode_counts["pil"] == 15


def test_synthetic_fallback_matches_jax(tmp_path):
    """No ``<path>/<split>``: the synthetic set of JAX, item by item, its
    length and class count from the config."""
    port_cfg, jax_cfg = _configs(str(tmp_path / "absent"),
                                 **{"MODEL.NUM_CLASSES": 7})
    for is_train in (True, False):
        port, n = port_data.build_dataset(port_cfg, is_train)
        ref, n_ref = jax_data.build_dataset(jax_cfg, is_train)
        assert isinstance(port, port_data.SyntheticDataset)
        assert n == n_ref == 7 and len(port) == len(ref) == 64
        for idx in (0, 9, 63):
            arr, label = port[idx]
            want, want_label = ref[idx]
            np.testing.assert_array_equal(arr, want)
            assert label == want_label
    train, val, n = port_data.build_loaders(port_cfg)
    assert n == 7 and train.num_workers == val.num_workers == 0
    batch = next(iter(val))
    ref_batch = next(iter(jax_data.build_loaders(jax_cfg)[1]))
    np.testing.assert_array_equal(_nhwc(batch), ref_batch["image"])
    assert dict(val.decode_counts) == {"synthetic": 4}


def test_build_loaders_take_the_class_count_from_the_folder(folder):
    port_cfg, jax_cfg = _configs(folder, **{"MODEL.NUM_CLASSES": 1000,
                                            "DATA.NUM_WORKERS": 3})
    train, val, n = port_data.build_loaders(port_cfg)
    ref_train, ref_val, n_ref = jax_data.build_loaders(jax_cfg)
    assert n == n_ref == 3
    assert train.num_workers == ref_train.num_workers == min(3, os.cpu_count())
    assert len(train) == len(ref_train) == 4
    assert len(val) == len(ref_val) == 4
    assert val.drop_last is False and val.stride_shard


def test_rand_augment_plans_and_pil_ops_match_jax():
    """``parse_rand_augment`` and ``RandAugment.plan`` draw JAX's ops and
    parameters from the same rng; the Pillow executor gives JAX's bytes
    for every op."""
    spec = "rand-m9-mstd0.5-inc1"
    port_ra = port_tf.parse_rand_augment(spec)
    ref_ra = jax_tf.parse_rand_augment(spec)
    names = set()
    for seed in range(200):
        plan = port_ra.plan(random.Random(seed), (32, 24))
        assert plan == ref_ra.plan(random.Random(seed), (32, 24))
        names.update(n for n, _ in plan)
    assert names == set(port_tf.RA_OP_IDS)
    rng = np.random.default_rng(1)
    img = Image.fromarray(rng.integers(0, 255, (24, 32, 3), dtype=np.uint8))
    params = {"rotate": 17.3, "posterize_inc": 2, "solarize_inc": 120,
              "solarize_add": 70, "shear_x": 0.22, "shear_y": -0.1,
              "translate_x": 7.5, "translate_y": -5.25}
    for name in port_tf.RA_OP_IDS:
        for p in ((0.4, 1.7) if name not in params else (params[name],)):
            got = port_tf.RandAugment.apply_plan_pil(img, [(name, p)])
            want = jax_tf.RandAugment.apply_plan_pil(img, [(name, p)])
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


_WORKER_PASSES = '''
from ml_autofocusformermod_torch.data import imagenet

if __name__ == "__main__":
    ds = imagenet.SyntheticDataset(16, 3, length=8)
    loader = imagenet.Loader(ds, 4, shuffle=True, num_workers=2)
    for _ in range(2):  # the second pass starts the server anew
        assert len(list(loader)) == 2
        imagenet.stop_worker_server()
    print("passes done", flush=True)
'''


def _session_members(sid):
    out = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                if os.getsid(int(d)) == sid:
                    out.append(int(d))
            except OSError:
                continue  # it has just exited
    return out


@pytest.mark.skipif(not os.path.isdir("/proc"), reason="needs /proc")
def test_stop_worker_server_leaves_no_process(tmp_path):
    """Loader passes with workers, each followed by ``stop_worker_server``,
    in a process of a new session: when that process exits, nothing of
    the session is left (without the call the worker server outlives it)."""
    import subprocess
    import sys

    script = tmp_path / "passes.py"
    script.write_text(_WORKER_PASSES)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(script)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    out, err = proc.communicate(timeout=240)
    left = _session_members(proc.pid)
    assert proc.returncode == 0, err[-2000:]
    assert "passes done" in out
    assert left == []
