"""``main`` under two CPU processes with torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``), gloo and a ``file://`` rendezvous. Every
run of the module goes through one pair of rank processes, one run after
another (``torch_parallel_worker``'s ``main`` mode), with the collectives
timed:

* it trains two steps (64 synthetic images, 16 per rank) with the learning
  rate scaled by the global batch of 32, and rank 0 alone writes the
  checkpoint, the log, ``config.json`` and the metrics log;
* ``--eval`` on two ranks (each iterating its strided shard of the
  validation split) gives the one-process validation sums: the same count
  and top-1 / top-5 counts, the mean loss within 1e-5 relative;
* tiny UD with tensor parallelism and tiny OT with ZeRO-1 train an epoch
  and validate;
* tiny AFF trains at ``TPU.MESH_SEQ`` 2 (both ranks hold the same images,
  each its half of every stage's tokens).
"""

import json
import os

import pytest

from ml_autofocusformermod_torch.config import load_config
from torch_parallel_worker import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "ml_autofocusformermod_torch", "configs",
                   "aff_mini.yaml")
TINY_OPTS = [
    "MODEL.AFF.DEPTHS", "[1, 1, 1, 1]",
    "MODEL.AFF.EMBED_DIM", "[16, 32, 48, 64]",
    "MODEL.AFF.NUM_HEADS", "[2, 2, 4, 4]",
    "MODEL.NUM_CLASSES", "10",
    "DATA.IMG_SIZE", "56",
    "TPU.COMPUTE_DTYPE", "float32",
    "TRAIN.USE_EMA", "True",
]
MR_TINY = {  # tests/test_maskfiner.py::tiny_mr
    "maskfiner_up_down_mini.yaml": 7, "maskfiner_oracle_teacher.yaml": 4}
MR_MESH = [("maskfiner_up_down_mini.yaml", ["TPU.MESH_MODEL", "2"]),
           ("maskfiner_oracle_teacher.yaml", ["TPU.ZERO1", "True"])]


def _argv(tmp, name, cfg, args, opts):
    return ["--cfg", cfg, "--device", "cpu",
            "--data-path", os.path.join(tmp, "no_dataset"), *args,
            "--dist-url", f"file://{os.path.join(tmp, name + '.rdv')}",
            "--opts", *opts]


def _mr_opts(preset, mesh):
    n = MR_TINY[preset]
    return ["MODEL.NUM_CLASSES", "10", "TPU.COMPUTE_DTYPE", "float32",
            "MODEL.MR.EMBED_DIM", str(([32, 24, 16, 8] + [16, 24, 32])[:n]),
            "MODEL.MR.DEPTHS", str([1] * n),
            "MODEL.MR.NUM_HEADS", str([2] * n),
            "MODEL.MR.MLP_RATIO", str([2.0] * n), "DATA.IMG_SIZE", "64",
            *mesh]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{name: [rank 0's run, rank 1's run]}`` of every run of ``main``;
    ``one`` ran on rank 0 alone."""
    tmp = str(tmp_path_factory.mktemp("parallel_main"))
    evals = ["--eval", "--batch-size", "12"]
    plan = {
        "train": _argv(tmp, "train", CFG, [
            "--batch-size", "16", "--epochs", "1",
            "--output", os.path.join(tmp, "out")], TINY_OPTS),
        "eval": _argv(tmp, "eval", CFG, evals, TINY_OPTS),
        "seq": _argv(tmp, "seq", CFG, [
            "--batch-size", "16", "--epochs", "1",
            "--output", os.path.join(tmp, "seq")],
            TINY_OPTS + ["TPU.MESH_SEQ", "2"]),
        **{preset: _argv(tmp, preset, os.path.join(os.path.dirname(CFG),
                                                   preset),
                         ["--batch-size", "16", "--epochs", "1",
                          "--output", os.path.join(tmp, preset)],
                         _mr_opts(preset, mesh)) for preset, mesh in MR_MESH},
    }
    main_runs = [{"argv": argv} for argv in plan.values()]
    main_runs.append({"argv": _argv(tmp, "one", CFG, evals, TINY_OPTS),
                      "world": 1})
    ranks = launch(os.path.join(tmp, "ranks"), 2, main_runs=main_runs,
                   timeout=600, env_extra={"MLAFF_COMM_TIMING": "1",
                                           "OMP_NUM_THREADS": "1"})
    out = {name: [r[i] for r in ranks] for i, name in enumerate(plan)}
    out["one"] = ranks[0][len(plan)]
    out["tmp"] = tmp
    return out


def test_main_trains_on_two_processes(runs):
    results = [r["result"] for r in runs["train"]]
    logs = [r["log"] for r in runs["train"]]
    for rank, r in enumerate(results):
        assert (r["rank"], r["world"], r["data"]) == (rank, 2, 2)
        assert r["train"]["steps"] == 2 and r["train"]["state_step"] == 2
        assert r["train"]["skipped_steps"] == 0
        assert r["throughput_img_s"] > 0
    # the logged loss is the global mean, the same on both ranks
    assert results[0]["train"]["train_loss"] == results[1]["train"][
        "train_loss"]
    assert results[0]["train"]["val_count"] == 64
    run_dir = os.path.dirname(results[0]["train"]["checkpoint"])
    assert run_dir.startswith(os.path.join(runs["tmp"], "out"))
    assert results[1]["train"]["checkpoint"] == results[0]["train"][
        "checkpoint"]
    base = load_config(CFG).TRAIN.BASE_LR
    with open(os.path.join(run_dir, "config.json")) as f:
        saved = json.load(f)
    assert saved["TRAIN"]["BASE_LR"] == pytest.approx(base * 32 / 512)
    files = sorted(os.listdir(run_dir))
    assert files == ["ckpt_epoch_0.pt", "config.json", "log_rank0.txt",
                     "metrics.jsonl"], files
    assert "mesh: data 2 x model 1 over 2 processes" in logs[0]
    # the gradients' bucket, BatchNorm's sums (and their gradient), the
    # clustering keys' maxima and the logged loss, timed: the same calls
    # on both ranks
    epochs = [r["train"]["epochs"][0] for r in results]
    assert epochs[0]["collective_calls"] == epochs[1]["collective_calls"]
    assert epochs[0]["collective_calls"] >= 4 * epochs[0]["steps"]
    assert all(e["collective_seconds"] > 0 for e in epochs)
    assert "throughput averaged" not in logs[1]  # rank 0 prints


def test_eval_on_two_processes_gives_one_process_sums(runs):
    one = runs["one"]["result"]
    for r in runs["eval"]:
        r = r["result"]
        assert r["val_count"] == one["val_count"] == 64
        assert r["acc1"] == pytest.approx(one["acc1"], abs=1e-9)
        assert r["acc5"] == pytest.approx(one["acc5"], abs=1e-9)
        assert r["loss"] == pytest.approx(one["loss"], rel=1e-5)


@pytest.mark.parametrize("preset,mesh", MR_MESH)
def test_main_trains_maskfiner_on_two_processes(runs, preset, mesh):
    """Tiny UD with tensor parallelism and tiny OT with ZeRO-1 train an
    epoch and validate through ``main`` on two processes."""
    results = [r["result"] for r in runs[preset]]
    for r in results:
        train = r["train"]
        # model 2 leaves one data rank, which loads all 64 images
        assert train["steps"] == (4 if "TPU.MESH_MODEL" in mesh else 2)
        assert train["skipped_steps"] == 0
        assert 1.0 < train["train_loss"] < 5.0
        assert train["val_count"] == 64
    assert results[0]["train"]["train_loss"] == results[1]["train"][
        "train_loss"]


def test_main_trains_at_seq_2(runs):
    """At ``TPU.MESH_SEQ`` 2 the two ranks are one data rank: each loads
    all 64 images (4 steps of 16), the learning rate is scaled by 16, and
    the two ranks log the same loss."""
    results = [r["result"] for r in runs["seq"]]
    assert "mesh: data 1 x model 1 x seq 2 over 2 processes" in \
        runs["seq"][0]["log"]
    for r in results:
        assert (r["world"], r["data"], r["seq"]) == (2, 1, 2)
        train = r["train"]
        assert train["steps"] == 4 and train["skipped_steps"] == 0
        assert train["val_count"] == 64
        assert train["epochs"][0]["collective_calls"] > 0
    assert results[0]["train"]["train_loss"] == results[1]["train"][
        "train_loss"]
