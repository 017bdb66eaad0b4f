"""The cell ``aff_base384.train.b16`` at a size the CPU holds.

``test_h100bench_control.py`` runs every cell on the CPU at its own image
size and a warm-up of 3 micro-steps. This cell's update takes 4, so that
warm-up never reaches the first update's gradient, and its full size
(75 M parameters at 384²) is slow there. Here the cell's configuration
file is cut to one block a stage, half its widths (heads of 32 channels,
as published) and a 128² image, in float32, and warmed up for one whole
update (its ``check_steps``); everything else is the file's: clusters of
24 in neighbourhoods of 144, layer scale, DropPath, mixup / cutmix, 4
micro-steps an update, the schedule and AdamW. Under the cell's own
limits the run comes out correct, and not correct with each fault that
``faults.planted`` gives the cell in the timed path; the float8 control
fails the limits.
"""

import json
from pathlib import Path

import pytest

from h100bench import calibrate, check, faults, loops, run

ROOT = Path(__file__).resolve().parents[2]
CELL = "aff_base384.train.b16"
SEED = 2 ** 31 + 99


def _cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    cfg = run.load_json(run.HERE / "configs" / f"{cell['config']}.json")
    traffic = run.load_json(run.HERE / "traffic" / f"{cell['traffic']}.json")
    limits = run.load_json(run.HERE / "limits" / f"{CELL}.json")
    return cfg, traffic, limits


def _small():
    cfg, traffic, limits = _cell()
    depths, widths, heads, img = [1] * 4, [64, 128, 256, 512], \
        [2, 4, 8, 16], 128
    cfg["img_size"] = img
    cfg["model"]["arch"].update(img_size=img, depths=depths,
                                embed_dim=widths, num_heads=heads)
    cfg["opts"].update({"DATA.IMG_SIZE": img, "MODEL.AFF.DEPTHS": depths,
                        "MODEL.AFF.EMBED_DIM": widths,
                        "MODEL.AFF.NUM_HEADS": heads,
                        "TPU.COMPUTE_DTYPE": "float32"})
    steps = int(traffic["check_steps"])
    traffic.update(batch=2, pool=3, warmup_steps=steps, trace_steps=1)
    return cfg, traffic, limits


def _verdict(fault=None):
    cfg, traffic, limits = _small()
    loop = loops.TrainLoop(cfg, traffic, SEED, "cpu", fault)
    loop.setup()
    loop.window(0.01)
    ok, rows = check.verdict(loop.check(), limits)
    return bool(ok and loop.failed == 0), rows


FAULTS = faults.planted(_cell()[0], "train")


def test_the_cell_turns_every_feature_fault_on():
    assert set(FAULTS) == {*faults.TRAINING, *faults.FEATURES}


@pytest.mark.parametrize("fault", [None, *FAULTS])
def test_faults_come_out_not_correct(fault):
    ok, rows = _verdict(FAULTS.get(fault))
    assert ok is (fault is None), rows


def test_control_fails_the_limits():
    cfg, traffic, limits = _small()
    loop = loops.TrainLoop(cfg, traffic, SEED, "cpu")
    ok, rows = check.verdict(calibrate.control_readings(loop), limits)
    assert not ok, rows
