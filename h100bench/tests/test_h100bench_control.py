"""The check that decides ``correct`` fails what it must.

* The control: the plain reference with every product's operands rounded
  to float8 e4m3, in the program's place, fails each cell's limits: on the
  CPU at a size a test run holds, and (``cuda``) on the card at the
  cell's own size over three seeds.
* The faults: a run driven through the harness (its look for a card
  skipped: on the CPU, the program in float32 at a small batch) comes out
  correct, and not correct with the timed path broken underneath: a
  training step that leaves the state unchanged; a step over half of the
  batch, its mean taken over the rest; an answer altered where the
  forward produces it. The cells run on one card, so there is no exchange
  between cards to leave out.
"""

import json
import time
from pathlib import Path

import pytest
import torch

from h100bench import calibrate, check, faults, loops, run

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"train": {"batch": 2, "pool": 3, "warmup_steps": 3,
                   "trace_steps": 1},
         "infer_batch": {"batch": 2, "pool": 2, "warmup_calls": 2,
                         "check_calls": 2, "trace_steps": 1},
         "infer_request": {"pool": 2, "warmup_calls": 2, "trace_steps": 2}}
FP32 = {"TPU.COMPUTE_DTYPE": "float32"}


def _cell(name):
    cell = next(w for w in BENCH["workloads"] if w["name"] == name)
    cfg = run.load_json(run.HERE / "configs" / f"{cell['config']}.json")
    traffic = run.load_json(run.HERE / "traffic" / f"{cell['traffic']}.json")
    limits = run.load_json(run.HERE / "limits" / f"{name}.json")
    return cfg, traffic, limits


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits_on_the_cpu(name):
    cfg, traffic, limits = _cell(name)
    traffic.update(SMALL[traffic["kind"]])
    loop = loops.KINDS[traffic["kind"]](cfg, traffic, 2 ** 31 + 7, "cpu")
    ok, rows = check.verdict(calibrate.control_readings(loop), limits)
    assert not ok, rows


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits_on_card(cuda_device, name):
    cfg, traffic, limits = _cell(name)
    for seed in (11, 2 ** 31 + 12, 3 ** 20):
        loop = loops.KINDS[traffic["kind"]](cfg, traffic, seed, cuda_device)
        ok, rows = check.verdict(calibrate.control_readings(loop), limits)
        assert not ok, (seed, rows)


def _run(name, mutate=None):
    kind = _cell(name)[1]["kind"]
    return run.run_cell(BENCH, name, 2 ** 31 + 99, 0.5, False,
                        device="cpu", start=time.perf_counter(),
                        mutate=mutate, traffic_sizes=SMALL[kind], opts=FP32)


TRAIN = [c for c in CELLS if ".train." in c]
INFER = [c for c in CELLS if ".infer." in c]


@pytest.mark.parametrize("name", TRAIN)
@pytest.mark.parametrize("fault", [None, *faults.TRAINING.values()])
def test_training_faults_come_out_not_correct(name, fault):
    res = _run(name, fault)
    assert res["correct"] is (fault is None), res["compared"]


@pytest.mark.parametrize("name", INFER)
@pytest.mark.parametrize("fault", [None, *faults.SERVING.values()])
def test_serving_faults_come_out_not_correct(name, fault):
    res = _run(name, fault)
    assert res["correct"] is (fault is None), res["compared"]
    assert res["attempted"] >= 1


def test_traced_run_reports_its_metrics_and_check():
    res = run.run_cell(BENCH, "aff_mini.infer.b1", 5, 0.5, True,
                       device="cpu", start=time.perf_counter(),
                       traffic_sizes=SMALL["infer_request"], opts=FP32)
    assert res["correct"]
    assert res["device"]["window_s"] > 0
    assert "mfu.latency" in res["metrics"]
    # no kernel runs on the CPU: the roofline readers return nothing
    assert "attn_roofline.infer" not in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert torch.get_num_threads() >= 1
