"""``utils/profiling.py`` (``StepProfiler``, ``span``) and ``main
--profile``, on the CPU (torch.profiler's CPU activity).

* the window: steps ``[start, start + count)`` are traced, and the trace
  holds exactly ``count`` step spans;
* ``stop`` is idempotent, and an empty directory makes the profiler a
  no-op;
* ``main --profile DIR`` on a tiny training run writes the trace, one
  ``train_step`` span per step, each after its ``data.wait``;
* a tiny AFF and a tiny UD train step: one ``train_step`` span holding
  ``.forward``, ``.backward`` and ``.optimizer`` in that order, the
  ``geom.*`` spans inside the forward, and the ``sync.*`` spans (two with
  ``TRAIN.CLIP_GRAD`` above 0, one at 0) inside the optimizer;
* with no profiler running, a step calls no ``record_function``.
"""

import json
import os

import pytest
import torch

from ml_autofocusformermod_torch import main as port_main
from ml_autofocusformermod_torch.config import load_config
from ml_autofocusformermod_torch.models.build import build_model
from ml_autofocusformermod_torch.train.trainer import (create_train_state,
                                                       make_train_step)
from ml_autofocusformermod_torch.utils.profiling import STEP_SPAN, StepProfiler
from test_torch_entry import PORT_CFG, TINY_OPTS

torch.set_num_threads(1)

TINY_UD_OPTS = [
    "MODEL.MR.EMBED_DIM", "[32, 24, 16, 8, 16, 24, 32]",
    "MODEL.MR.DEPTHS", "[1, 1, 1, 1, 1, 1, 1]",
    "MODEL.MR.NUM_HEADS", "[2, 2, 2, 2, 2, 2, 2]",
    "MODEL.MR.MLP_RATIO", "[2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0]",
    "MODEL.NUM_CLASSES", "10",
    "DATA.IMG_SIZE", "64",
    "TPU.COMPUTE_DTYPE", "float32",
]
MODELS = {
    "aff": ("aff_mini.yaml", TINY_OPTS + ["DATA.IMG_SIZE", "56"],
            {"geom.sfc", "geom.knn", "geom.tile_metadata",
             "geom.merge_select"}),
    "ud": ("maskfiner_up_down_mini.yaml", TINY_UD_OPTS,
           {"geom.sfc", "geom.knn", "geom.tile_metadata",
            "geom.split_select", "geom.reorder"}),
}
PHASES = [STEP_SPAN + ".forward", STEP_SPAN + ".backward",
          STEP_SPAN + ".optimizer"]


def _events(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") == "user_annotation"]


def _spans(path, name=STEP_SPAN):
    return [e for e in _events(path) if e["name"] == name]


def _within(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def _tiny_step(model_name, clip):
    preset, opts, _ = MODELS[model_name]
    config = load_config(os.path.join(PORT_CFG, preset),
                         opts=opts + ["TRAIN.CLIP_GRAD", str(clip)])
    model = build_model(config, "cpu")
    state, schedule = create_train_state(config, model, 4)
    size = config.DATA.IMG_SIZE
    x = torch.randn(2, 3, size, size,
                    generator=torch.Generator().manual_seed(0))
    y = torch.tensor([1, 2])
    step = make_train_step(config, state, schedule)
    return lambda: step(x, y)


def _run_steps(prof, steps):
    x = torch.ones(8, 8)
    for i in range(steps):
        prof.step(i)
        with torch.profiler.record_function(STEP_SPAN):
            (x @ x).sum()


def test_window_holds_exactly_count_steps(tmp_path):
    prof = StepProfiler(str(tmp_path / "trace"), start=2, count=3)
    _run_steps(prof, 8)
    assert prof.path is not None and os.path.isfile(prof.path)
    assert len(_spans(prof.path)) == 3
    prof.stop()  # idempotent: nothing more happens
    prof.step(3)
    assert len(os.listdir(tmp_path / "trace")) == 1


def test_stop_inside_the_window_writes_the_trace(tmp_path):
    prof = StepProfiler(str(tmp_path), start=1, count=5)
    _run_steps(prof, 3)  # training ends inside the window
    assert prof.path is None
    prof.stop()
    prof.stop()
    assert len(_spans(prof.path)) == 2


def test_empty_dir_is_a_no_op(tmp_path):
    prof = StepProfiler("", start=0, count=2)
    _run_steps(prof, 4)
    prof.stop()
    assert prof.path is None and prof._prof is None


def test_main_profile_writes_the_trace(tmp_path):
    result = port_main.main([
        "--cfg", os.path.join(PORT_CFG, "aff_mini.yaml"), "--device", "cpu",
        "--batch-size", "4", "--epochs", "1",
        "--data-path", str(tmp_path / "no_dataset"),
        "--output", str(tmp_path / "out"),
        "--profile", str(tmp_path / "prof"),
        "--opts", *TINY_OPTS, "PROFILE_START", "1", "PROFILE_STEPS", "2",
        "DATA.NUM_WORKERS", "0", "DATA.IMG_SIZE", "56"])
    path = result["train"]["profile"]
    assert path is not None and path.startswith(str(tmp_path / "prof"))
    steps, waits = _spans(path), _spans(path, "data.wait")
    assert len(steps) == 2 and len(waits) == 2
    for wait, step in zip(waits, steps):
        assert wait["ts"] + wait["dur"] <= step["ts"]
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "mlaff::cluster_attention_fwd" in names


@pytest.mark.parametrize("model_name, clip", [("aff", 5.0), ("ud", 5.0),
                                              ("aff", 0.0)])
def test_step_spans_nest_in_order(tmp_path, model_name, clip):
    run = _tiny_step(model_name, clip)
    run()  # fills the constant tile metadata's cache
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    spans = _events(path)
    (step,) = [e for e in spans if e["name"] == STEP_SPAN]
    phases = [e for e in spans if e["name"] in PHASES]
    assert [e["name"] for e in sorted(phases, key=lambda e: e["ts"])] \
        == PHASES
    phases.sort(key=lambda e: e["ts"])
    for a, b in zip(phases, phases[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    assert all(_within(e, step) for e in phases)
    forward, _, optimizer = phases
    geom = [e for e in spans if e["name"].startswith("geom.")]
    assert {e["name"] for e in geom} == MODELS[model_name][2]
    assert all(_within(e, forward) for e in geom)
    syncs = [e for e in spans if e["name"].startswith("sync.")]
    want = ["sync.grads_finite", "sync.clip"] if clip > 0 \
        else ["sync.grads_finite"]
    assert [e["name"] for e in sorted(syncs, key=lambda e: e["ts"])] == want
    assert all(_within(e, optimizer) for e in syncs)


def test_no_record_function_without_a_profiler(monkeypatch):
    run = _tiny_step("aff", 5.0)

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    run()
