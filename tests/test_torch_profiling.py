"""``utils/profiling.py::StepProfiler`` and ``main --profile``, on the
CPU (torch.profiler's CPU activity).

* the window: steps ``[start, start + count)`` are traced, and the trace
  holds exactly ``count`` step spans;
* ``stop`` is idempotent, and an empty directory makes the profiler a
  no-op;
* ``main --profile DIR`` on a tiny training run writes the trace.
"""

import json
import os

import torch

from ml_autofocusformermod_torch import main as port_main
from ml_autofocusformermod_torch.utils.profiling import STEP_SPAN, StepProfiler
from test_torch_entry import PORT_CFG, TINY_OPTS

torch.set_num_threads(1)


def _spans(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("name") == STEP_SPAN
            and e.get("ph") == "X" and e.get("cat") == "user_annotation"]


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
    assert len(_spans(path)) == 2
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "mlaff::cluster_attention_fwd" in names
