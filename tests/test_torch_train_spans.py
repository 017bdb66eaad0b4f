"""The spans of the training features AFF-Base-384's preset turns on, on
the CPU (torch.profiler's CPU activity):

* a tiny AFF with mixup / cutmix, DropPath and accumulation over 2
  micro-steps, 4 micro-steps profiled: 4 ``train_step.mix`` spans, each
  inside its ``train_step.forward``, and 4 ``optim.accumulate`` spans,
  each inside its ``train_step.optimizer``; ``sync.clip`` once per update;
* ``multi_tensor_update.steps`` counts one update per 2 micro-steps;
* with no profiler running, the same steps call no ``record_function``.
"""

import json
import os

import torch

from ml_autofocusformermod_torch.config import load_config
from ml_autofocusformermod_torch.models.build import build_model
from ml_autofocusformermod_torch.train.optim import multi_tensor_update
from ml_autofocusformermod_torch.train.trainer import (create_train_state,
                                                       make_train_step)
from ml_autofocusformermod_torch.utils.profiling import STEP_SPAN
from test_torch_entry import PORT_CFG, TINY_OPTS

torch.set_num_threads(1)

STEPS, ACCUM = 4, 2
FEATURE_OPTS = ["AUG.MIXUP", "0.8", "AUG.CUTMIX", "1.0",
                "MODEL.DROP_PATH_RATE", "0.2", "MODEL.AFF.LAYER_SCALE",
                "1e-5", "TRAIN.ACCUMULATION_STEPS", str(ACCUM),
                "DATA.IMG_SIZE", "56"]


def _steps():
    config = load_config(os.path.join(PORT_CFG, "aff_mini.yaml"),
                         opts=TINY_OPTS + FEATURE_OPTS)
    model = build_model(config, "cpu")
    state, schedule = create_train_state(config, model, 8, seed=3)
    step = make_train_step(config, state, schedule)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 56, 56, generator=gen)
    y = torch.tensor([1, 2])
    return model, lambda: [step(x, y) for _ in range(STEPS)]


def _within(inner, outer):
    return (outer["ts"] <= inner["ts"]
            and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"])


def test_mix_and_accumulate_spans(tmp_path):
    _, run = _steps()
    before = multi_tensor_update.steps
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        outs = run()
    updates = multi_tensor_update.steps - before
    assert all(bool(o["grads_finite"]) for o in outs)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        spans = [e for e in json.load(f)["traceEvents"]
                 if e.get("ph") == "X" and e.get("cat") == "user_annotation"]

    def named(name):
        return sorted((e for e in spans if e["name"] == name),
                      key=lambda e: e["ts"])

    forward, optimizer = (named(STEP_SPAN + ".forward"),
                          named(STEP_SPAN + ".optimizer"))
    mix, acc = named(STEP_SPAN + ".mix"), named("optim.accumulate")
    assert len(forward) == len(optimizer) == STEPS
    assert len(mix) == len(acc) == STEPS
    assert all(_within(m, f) for m, f in zip(mix, forward))
    assert all(_within(a, o) for a, o in zip(acc, optimizer))
    assert len(named("sync.clip")) == updates == STEPS // ACCUM


def test_no_record_function_without_a_profiler_when_accumulating(
        monkeypatch):
    _, run = _steps()

    def refuse(name):
        raise AssertionError(f"record_function({name!r}) without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    run()
