"""torch.profiler trace hooks (counterpart of the JAX package's
``utils/profiling.py``).

Set ``PROFILE: /path/to/dir`` (or ``--profile DIR``) and the train steps
``[PROFILE_START, PROFILE_START + PROFILE_STEPS)`` of the run are traced:
CPU activity, and CUDA activity on the card, written as one Chrome trace
(``trace_<pid>.json``, viewable in Perfetto or TensorBoard).

The program marks its layers with :func:`span`, which records a
``torch.profiler.record_function`` range only while a profiler is
recording, so the spans share the trace's clock with the kernels they
launch:

* ``train_step`` (:data:`STEP_SPAN`), around each step of
  ``train/trainer.py::make_train_step``, holding ``train_step.forward``
  (targets, mixup, clearing the gradients, the model and its loss),
  ``train_step.backward`` (``loss.backward()``) and
  ``train_step.optimizer`` (the gradients' mean over ranks, norm, clip,
  AdamW, EMA, the loss's all-reduce);
* ``train_step.mix``, inside ``train_step.forward``, around
  ``train/losses.py::mixup_cutmix`` where the step mixes;
* ``optim.accumulate``, inside ``train_step.optimizer``, around the
  running mean of the micro-gradients in ``train/optim.py::
  Optimizer.step`` when it accumulates (every micro-step; the update
  itself follows on each ``accumulation_steps``-th);
* ``sync.grads_finite`` and ``sync.clip``, around the two reads of a
  device value that make the host wait for the device in every step: a
  sync span lasts as long as the host waits;
* ``geom.sfc``, ``geom.knn``, ``geom.tile_metadata``, ``geom.merge_select``,
  ``geom.split_select`` and ``geom.reorder``: the token geometry
  (clustering, neighbours, attention tiles, token selection and
  reordering);
* ``data.wait``, around ``main``'s fetch of the next batch.

Counters that need no profiler sit on the functions that do the work, as
function attributes: the kernels' launches
(``ops/cluster_attention.py::fused_cluster_attention.launches``, ...) and
the optimizer's list updates, ``train/optim.py::multi_tensor_update.steps``
(updates made) and ``.leaves`` (parameters they updated: every leaf of
the model, 258 for AFF-Mini and 458 for UD-Mini, in each update).
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["StepProfiler", "STEP_SPAN", "span"]

STEP_SPAN = "train_step"

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler records, else a
    shared null context: off, a span costs one flag read (an idle
    ``record_function`` costs about 13 us on the host)."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


class StepProfiler:
    """Captures a torch.profiler trace over a window of training steps.

    Call :meth:`step` once per train step with the global step index,
    before the step; the trace starts at ``start`` and stops after
    ``count`` steps. No-op when ``log_dir`` is empty. :meth:`stop` is
    idempotent and safe to call at teardown (e.g. when training ends
    inside the window). ``path`` is the trace file once written."""

    def __init__(self, log_dir: str, start: int = 10, count: int = 5):
        self.log_dir = log_dir
        self.start = start
        self.stop_at = start + count
        self.path: Optional[str] = None
        self._prof = None
        self._done = False

    def step(self, global_step: int) -> None:
        if not self.log_dir or self._done:
            return
        if self._prof is None and self.start <= global_step < self.stop_at:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
        elif self._prof is not None and global_step >= self.stop_at:
            self.stop()

    def stop(self) -> None:
        if self._prof is None:
            return
        if torch.cuda.is_available():
            torch.cuda.synchronize()  # the window's kernels end in it
        self._prof.__exit__(None, None, None)
        os.makedirs(self.log_dir, exist_ok=True)
        self.path = os.path.join(self.log_dir, f"trace_{os.getpid()}.json")
        self._prof.export_chrome_trace(self.path)
        self._prof = None
        self._done = True
