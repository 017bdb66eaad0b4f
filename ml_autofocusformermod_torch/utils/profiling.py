"""torch.profiler trace hooks (counterpart of the JAX package's
``utils/profiling.py``).

Set ``PROFILE: /path/to/dir`` (or ``--profile DIR``) and the train steps
``[PROFILE_START, PROFILE_START + PROFILE_STEPS)`` of the run are traced:
CPU activity, and CUDA activity on the card, written as one Chrome trace
(``trace_<pid>.json``, viewable in Perfetto or TensorBoard). The trainer
marks each step with a ``train_step`` span (:data:`STEP_SPAN`).
"""

from __future__ import annotations

import os
from typing import Optional

import torch

__all__ = ["StepProfiler", "STEP_SPAN"]

STEP_SPAN = "train_step"


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
