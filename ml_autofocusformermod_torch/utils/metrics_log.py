"""Experiment metric logging: a local JSONL file always, wandb when it is
importable (a copy of the JAX package's ``utils/metrics_log.py``).

The reference logs train/val metrics to wandb from rank 0
(``main.py:78-82,180-185,301-304``). Every metric also lands in
``metrics.jsonl`` next to the checkpoints, so runs can be read without
external services.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

__all__ = ["MetricsLogger"]


class MetricsLogger:
    def __init__(self, output_dir: str, project: str = "", name: str = "",
                 config: Optional[Dict] = None, enabled: bool = True):
        self.enabled = enabled
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._wandb = None
        if enabled:
            os.makedirs(output_dir, exist_ok=True)
            try:
                import wandb  # optional

                self._wandb = wandb
                wandb.init(project=project or "aff-torch", name=name or None,
                           config=config or {})
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        if not self.enabled:
            return
        record = {"time": time.time(), "step": step, **metrics}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def finish(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
