"""Checkpoint save / load / auto-resume with ``torch.save`` (counterpart of
the JAX package's ``ckpt/orbax_io.py``).

Same semantics: ``ckpt_epoch_<e>.pt`` under the output directory, the
newest one always kept and multiples of ``keep_every`` (``SAVE_FREQ``)
retained; auto-resume takes the newest checkpoint by mtime; a checkpoint
holds ``(state, epoch, max_accuracy, rng state)``. ``state`` is the model's
``state_dict`` (parameters and BatchNorm buffers), the optimizer's state,
the EMA copy and the step count; the rng state is that of the train
state's three generators. Saves are synchronous and atomic (a temporary file
renamed into place), so auto-resume never sees a partial checkpoint.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "load_model_weights",
           "auto_resume_helper"]

_CKPT_RE = re.compile(r"ckpt_epoch_(\d+)\.pt$")


def _payload(state, epoch: int, max_accuracy: float) -> dict:
    return {
        "state": {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "ema": state.ema,
            "step": state.step,
        },
        "epoch": epoch,
        "max_accuracy": max_accuracy,
        "rng": {"drop": state.drop_generator.get_state(),
                "mix": state.mix_generator.get_state(),
                "upsample": state.upsample_generator.get_state()},
    }


def save_checkpoint(output_dir: str, epoch: int, state, max_accuracy: float,
                    keep_every: int = 5) -> str:
    """Write ``ckpt_epoch_<epoch>.pt`` and prune older checkpoints that are
    neither the newest nor a multiple of ``keep_every``."""
    os.makedirs(output_dir, exist_ok=True)
    committed = {}
    for name in os.listdir(output_dir):
        m = _CKPT_RE.match(name)
        if m:
            committed[int(m.group(1))] = name
    newest = max(committed, default=None)
    for e, name in committed.items():
        if e != newest and e != epoch and (keep_every <= 0
                                           or e % keep_every != 0):
            os.remove(os.path.join(output_dir, name))
    path = os.path.join(os.path.abspath(output_dir), f"ckpt_epoch_{epoch}.pt")
    tmp = f"{path}.tmp"
    torch.save(_payload(state, epoch, max_accuracy), tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, state) -> Tuple[object, int, float]:
    """Restore ``state`` in place from ``path``; returns ``(state, epoch,
    max_accuracy)``. The generators' states are restored too."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=False)
    saved = ckpt["state"]
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    if state.ema is not None and saved["ema"] is not None:
        for k, t in saved["ema"].items():
            state.ema[k].copy_(t)
    state.step = int(saved["step"])
    state.drop_generator.set_state(ckpt["rng"]["drop"].cpu())
    state.mix_generator.set_state(ckpt["rng"]["mix"].cpu())
    if "upsample" in ckpt["rng"]:  # written before MaskFiner training
        state.upsample_generator.set_state(ckpt["rng"]["upsample"].cpu())
    return state, int(ckpt["epoch"]), float(ckpt["max_accuracy"])


def load_model_weights(path: str, model) -> int:
    """Load only the model's ``state_dict`` (parameters and BatchNorm
    buffers) of the checkpoint at ``path`` into ``model`` (strict); returns
    the checkpoint's epoch. For evaluation and throughput, where no train
    state exists."""
    device = next(model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=False)
    model.load_state_dict(ckpt["state"]["model"])
    return int(ckpt["epoch"])


def auto_resume_helper(output_dir: str) -> Optional[str]:
    """The newest ``ckpt_epoch_*.pt`` by mtime (reference ``utils.py:93-103``),
    or None."""
    if not os.path.isdir(output_dir):
        return None
    cands = [os.path.join(output_dir, d) for d in os.listdir(output_dir)
             if _CKPT_RE.match(d)]
    if not cands:
        return None
    return max(cands, key=os.path.getmtime)
