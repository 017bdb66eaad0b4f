"""Checkpoint save / load / auto-resume with ``torch.save`` (counterpart of
the JAX package's ``ckpt/orbax_io.py``).

Same semantics: ``ckpt_epoch_<e>.pt`` under the output directory, the
newest one always kept and multiples of ``keep_every`` (``SAVE_FREQ``)
retained; auto-resume takes the newest checkpoint by mtime; a checkpoint
holds ``(state, epoch, max_accuracy, rng state)``. ``state`` is the model's
``state_dict`` (parameters and BatchNorm buffers), the optimizer's state,
the EMA copy and the step count; the rng state is that of the train
state's four generators. Saves are synchronous and atomic (a temporary file
renamed into place), so auto-resume never sees a partial checkpoint.

Across processes (a train state with a ``layout``) a checkpoint still holds
the one-process layout, as the JAX package's process 0 writes the global
arrays (``orbax_io.py:73``): every rank takes part in gathering the
tensor-parallel blocks over the model axis and the ZeRO-1 blocks of the
moments and EMA over the data axis, and rank 0 alone writes; the seq
ranks of a data rank hold replicas, so rank 0 speaks for them too. A load
cuts each rank's blocks from that layout again, so a checkpoint written by
W ranks resumes in one process and the reverse.
"""

from __future__ import annotations

import os
import re
from typing import Optional, Tuple

import torch

from ..parallel import comm
from ..parallel import tp as tp_lib
from ..parallel import zero as zero_lib

__all__ = ["save_checkpoint", "load_checkpoint", "load_model_weights",
           "auto_resume_helper", "full_ema", "local_state_dict", "full_tensor",
           "local_tensor"]

_CKPT_RE = re.compile(r"ckpt_epoch_(\d+)\.pt$")


def full_tensor(key: str, t: torch.Tensor, layout, cut: bool) -> torch.Tensor:
    """The one-process tensor of this rank's ``t`` (parameter ``key`` or a
    tensor shaped like it; ``cut``: a moment or EMA, which ZeRO-1 cuts)."""
    if layout is None:
        return t
    mesh = layout.mesh
    if cut and key in layout.zero:
        t = comm.all_gather(t, mesh.data_group, dim=layout.zero[key])
    if key in layout.tp:
        blocks = comm.all_gather(t[None], mesh.model_group, dim=0)
        t = tp_lib.unshard(blocks.unbind(0), layout.tp[key])
    return t


def local_tensor(key: str, t: torch.Tensor, layout, cut: bool) -> torch.Tensor:
    """This rank's block of the one-process tensor ``t`` (the inverse of
    :func:`full_tensor`)."""
    if layout is None:
        return t
    mesh = layout.mesh
    if key in layout.tp:
        t = tp_lib.shard_tensor(t, layout.tp[key], mesh.model_rank,
                                mesh.model)
    if cut and key in layout.zero:
        t = zero_lib.block(t, layout.zero[key], mesh)
    return t


def local_state_dict(state_dict, layout):
    """This rank's blocks of a one-process model ``state_dict`` (the dict
    itself without a ``layout``); keys it does not shard pass as they
    are."""
    if layout is None:
        return state_dict
    return {k: local_tensor(k, t, layout, False)
            for k, t in state_dict.items()}


def _optimizer_state(opt_state: dict, to) -> dict:
    """An optimizer ``state_dict`` with every per-parameter tensor passed
    through ``to`` (:func:`full_tensor` or :func:`local_tensor`); only
    AdamW's moments are cut."""
    return {name: ({k: to(k, t, name in ("mu", "nu")) for k, t in v.items()}
                   if isinstance(v, dict) else v)
            for name, v in opt_state.items()}


def full_ema(state):
    """The train state's EMA in the one-process layout of this rank's
    model (ZeRO-1 blocks gathered over the data axis, tensor-parallel
    blocks kept): what an EMA copy of ``state.model`` loads."""
    layout = state.layout
    if state.ema is None or layout is None or not layout.zero:
        return state.ema
    return {k: (comm.all_gather(t, layout.mesh.data_group,
                                dim=layout.zero[k]) if k in layout.zero
                else t) for k, t in state.ema.items()}


def _payload(state, epoch: int, max_accuracy: float) -> dict:
    layout = getattr(state, "layout", None)
    to = lambda k, t, cut: full_tensor(k, t, layout, cut)
    return {
        "state": {
            "model": {k: to(k, t, False)
                      for k, t in state.model.state_dict().items()},
            "optimizer": _optimizer_state(state.optimizer.state_dict(), to),
            "ema": (None if state.ema is None else
                    {k: to(k, t, True) for k, t in state.ema.items()}),
            "step": state.step,
        },
        "epoch": epoch,
        "max_accuracy": max_accuracy,
        "rng": {"drop": state.drop_generator.get_state(),
                "mix": state.mix_generator.get_state(),
                "upsample": state.upsample_generator.get_state(),
                "attn_drop": state.attn_drop_generator.get_state()},
    }


def save_checkpoint(output_dir: str, epoch: int, state, max_accuracy: float,
                    keep_every: int = 5) -> str:
    """Write ``ckpt_epoch_<epoch>.pt`` and prune older checkpoints that are
    neither the newest nor a multiple of ``keep_every``. Across processes
    every rank calls it (the gathers) and rank 0 alone writes; every rank
    returns the path."""
    path = os.path.join(os.path.abspath(output_dir), f"ckpt_epoch_{epoch}.pt")
    payload = _payload(state, epoch, max_accuracy)
    layout = getattr(state, "layout", None)
    if layout is not None and layout.mesh.rank != 0:
        return path
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
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, state) -> Tuple[object, int, float]:
    """Restore ``state`` in place from ``path``; returns ``(state, epoch,
    max_accuracy)``. The generators' states are restored too. Across
    processes each rank loads its blocks of the one-process layout."""
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=False)
    saved = ckpt["state"]
    layout = getattr(state, "layout", None)
    to = lambda k, t, cut: local_tensor(k, t, layout, cut)
    state.model.load_state_dict(local_state_dict(saved["model"], layout))
    state.optimizer.load_state_dict(_optimizer_state(saved["optimizer"], to))
    if state.ema is not None and saved["ema"] is not None:
        for k, t in saved["ema"].items():
            state.ema[k].copy_(to(k, t, True))
    state.step = int(saved["step"])
    state.drop_generator.set_state(ckpt["rng"]["drop"].cpu())
    state.mix_generator.set_state(ckpt["rng"]["mix"].cpu())
    if "upsample" in ckpt["rng"]:  # written before MaskFiner training
        state.upsample_generator.set_state(ckpt["rng"]["upsample"].cpu())
    if "attn_drop" in ckpt["rng"]:  # written before attention dropout
        state.attn_drop_generator.set_state(ckpt["rng"]["attn_drop"].cpu())
    return state, int(ckpt["epoch"]), float(ckpt["max_accuracy"])


def load_model_weights(path: str, model, layout=None) -> int:
    """Load only the model's ``state_dict`` (parameters and BatchNorm
    buffers) of the checkpoint at ``path`` into ``model`` (strict; this
    rank's blocks under ``layout``); returns the checkpoint's epoch. For
    evaluation and throughput, where no train state exists."""
    device = next(model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=False)
    model.load_state_dict(local_state_dict(ckpt["state"]["model"], layout))
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
