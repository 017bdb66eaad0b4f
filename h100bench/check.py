"""The numbers that decide ``correct``, each a gap between what the timed
path produced and what the plain reference works out from the same inputs.

* ``loss_gap``: the widest relative gap of a checked step's loss.
* ``grad_gap``: of the first checked step's gradient as the optimizer took
  it, the worst leaf's gap between the program's norm and the reference's,
  over the larger of the reference leaf's norm and the median leaf's.
* ``update_gap``: the same for each parameter's change over the checked
  steps, over the entries whose reference gradient is at least a
  thousandth of the median leaf's root-mean-square entry: below that an
  entry's gradient is round-off (a key's bias under a softmax, a bias
  ahead of a batch-statistics norm), which AdamW turns into a full step
  of either sign.
* ``logit_gap``: the widest relative L2 gap of one answer's logits.

Each has a limit in ``limits/<workload>.json``; a run is correct when
every number is at or under its limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional, Tuple

import torch

Leaves = Dict[str, torch.Tensor]
MOVED_SHARE = 1e-3


def _norms(leaves: Leaves) -> Dict[str, float]:
    return {k: float(t.double().norm()) for k, t in leaves.items()}


def norm_gap(prog: Leaves, ref: Leaves,
             keys: Optional[Iterable[str]] = None) -> Tuple[float, str]:
    """(worst gap, its leaf) of ``| |prog_k| - |ref_k| | / max(|ref_k|,
    median_j |ref_j|)`` over ``keys`` (default: every leaf of ``ref``)."""
    keys = list(ref) if keys is None else list(keys)
    rn, pn = _norms({k: ref[k] for k in keys}), _norms({k: prog[k]
                                                        for k in keys})
    median = statistics.median(rn.values())
    worst = (0.0, "")
    for k in keys:
        gap = abs(pn[k] - rn[k]) / max(rn[k], median, 1e-30)
        if not math.isfinite(gap):
            return math.inf, k
        worst = max(worst, (gap, k))
    return worst


def moved_entries(ref_grads: Leaves) -> Leaves:
    """Per leaf, the mask of entries whose reference gradient is at least
    :data:`MOVED_SHARE` of the median leaf's root-mean-square entry;
    leaves with no such entry are left out."""
    rms = [float(g.double().norm()) / g.numel() ** 0.5
           for g in ref_grads.values()]
    floor = MOVED_SHARE * statistics.median(rms)
    masks = {k: g.abs() >= floor for k, g in ref_grads.items()}
    return {k: m for k, m in masks.items() if bool(m.any())}


def train_readings(losses, grads: Leaves, start: Leaves, end: Leaves,
                   ref: dict) -> Dict[str, float]:
    """The training numbers from the program's checked steps (``losses``,
    the first step's ``grads``, the parameters at ``start`` and ``end``)
    and the reference's replay of them (``reference.train.replay_steps``)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                        ref["losses"]))
    loss_gap = loss_gap if math.isfinite(loss_gap) else math.inf
    grad_gap, grad_leaf = norm_gap(grads, ref["grads"])
    moved = moved_entries(ref["grads"])
    delta = {k: (end[k].float() - start[k].float())[m]
             for k, m in moved.items()}
    ref_delta = {k: (ref["params"][k].float() - start[k].float())[m]
                 for k, m in moved.items()}
    update_gap, update_leaf = norm_gap(delta, ref_delta)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap,
            "update_gap": update_gap, "_grad_leaf": grad_leaf,
            "_update_leaf": update_leaf, "_entries_compared":
            sum(int(m.sum()) for m in moved.values()),
            "_entries": sum(g.numel() for g in ref["grads"].values())}


def logit_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest relative L2 gap of one row of logits."""
    prog, ref = prog.double(), ref.double()
    rows = (prog - ref).norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
    gap = float(rows.max())
    return gap if math.isfinite(gap) else math.inf


def verdict(readings: Dict[str, float], limits: Dict[str, float]):
    """``(correct, [(name, value, limit)])`` over the limits' names; a
    number missing from ``readings`` or not finite fails."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = readings.get(name, float("nan"))
        good = value == value and value <= limit
        ok = ok and good
        rows.append((name, value, limit))
    return ok, rows
