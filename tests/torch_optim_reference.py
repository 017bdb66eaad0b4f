"""The port's optimizer as per-leaf rules: each parameter updated on its
own by plain tensor ops, in the order ``train/optim.py`` computes them
over lists (``multi_tensor_update``). The reference of the list update's
tests, on the CPU and on the card; it imports no JAX.

:class:`PerLeaf` is clip + AdamW or Nesterov SGD + the running mean of
``every_k`` micro-gradients, one process (no ZeRO-1, no tensor
parallelism); :func:`apply_gradients` adds the trainer's skip of a
non-finite step and the EMA.
"""

from typing import Callable, Dict, Mapping

import numpy as np
import torch


def global_norm(tensors) -> torch.Tensor:
    """``sqrt`` of the Python sum of every leaf's ``sum(t * t)``."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class PerLeaf:
    """A copy of ``opt``'s parameters, moments and counts, updated leaf by
    leaf. ``norm`` computes the clip's global norm (the per-leaf sum by
    default)."""

    def __init__(self, opt, norm: Callable = global_norm):
        self.params = {k: p.detach().clone() for k, p in opt.params.items()}
        self.name, self.schedule = opt.name, opt.schedule
        self.weight_decay, self.clip = opt.weight_decay, opt.clip
        self.b1, self.b2, self.eps = opt.b1, opt.b2, opt.eps
        self.momentum, self.every_k = opt.momentum, opt.every_k
        self.decay_mask = dict(opt.decay_mask)
        self.norm = norm
        self.state = {k: ({n: t.clone() for n, t in v.items()}
                          if isinstance(v, dict) else v)
                      for k, v in opt.state.items()}

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> None:
        if self.every_k == 1:
            self._inner(grads)
            return
        n_acc = self.state["mini_step"]
        acc = self.state["acc"]
        for k, g in grads.items():
            acc[k].add_((g - acc[k]) / (n_acc + 1))
        if n_acc == self.every_k - 1:
            self._inner(acc)
            for a in acc.values():
                a.zero_()
            self.state["gradient_step"] += 1
        self.state["mini_step"] = (n_acc + 1) % self.every_k

    def _inner(self, grads: Mapping[str, torch.Tensor]) -> None:
        if self.clip and self.clip > 0:
            norm = self.norm(grads.values())
            if not bool(norm < self.clip):
                grads = {k: (g / norm) * self.clip for k, g in grads.items()}
        lr = self.schedule(self.state["sched_count"])
        if self.name == "adamw":
            self.state["count"] += 1
            bc1 = _bias_correction(self.b1, self.state["count"])
            bc2 = _bias_correction(self.b2, self.state["count"])
            mu, nu = self.state["mu"], self.state["nu"]
            for k, p in self.params.items():
                g = grads[k]
                mu[k].copy_((1 - self.b1) * g + self.b1 * mu[k])
                nu[k].copy_((1 - self.b2) * (g * g) + self.b2 * nu[k])
                u = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + self.eps)
                if self.decay_mask[k]:
                    u = u + self.weight_decay * p
                p.add_(u * -lr)
        else:
            trace = self.state["trace"]
            for k, p in self.params.items():
                u = grads[k]
                if self.decay_mask[k]:
                    u = u + self.weight_decay * p
                trace[k].copy_(u + self.momentum * trace[k])
                u = u + self.momentum * trace[k]  # Nesterov
                p.add_(u * -lr)
        self.state["sched_count"] += 1


@torch.no_grad()
def apply_gradients(ref: PerLeaf, ema: Dict[str, torch.Tensor],
                    grads: Mapping[str, torch.Tensor], step: int,
                    accum: int, ema_decay: float) -> bool:
    """``trainer.py::apply_gradients`` over ``ref`` and the EMA ``ema`` of
    its parameters, leaf by leaf; returns whether the step was finite."""
    finite = bool(torch.isfinite(ref.norm(grads.values())))
    if finite:
        ref.step(grads)
    if (step + 1) % accum == 0:
        for k, e in ema.items():
            e.copy_(e * ema_decay + ref.params[k] * (1.0 - ema_decay))
    return finite
