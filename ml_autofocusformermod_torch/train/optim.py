"""AdamW / SGD with no weight decay on parameters of rank < 2, clipping by
global norm and gradient accumulation (counterpart of the JAX package's
``train/optim.py``, which builds an optax chain).

:class:`Optimizer` reproduces that chain operation for operation, in
float32, rather than wrapping ``torch.optim``:

* ``optax.clip_by_global_norm(clip)``: when the norm is not below ``clip``
  the gradients become ``(g / norm) * clip`` (no ``+1e-6`` as in
  ``torch.nn.utils.clip_grad_norm_``);
* ``optax.adamw``: bias-corrected moments, then the decoupled decay
  ``+ wd * p`` on the pre-update parameter (rank >= 2 only), then
  ``* -lr``; or ``add_decayed_weights`` + Nesterov ``optax.sgd``;
* the learning rate is ``schedule(k)`` with ``k`` the optimizer's own
  update count, starting at 0;
* ``optax.MultiSteps(every_k)``: the running mean of ``k`` micro-gradients
  feeds one update; the other micro-steps leave the parameters as they are.

Parameters are updated in place. Skipping a step whose gradients are not
finite is the trainer's job: it then does not call :meth:`Optimizer.step`,
so counts and moments stay as they were.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch

__all__ = ["Optimizer", "build_optimizer", "no_weight_decay_mask",
           "global_norm", "scale_base_lr"]


def no_weight_decay_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """True where weight decay applies: parameters of rank >= 2 (the
    reference's ``len(shape) == 1 or name.endswith('.bias')`` rule)."""
    return {k: p.ndim > 1 for k, p in params.items()}


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over all tensors (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def _bias_correction(decay: float, count: int) -> float:
    # optax computes 1 - decay**count in float32
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class Optimizer:
    """The optax chain of the JAX package over named float32 parameters."""

    def __init__(self, params: Mapping[str, torch.Tensor], name: str,
                 schedule: Callable, weight_decay: float, clip: float,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 momentum: float = 0.9, accumulation_steps: int = 1):
        self.name = name.lower()
        if self.name not in ("adamw", "sgd"):
            raise NotImplementedError(f"Unknown optimizer: {name}")
        self.params = dict(params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip = clip
        self.b1, self.b2 = betas
        self.eps = eps
        self.momentum = momentum
        self.every_k = max(int(accumulation_steps), 1)
        self.decay_mask = no_weight_decay_mask(self.params)
        zeros = lambda: {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.state = {"count": 0, "sched_count": 0, "mini_step": 0,
                      "gradient_step": 0}
        if self.name == "adamw":
            self.state.update(mu=zeros(), nu=zeros())
        else:
            self.state.update(trace=zeros())
        if self.every_k > 1:
            self.state["acc"] = zeros()

    # --------------------------------------------------------------- state
    def state_dict(self) -> dict:
        return {k: (dict(v) if isinstance(v, dict) else v)
                for k, v in self.state.items()}

    def load_state_dict(self, state: Mapping) -> None:
        for k, v in state.items():
            if isinstance(v, Mapping):
                for name, t in v.items():
                    self.state[k][name].copy_(t)
            else:
                self.state[k] = int(v)

    # -------------------------------------------------------------- update
    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> None:
        """One micro-step with the gradients ``grads`` (names as params)."""
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
            norm = global_norm(grads.values())
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


def build_optimizer(config, schedule: Callable, model) -> Optimizer:
    """The optimizer of ``config.TRAIN`` over ``model.named_parameters()``."""
    t = config.TRAIN
    return Optimizer(
        dict(model.named_parameters()), t.OPTIMIZER.NAME, schedule,
        weight_decay=t.WEIGHT_DECAY, clip=t.CLIP_GRAD,
        betas=tuple(t.OPTIMIZER.BETAS), eps=t.OPTIMIZER.EPS,
        momentum=t.OPTIMIZER.MOMENTUM,
        accumulation_steps=t.ACCUMULATION_STEPS,
    )


def scale_base_lr(config, world_batch: int) -> None:
    """Linear LR scaling (reference ``main.py:437-449``): lr * total_batch /
    512, accumulation folded into the batch. Mutates a defrosted config."""
    accum = max(config.TRAIN.ACCUMULATION_STEPS, 1)
    factor = world_batch * accum / 512.0
    config.TRAIN.BASE_LR = config.TRAIN.BASE_LR * factor
    config.TRAIN.WARMUP_LR = config.TRAIN.WARMUP_LR * factor
    config.TRAIN.MIN_LR = config.TRAIN.MIN_LR * factor
