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

Parameters are updated in place, every leaf at once by
:func:`multi_tensor_update` (``torch._foreach_*`` ops in the per-leaf
rule's arithmetic order), and the global norm is one multi-tensor norm:
an update launches a few kernels per op on the card instead of about
twenty per leaf. Skipping a step whose gradients are not finite is the
trainer's job: it then does not call :meth:`Optimizer.step`, so counts and
moments stay as they were. The clip reuses the trainer's norm of the
same gradients (:meth:`Optimizer.global_norm`).

With a ``layout`` (``parallel/zero.py::Layout``) the parameters may be this
rank's tensor-parallel blocks: the global norm counts each sharded leaf's
squares once over the model axis (:meth:`Optimizer.global_norm`). Under
ZeRO-1 the moments of the parameters in ``layout.zero`` hold this data
rank's block only; each rank computes its block of the update, and the
update is all-gathered before it is applied, so the parameters get the
same values, element for element, as without ZeRO-1.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch

from ..parallel import comm
from ..parallel import zero as zero_lib
from ..utils.profiling import span

__all__ = ["Optimizer", "build_optimizer", "no_weight_decay_mask",
           "global_norm", "multi_tensor_update", "scale_base_lr"]


def no_weight_decay_mask(params: Mapping[str, torch.Tensor]) -> Dict[str, bool]:
    """True where weight decay applies: parameters of rank >= 2 (the
    reference's ``len(shape) == 1 or name.endswith('.bias')`` rule)."""
    return {k: p.ndim > 1 for k, p in params.items()}


def global_norm(tensors) -> torch.Tensor:
    """``sqrt(sum of squares)`` over all tensors (``optax.global_norm``):
    every tensor's norm from one multi-tensor op, then the norm of those
    norms (a few launches on the card, not three per tensor)."""
    return torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(list(tensors))))


def _bias_correction(decay: float, count: int) -> float:
    # optax computes 1 - decay**count in float32
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class Optimizer:
    """The optax chain of the JAX package over named float32 parameters.

    The moments and the accumulator are dicts of one tensor per parameter
    name (``state``, as checkpoints hold them); the update reads them
    through lists of the same tensors in ``names`` order, built once."""

    def __init__(self, params: Mapping[str, torch.Tensor], name: str,
                 schedule: Callable, weight_decay: float, clip: float,
                 betas=(0.9, 0.999), eps: float = 1e-8,
                 momentum: float = 0.9, accumulation_steps: int = 1,
                 layout: Optional["zero_lib.Layout"] = None):
        self.name = name.lower()
        if self.name not in ("adamw", "sgd"):
            raise NotImplementedError(f"Unknown optimizer: {name}")
        self.params = dict(params)
        self.names = list(self.params)
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.clip = clip
        self.b1, self.b2 = betas
        self.eps = eps
        self.momentum = momentum
        self.every_k = max(int(accumulation_steps), 1)
        self.decay_mask = no_weight_decay_mask(self.params)
        self.layout = layout
        self.zero = layout.zero if layout is not None else {}
        zeros = lambda: {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.state = {"count": 0, "sched_count": 0, "mini_step": 0,
                      "gradient_step": 0}
        if self.name == "adamw":
            blocks = lambda: {k: torch.zeros_like(self.zero_block(k, p))
                              for k, p in self.params.items()}
            self.state.update(mu=blocks(), nu=blocks())
        else:
            self.state.update(trace=zeros())
        if self.every_k > 1:
            self.state["acc"] = zeros()
        # the lists the update runs over: the state's own tensors, and the
        # parameters' blocks (views) where the moments hold blocks
        self.lists = {k: [v[n] for n in self.names]
                      for k, v in self.state.items() if isinstance(v, dict)}
        self.lists["params"] = [self.params[n] for n in self.names]
        self.lists["blocks"] = [self.zero_block(n, self.params[n])
                                for n in self.names]
        self.decayed = [i for i, n in enumerate(self.names)
                        if self.decay_mask[n]]
        self.whole = [i for i, n in enumerate(self.names)
                      if n not in self.zero]
        self._norm_of = None  # (grads, norm) of the last global_norm

    def zero_block(self, k: str, t: torch.Tensor) -> torch.Tensor:
        """``t``'s ZeRO-1 block on this data rank (``t`` itself for a
        parameter that is not cut)."""
        if k not in self.zero:
            return t
        return zero_lib.block(t, self.zero[k], self.layout.mesh)

    def global_norm(self, grads: Mapping[str, torch.Tensor]) -> torch.Tensor:
        """The global norm of the full gradients of which ``grads`` holds
        this rank's blocks: under tensor parallelism the squares of the
        sharded leaves are summed over the model axis (each counted once),
        the replicated leaves' added once. The next :meth:`step` on the
        same ``grads`` mapping clips with this norm instead of computing
        it again."""
        if self.layout is None or not self.layout.tp:
            norm = global_norm(grads.values())
        else:
            sharded = self.layout.tp
            rep = [g for k, g in grads.items() if k not in sharded]
            sh = [g for k, g in grads.items() if k in sharded]
            zero = next(iter(grads.values())).new_zeros(())
            sq_rep = global_norm(rep).square() if rep else zero
            sq_sh = global_norm(sh).square() if sh else zero
            norm = torch.sqrt(sq_rep + comm.all_reduce(
                sq_sh, self.layout.model_group))
        self._norm_of = (grads, norm)
        return norm

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
        """One micro-step with the gradients ``grads`` (names as params).
        Without accumulation the clip reuses :meth:`global_norm` of this
        ``grads`` mapping when the caller took it (the trainer does)."""
        known, self._norm_of = self._norm_of, None
        g = [grads[n] for n in self.names]
        if self.every_k == 1:
            self._inner(g, known[1] if known and known[0] is grads
                        else None)
            return
        n_acc = self.state["mini_step"]
        acc = self.lists["acc"]
        with span("optim.accumulate"):
            d = torch._foreach_sub(g, acc)
            torch._foreach_div_(d, n_acc + 1)
            torch._foreach_add_(acc, d)
            del d
        if n_acc == self.every_k - 1:
            self._inner(acc, None)
            torch._foreach_zero_(acc)
            self.state["gradient_step"] += 1
        self.state["mini_step"] = (n_acc + 1) % self.every_k

    def _inner(self, grads: List[torch.Tensor],
               norm: Optional[torch.Tensor]) -> None:
        if self.clip and self.clip > 0:
            if norm is None:
                norm = self.global_norm(dict(zip(self.names, grads)))
            with span("sync.clip"):
                below = bool(norm < self.clip)
            if not below:
                grads = torch._foreach_div(grads, norm)
                torch._foreach_mul_(grads, self.clip)
        lr = self.schedule(self.state["sched_count"])
        multi_tensor_update(self, grads, lr)
        self.state["sched_count"] += 1


@torch.no_grad()
def multi_tensor_update(opt: Optimizer, grads: List[torch.Tensor],
                        lr: float) -> None:
    """One update of every parameter of ``opt`` from the (clipped)
    gradients ``grads``, in ``opt.names`` order, with multi-tensor ops:
    each ``torch._foreach_*`` call launches one kernel per group of
    tensors on the card, not one per leaf. The arithmetic is the per-leaf
    rule's, op for op and in its order: AdamW's ``mu <- (1 - b1) g + b1
    mu``, ``nu <- (1 - b2) g^2 + b2 nu``, ``u = (mu / bc1) / (sqrt(nu /
    bc2) + eps)``, ``u + wd p`` on the decayed leaves, ``p + u (-lr)``;
    or the decayed gradient into Nesterov's trace. Under ZeRO-1 a cut
    leaf's update is computed on this rank's block and all-gathered
    before it is applied.

    Counters: ``multi_tensor_update.steps`` (updates made) and
    ``.leaves`` (parameters they updated)."""
    lists, decayed = opt.lists, opt.decayed
    if opt.name == "adamw":
        opt.state["count"] += 1
        bc1 = _bias_correction(opt.b1, opt.state["count"])
        bc2 = _bias_correction(opt.b2, opt.state["count"])
        if opt.zero:
            grads = [opt.zero_block(n, g) for n, g in zip(opt.names, grads)]
        mu, nu = lists["mu"], lists["nu"]
        t = torch._foreach_mul(grads, 1 - opt.b1)
        torch._foreach_mul_(mu, opt.b1)
        torch._foreach_add_(mu, t)
        del t
        t = torch._foreach_mul(grads, grads)
        torch._foreach_mul_(t, 1 - opt.b2)
        torch._foreach_mul_(nu, opt.b2)
        torch._foreach_add_(nu, t)
        del t
        den = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, opt.eps)
        u = torch._foreach_div(mu, bc1)
        torch._foreach_div_(u, den)
        del den
        if decayed:
            blocks = lists["blocks"]
            t = torch._foreach_mul([blocks[i] for i in decayed],
                                   opt.weight_decay)
            torch._foreach_add_([u[i] for i in decayed], t)
            del t
        torch._foreach_mul_(u, -lr)
        whole = opt.whole
        if len(whole) < len(u):
            cut = {n: u[i] for i, n in enumerate(opt.names) if n in opt.zero}
            full = zero_lib.gather_update(cut, opt.zero, opt.layout.data_group)
            torch._foreach_add_([opt.params[n] for n in full],
                                list(full.values()))
            u = [u[i] for i in whole]
        if whole:
            torch._foreach_add_([lists["params"][i] for i in whole], u)
    else:
        params = lists["params"]
        u = list(grads)
        if decayed:
            t = torch._foreach_mul([params[i] for i in decayed],
                                   opt.weight_decay)
            torch._foreach_add_(t, [grads[i] for i in decayed])
            for i, d in zip(decayed, t):
                u[i] = d
        trace = lists["trace"]
        torch._foreach_mul_(trace, opt.momentum)
        torch._foreach_add_(trace, u)
        t = torch._foreach_mul(trace, opt.momentum)  # Nesterov
        torch._foreach_add_(t, u)
        torch._foreach_mul_(t, -lr)
        torch._foreach_add_(params, t)
    multi_tensor_update.steps += 1
    multi_tensor_update.leaves += len(opt.names)


multi_tensor_update.steps = 0
multi_tensor_update.leaves = 0


def build_optimizer(config, schedule: Callable, model,
                    layout: Optional["zero_lib.Layout"] = None) -> Optimizer:
    """The optimizer of ``config.TRAIN`` over ``model.named_parameters()``
    (this rank's blocks under ``layout``)."""
    t = config.TRAIN
    return Optimizer(
        dict(model.named_parameters()), t.OPTIMIZER.NAME, schedule,
        weight_decay=t.WEIGHT_DECAY, clip=t.CLIP_GRAD,
        betas=tuple(t.OPTIMIZER.BETAS), eps=t.OPTIMIZER.EPS,
        momentum=t.OPTIMIZER.MOMENTUM,
        accumulation_steps=t.ACCUMULATION_STEPS, layout=layout,
    )


def scale_base_lr(config, world_batch: int) -> None:
    """Linear LR scaling (reference ``main.py:437-449``): lr * total_batch /
    512, accumulation folded into the batch. Mutates a defrosted config."""
    accum = max(config.TRAIN.ACCUMULATION_STEPS, 1)
    factor = world_batch * accum / 512.0
    config.TRAIN.BASE_LR = config.TRAIN.BASE_LR * factor
    config.TRAIN.WARMUP_LR = config.TRAIN.WARMUP_LR * factor
    config.TRAIN.MIN_LR = config.TRAIN.MIN_LR * factor
