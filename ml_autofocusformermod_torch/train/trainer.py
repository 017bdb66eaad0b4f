"""Train step, evaluation and throughput (counterpart of the JAX package's
``train/trainer.py``).

The train step is the JAX one: smoothed or mixed soft targets -> forward
in training mode (``model.train()``; BatchNorm updates its running stats)
-> soft-target CE -> backward -> global gradient norm -> the optimizer
(clip, AdamW, accumulation) unless a gradient is not finite -> EMA of the
parameters and the BatchNorm buffers on accumulation boundaries. A step
whose gradients are not finite leaves the parameters, the optimizer's
counts and moments as they were, but ``step`` still advances
(``trainer.py:130-145``). Compute-dtype semantics are the model's: float32
parameters and explicit casts, no autocast and no GradScaler.

Under data parallelism (a ``layout`` whose mesh has data ranks) the step
computes what the one-process step of the global batch computes, as JAX's
jitted step on a batch-sharded mesh does: mixup pairs each row with its
partner in the global batch (on the mirror data rank), the gradients are
averaged over the data ranks after the backward, the logged loss is the
global mean, and the evaluation sums run over every data rank. Per-image
draws (DropPath, MaskFiner's upsampling masks) are the global batch's,
sliced to the rank's rows, and the attention kernels' dropout seed is
offset to the rank's first image; element-wise Dropout then draws from its
own stream per data rank, not from the one-process stream: a generator
seeded anew at every step from the seed, the data rank and the step, as
JAX folds the step into its key, so a resumed run draws what the
uninterrupted run draws. Under tensor parallelism alone the step draws what
one process draws, Dropout too: a layer split over the model axis draws
the mask of its whole activation and keeps its block, and the attention
kernels' dropout seed is offset to the rank's first head. Under sequence
parallelism the seq ranks of a data rank draw the same numbers (a layer
draws for all of the stage's tokens and keeps the rank's), and the
gradients are averaged over the data and seq ranks together
(``parallel/__init__.py`` gives the rule).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import ClusterAttention, Dropout, DropPath
from ..parallel import comm
from ..parallel import mesh as mesh_lib
from ..parallel import zero as zero_lib
from ..utils.profiling import STEP_SPAN, span
from .losses import mixup_cutmix, smooth_one_hot, soft_target_cross_entropy
from .optim import Optimizer, build_optimizer
from .schedulers import build_scheduler

__all__ = ["TrainState", "create_train_state", "apply_gradients",
           "model_loss", "check_mesh", "make_train_step", "make_eval_step",
           "throughput", "ema_tensors", "elem_step_seed"]


def ema_tensors(model) -> Dict[str, torch.Tensor]:
    """The tensors the EMA shadows: every parameter and every floating
    buffer (BatchNorm running stats), as timm's ModelEmaV2 does."""
    out = dict(model.named_parameters())
    out.update((k, b) for k, b in model.named_buffers()
               if b.is_floating_point())
    return out


@dataclass
class TrainState:
    """What a train step reads and updates. ``drop_generator`` (on the
    model's device) drives Dropout and DropPath; ``mix_generator`` (CPU)
    drives mixup; ``upsample_generator`` (CPU) draws a MaskFiner model's
    upsampling masks in training; ``attn_drop_generator`` (CPU) draws the
    seeds of the attention kernels' dropout. ``layout`` is how this rank
    holds the state across processes (None: one process). Under ZeRO-1
    ``ema`` holds this data rank's block of each cut parameter. With more
    than one data rank, ``elem_generator`` (on the model's device) drives
    Dropout, seeded at every step from ``elem_seed`` and ``step``
    (:func:`elem_step_seed`)."""

    model: torch.nn.Module
    optimizer: Optimizer
    drop_generator: torch.Generator
    mix_generator: torch.Generator
    upsample_generator: torch.Generator
    attn_drop_generator: torch.Generator
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = field(default=None)
    layout: Optional[zero_lib.Layout] = None
    elem_generator: Optional[torch.Generator] = None
    elem_seed: int = 0


def elem_step_seed(elem_seed: int, step: int) -> int:
    """The seed of a data rank's Dropout stream at ``step``: a function of
    the rank's base seed and the step alone, so no state carries over."""
    return (elem_seed * 1000033 + step) & (2**63 - 1)


def create_train_state(config, model, n_steps_per_epoch: int = 1000,
                       seed: Optional[int] = None,
                       layout: Optional[zero_lib.Layout] = None
                       ) -> Tuple[TrainState, Callable]:
    """``(state, schedule)`` for ``model``: the optimizer of
    ``config.TRAIN``, the EMA copy when ``TRAIN.USE_EMA``, and generators
    seeded from ``seed`` (default ``config.SEED``), handed to every
    Dropout and DropPath, to a MaskFiner model's upsampling masks and to
    every ClusterAttention's dropout seeds. ``layout``: this rank's share
    of a model sharded across processes (``parallel/zero.py::
    make_layout``); with more than one data rank Dropout draws from a
    generator of its own, seeded at each step from ``seed``, the data rank
    and the step (the model and seq ranks of a data rank share it)."""
    seed = config.SEED if seed is None else seed
    schedule = build_scheduler(config, n_steps_per_epoch)
    optimizer = build_optimizer(config, schedule, model, layout)
    device = next(model.parameters()).device
    drop_gen = torch.Generator(device=device).manual_seed(seed)
    elem_gen, elem_seed = drop_gen, 0
    if layout is not None and layout.mesh.data > 1:
        elem_seed = seed * 1000003 + layout.mesh.data_rank + 1
        elem_gen = torch.Generator(device=device)
    for mod in model.modules():
        if isinstance(mod, DropPath):
            mod.generator = drop_gen
        elif isinstance(mod, Dropout):
            mod.generator = elem_gen
    up_gen = torch.Generator().manual_seed(seed + 1)
    if hasattr(model, "upsample_generator"):
        model.upsample_generator = up_gen
    attn_gen = torch.Generator().manual_seed(seed + 2)
    for mod in model.modules():
        if isinstance(mod, ClusterAttention):
            mod.attn_drop_generator = attn_gen
    ema = None
    if config.TRAIN.USE_EMA:
        ema = {k: optimizer.zero_block(k, t.detach()).clone()
               for k, t in ema_tensors(model).items()}
    state = TrainState(model, optimizer, drop_gen,
                       torch.Generator().manual_seed(seed), up_gen, attn_gen,
                       ema=ema, layout=layout,
                       elem_generator=None if elem_gen is drop_gen
                       else elem_gen, elem_seed=elem_seed)
    return state, schedule


def apply_gradients(state: TrainState, grads: Dict[str, torch.Tensor],
                    accum: int, ema_decay: float):
    """Everything of a train step after the backward
    (``trainer.py:130-168``): the global norm of ``grads``, the optimizer
    step when it is finite (its clip reuses the norm), the EMA on
    accumulation boundaries (multi-tensor ops, as the optimizer's update),
    ``step`` + 1. Returns ``(grad_norm, finite)``. ``grads`` are this
    rank's blocks of the full (data-averaged) gradients."""
    grad_norm = state.optimizer.global_norm(grads)
    with span("sync.grads_finite"):
        finite = bool(torch.isfinite(grad_norm))
    if finite:
        state.optimizer.step(grads)
    if state.ema is not None and (state.step + 1) % accum == 0:
        with torch.no_grad():
            src = ema_tensors(state.model)
            ema = list(state.ema.values())
            new = [state.optimizer.zero_block(k, src[k]).to(e.dtype)
                   for k, e in state.ema.items()]
            new = torch._foreach_mul(new, 1.0 - ema_decay)
            torch._foreach_mul_(ema, ema_decay)
            torch._foreach_add_(ema, new)
    state.step += 1
    return grad_norm, finite


def model_loss(outputs, target: torch.Tensor) -> torch.Tensor:
    """Soft-target CE of the logits, or the mean of it over an aux-head
    model's list of logits (JAX ``trainer.py:101-105``)."""
    if isinstance(outputs, (list, tuple)):
        losses = [soft_target_cross_entropy(o, target) for o in outputs]
        return sum(losses) / len(losses)
    return soft_target_cross_entropy(outputs, target)


def check_mesh(layout: Optional[zero_lib.Layout]) -> None:
    """Raise unless the ambient mesh, which the model's batch-wide
    reductions read, is ``layout``'s (none, or one of a single rank,
    without a layout)."""
    m = mesh_lib.current()
    ok = (m is layout.mesh if layout is not None
          else m is None or m.world == 1)
    if not ok:
        raise RuntimeError(
            f"the installed mesh {m} is not the train state's layout's "
            f"({layout.mesh if layout is not None else None}): "
            f"parallel/zero.py::make_layout installs it")


def make_train_step(config, state: TrainState, schedule: Callable) -> Callable:
    """``train_step(images, labels) -> metrics`` over ``state``:
    ``loss``, ``grad_norm`` (before clipping), ``grads_finite`` and ``lr``
    (the schedule at this optimizer step). Each step first checks that the
    ambient mesh is the state's layout's (:func:`check_mesh`). Under a
    profiler a step is one ``train_step`` span holding its ``.forward``
    (with ``.mix`` around mixup / cutmix), ``.backward`` and
    ``.optimizer`` (``utils/profiling.py``)."""
    num_classes = config.MODEL.NUM_CLASSES
    smoothing = config.MODEL.LABEL_SMOOTHING
    mixup_on = config.AUG.MIXUP > 0 or config.AUG.CUTMIX > 0
    ema_decay = config.TRAIN.EMA_DECAY
    accum = max(config.TRAIN.ACCUMULATION_STEPS, 1)
    model = state.model
    params = dict(model.named_parameters())
    data_group = state.layout.data_group if state.layout else None
    replica_group = state.layout.replica_group if state.layout else None
    data = comm.size(data_group)

    def partner(t: torch.Tensor) -> torch.Tensor:
        # the rows of t's global batch, reversed, that meet this rank's
        return comm.mirror(t, data_group).flip(0)

    def train_step(images: torch.Tensor, labels: torch.Tensor) -> dict:
        with span(STEP_SPAN):
            check_mesh(state.layout)
            model.train()
            if state.elem_generator is not None:
                state.elem_generator.manual_seed(
                    elem_step_seed(state.elem_seed, state.step))
            with span(STEP_SPAN + ".forward"):
                if mixup_on:
                    with span(STEP_SPAN + ".mix"):
                        images, target = mixup_cutmix(
                            state.mix_generator, images, labels,
                            num_classes, mixup_alpha=config.AUG.MIXUP,
                            cutmix_alpha=config.AUG.CUTMIX,
                            prob=config.AUG.MIXUP_PROB,
                            switch_prob=config.AUG.MIXUP_SWITCH_PROB,
                            smoothing=smoothing, partner=partner)
                else:
                    target = smooth_one_hot(labels, num_classes, smoothing)
                for p in params.values():
                    p.grad = None
                loss = model_loss(model(images), target)
            with span(STEP_SPAN + ".backward"):
                loss.backward()
            with span(STEP_SPAN + ".optimizer"):
                grads = {k: (p.grad if p.grad is not None
                             else torch.zeros_like(p))
                         for k, p in params.items()}
                # the mean of the ranks' gradients of their batch means:
                # the gradient of the global batch's mean (over the seq
                # ranks too: parallel/__init__.py)
                comm.all_reduce_mean_(grads.values(), replica_group)
                lr = schedule(state.step // accum)
                grad_norm, finite = apply_gradients(state, grads, accum,
                                                    ema_decay)
                loss = loss.detach()
                if data > 1:
                    loss = comm.all_reduce(loss, data_group) / data
            return {"loss": loss, "grad_norm": grad_norm.detach(),
                    "grads_finite": finite, "lr": lr}

    return train_step


def make_eval_step(config, model) -> Callable:
    """(images, labels[, valid]) -> partial sums for the accuracy/loss
    meters: ``loss_sum``, ``top1``, ``top5``, ``count`` over the rows where
    ``valid`` (default: every row), plain CE, as the JAX package's
    ``make_eval_step`` (``trainer.py:191-220``); under data parallelism
    summed over the data ranks (the ambient mesh's), as JAX's sums run over
    the whole mesh. Puts the model in eval mode."""

    @torch.no_grad()
    def eval_step(images: torch.Tensor, labels: torch.Tensor,
                  valid: Optional[torch.Tensor] = None
                  ) -> Dict[str, torch.Tensor]:
        model.eval()
        logits = model(images)
        if isinstance(logits, (list, tuple)):
            logits = logits[-1]
        logits = logits.float()
        if valid is None:
            valid = torch.ones_like(labels, dtype=torch.bool)
        per_sample = F.cross_entropy(logits, labels, reduction="none")
        # lower class index first among equal logits, as jnp.argsort
        top = torch.sort(-logits, dim=-1, stable=True)[1][:, :5]
        out = {
            "loss_sum": (per_sample * valid).sum(),
            "top1": ((top[:, 0] == labels) & valid).sum(),
            "top5": ((top == labels[:, None]).any(-1) & valid).sum(),
            "count": valid.sum(),
        }
        if comm.data_coords()[1] > 1:
            sums = comm.data_all_reduce(
                torch.stack([v.double() for v in out.values()]))
            out = {k: (s if k == "loss_sum" else s.long())
                   for k, s in zip(out, sums)}
        return out

    return eval_step


@torch.no_grad()
def throughput(model, images: torch.Tensor, warmup: int = 50,
               iters: int = 30) -> float:
    """Images/s with the reference protocol (``main.py:387-414``): 50 warmup
    and 30 timed forwards of one batch in eval mode, synchronised on a
    GPU."""
    model.eval()
    sync = (torch.cuda.synchronize if images.device.type == "cuda"
            else (lambda: None))
    for _ in range(warmup):
        model(images)
    sync()
    t1 = time.perf_counter()
    for _ in range(iters):
        model(images)
    sync()
    t2 = time.perf_counter()
    return iters * images.shape[0] / (t2 - t1)
