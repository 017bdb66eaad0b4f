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
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.layers import ClusterAttention, Dropout, DropPath
from .losses import mixup_cutmix, smooth_one_hot, soft_target_cross_entropy
from .optim import Optimizer, build_optimizer, global_norm
from .schedulers import build_scheduler

__all__ = ["TrainState", "create_train_state", "apply_gradients",
           "model_loss", "make_train_step", "make_eval_step", "throughput",
           "ema_tensors"]


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
    seeds of the attention kernels' dropout."""

    model: torch.nn.Module
    optimizer: Optimizer
    drop_generator: torch.Generator
    mix_generator: torch.Generator
    upsample_generator: torch.Generator
    attn_drop_generator: torch.Generator
    step: int = 0
    ema: Optional[Dict[str, torch.Tensor]] = field(default=None)


def create_train_state(config, model, n_steps_per_epoch: int = 1000,
                       seed: Optional[int] = None
                       ) -> Tuple[TrainState, Callable]:
    """``(state, schedule)`` for ``model``: the optimizer of
    ``config.TRAIN``, the EMA copy when ``TRAIN.USE_EMA``, and generators
    seeded from ``seed`` (default ``config.SEED``), handed to every
    Dropout and DropPath, to a MaskFiner model's upsampling masks and to
    every ClusterAttention's dropout seeds."""
    seed = config.SEED if seed is None else seed
    schedule = build_scheduler(config, n_steps_per_epoch)
    optimizer = build_optimizer(config, schedule, model)
    device = next(model.parameters()).device
    drop_gen = torch.Generator(device=device).manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, (Dropout, DropPath)):
            mod.generator = drop_gen
    up_gen = torch.Generator().manual_seed(seed + 1)
    if hasattr(model, "upsample_generator"):
        model.upsample_generator = up_gen
    attn_gen = torch.Generator().manual_seed(seed + 2)
    for mod in model.modules():
        if isinstance(mod, ClusterAttention):
            mod.attn_drop_generator = attn_gen
    ema = None
    if config.TRAIN.USE_EMA:
        ema = {k: t.detach().clone() for k, t in ema_tensors(model).items()}
    state = TrainState(model, optimizer, drop_gen,
                       torch.Generator().manual_seed(seed), up_gen, attn_gen,
                       ema=ema)
    return state, schedule


def apply_gradients(state: TrainState, grads: Dict[str, torch.Tensor],
                    accum: int, ema_decay: float):
    """Everything of a train step after the backward
    (``trainer.py:130-168``): the global norm of ``grads``, the optimizer
    step when it is finite, the EMA on accumulation boundaries, ``step``
    + 1. Returns ``(grad_norm, finite)``."""
    grad_norm = global_norm(grads.values())
    finite = bool(torch.isfinite(grad_norm))
    if finite:
        state.optimizer.step(grads)
    if state.ema is not None and (state.step + 1) % accum == 0:
        with torch.no_grad():
            for k, t in ema_tensors(state.model).items():
                e = state.ema[k]
                e.copy_(e * ema_decay + t.to(e.dtype) * (1.0 - ema_decay))
    state.step += 1
    return grad_norm, finite


def model_loss(outputs, target: torch.Tensor) -> torch.Tensor:
    """Soft-target CE of the logits, or the mean of it over an aux-head
    model's list of logits (JAX ``trainer.py:101-105``)."""
    if isinstance(outputs, (list, tuple)):
        losses = [soft_target_cross_entropy(o, target) for o in outputs]
        return sum(losses) / len(losses)
    return soft_target_cross_entropy(outputs, target)


def make_train_step(config, state: TrainState, schedule: Callable) -> Callable:
    """``train_step(images, labels) -> metrics`` over ``state``:
    ``loss``, ``grad_norm`` (before clipping), ``grads_finite`` and ``lr``
    (the schedule at this optimizer step)."""
    num_classes = config.MODEL.NUM_CLASSES
    smoothing = config.MODEL.LABEL_SMOOTHING
    mixup_on = config.AUG.MIXUP > 0 or config.AUG.CUTMIX > 0
    ema_decay = config.TRAIN.EMA_DECAY
    accum = max(config.TRAIN.ACCUMULATION_STEPS, 1)
    model = state.model
    params = dict(model.named_parameters())

    def train_step(images: torch.Tensor, labels: torch.Tensor) -> dict:
        model.train()
        if mixup_on:
            images, target = mixup_cutmix(
                state.mix_generator, images, labels, num_classes,
                mixup_alpha=config.AUG.MIXUP, cutmix_alpha=config.AUG.CUTMIX,
                prob=config.AUG.MIXUP_PROB,
                switch_prob=config.AUG.MIXUP_SWITCH_PROB, smoothing=smoothing)
        else:
            target = smooth_one_hot(labels, num_classes, smoothing)
        for p in params.values():
            p.grad = None
        loss = model_loss(model(images), target)
        loss.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        lr = schedule(state.step // accum)
        grad_norm, finite = apply_gradients(state, grads, accum, ema_decay)
        return {"loss": loss.detach(), "grad_norm": grad_norm.detach(),
                "grads_finite": finite, "lr": lr}

    return train_step


def make_eval_step(config, model) -> Callable:
    """(images, labels) -> partial sums for the accuracy/loss
    meters: ``loss_sum``, ``top1``, ``top5``, ``count`` (plain CE, as the
    JAX package's ``make_eval_step``, ``trainer.py:191-220``). Puts the
    model in eval mode."""

    @torch.no_grad()
    def eval_step(images: torch.Tensor,
                  labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        model.eval()
        logits = model(images)
        if isinstance(logits, (list, tuple)):
            logits = logits[-1]
        logits = logits.float()
        loss_sum = F.cross_entropy(logits, labels, reduction="sum")
        # lower class index first among equal logits, as jnp.argsort
        top = torch.sort(-logits, dim=-1, stable=True)[1][:, :5]
        return {
            "loss_sum": loss_sum,
            "top1": (top[:, 0] == labels).sum(),
            "top5": (top == labels[:, None]).any(-1).sum(),
            "count": torch.tensor(labels.numel()),
        }

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
