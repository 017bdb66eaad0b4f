"""The training step of the plain reference: label-smoothed soft-target
cross-entropy, timm's batch-mode mixup / cutmix, the global-norm clip and
AdamW as optax chains them (bias-corrected moments, decoupled weight decay
on parameters of rank >= 2, ``* -lr``), gradient accumulation as optax's
``MultiSteps`` (the running mean of the micro-gradients feeds one update
every ``accumulation_steps``), and the step-wise cosine schedule with
linear warmup over optimizer updates.

The hyperparameters are a configuration file's ``train`` block. Mixup
needs ``mixup`` / ``cutmix`` above 0 (with ``mixup_prob``, default 1, and
``switch_prob``, default 0.5) and a CPU generator seeded as the program's
mixup generator: the draws are a frozen copy of the measured package's
``train/losses.py::mixup_cutmix``, call for call."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


def smooth_targets(labels, num_classes: int, smoothing: float):
    off = smoothing / num_classes
    return F.one_hot(labels.long(), num_classes).float() \
        * (1.0 - smoothing) + off


def soft_target_loss(logits, target):
    return -(target * torch.log_softmax(logits.float(), -1)).sum(-1).mean()


def mixes(hp: dict) -> bool:
    return hp.get("mixup", 0.0) > 0.0 or hp.get("cutmix", 0.0) > 0.0


def accumulation(hp: dict) -> int:
    return max(int(hp.get("accumulation_steps", 1)), 1)


def mix_batch(gen: torch.Generator, images, labels, num_classes: int,
              hp: dict):
    """``(images, soft targets)`` of one batch under timm's batch mode: one
    lambda for the batch, each image mixed with its batch-flip partner;
    with both alphas on, a coin picks mixup or cutmix. The draws from
    ``gen``, in order: the apply coin, the mixup / cutmix coin (both alphas
    on), a seed for numpy's Beta(alpha, alpha) (applied), the box's centre
    row and column (cutmix)."""
    mix_a, cut_a = hp.get("mixup", 0.0), hp.get("cutmix", 0.0)
    target = smooth_targets(labels, num_classes, hp["label_smoothing"])
    b, _, h, w = images.shape
    apply = float(torch.rand((), generator=gen)) < hp.get("mixup_prob", 1.0)
    if mix_a > 0.0 and cut_a > 0.0:
        cut = float(torch.rand((), generator=gen)) < hp.get("switch_prob",
                                                            0.5)
    else:
        cut = cut_a > 0.0
    lam = 1.0
    if apply:
        seed = int(torch.randint(0, 2**62, (), generator=gen))
        alpha = cut_a if cut else mix_a
        lam = float(np.random.default_rng(seed).beta(alpha, alpha))
    flipped = images.flip(0)
    if cut:
        ratio = math.sqrt(1.0 - lam)
        cut_h, cut_w = int(h * ratio), int(w * ratio)
        cy = int(torch.randint(0, h, (), generator=gen))
        cx = int(torch.randint(0, w, (), generator=gen))
        y1, y2 = (min(max(cy - cut_h // 2, 0), h),
                  min(max(cy + cut_h // 2, 0), h))
        x1, x2 = (min(max(cx - cut_w // 2, 0), w),
                  min(max(cx + cut_w // 2, 0), w))
        mixed = images.clone()
        mixed[:, :, y1:y2, x1:x2] = flipped[:, :, y1:y2, x1:x2]
        lam = 1.0 - (y2 - y1) * (x2 - x1) / float(h * w)
    else:
        mixed = images * lam + flipped * (1.0 - lam)
    return mixed, target * lam + target.flip(0) * (1.0 - lam)


def cosine_lr(hp: dict, step: int) -> float:
    """The learning rate at optimizer update ``step`` (timm's cosine over
    all updates, warmup included; an epoch has ``steps_per_epoch //
    accumulation_steps`` updates)."""
    per = hp["steps_per_epoch"]
    if accumulation(hp) > 1:
        per //= accumulation(hp)
    warm, total = hp["warmup_epochs"] * per, hp["epochs"] * per
    if step < warm:
        return hp["warmup_lr"] + step * (hp["base_lr"] - hp["warmup_lr"]) \
            / max(warm, 1)
    return hp["min_lr"] + 0.5 * (hp["base_lr"] - hp["min_lr"]) * (
        1 + math.cos(math.pi * step / total))


def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], hp: dict):
        self.params = params
        self.hp = hp
        self.count = 0
        self.sched = hp["start_step"]
        self.mu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One update; returns the gradients as the moments took them
        (after the clip)."""
        hp = self.hp
        b1, b2 = hp["betas"]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        if not bool(norm < hp["clip_grad"]):
            grads = {k: g / norm * hp["clip_grad"] for k, g in grads.items()}
        lr = cosine_lr(hp, self.sched)
        self.count += 1
        bc1 = _bias_correction(b1, self.count)
        bc2 = _bias_correction(b2, self.count)
        for k, p in self.params.items():
            g = grads[k]
            self.mu[k] = (1 - b1) * g + b1 * self.mu[k]
            self.nu[k] = (1 - b2) * g * g + b2 * self.nu[k]
            u = (self.mu[k] / bc1) / (torch.sqrt(self.nu[k] / bc2)
                                      + hp["eps"])
            if p.ndim > 1:
                u = u + hp["weight_decay"] * p
            p.add_(u * -lr)
        self.sched += 1
        return grads


def replay_steps(model, batches, hp: dict, num_classes: int,
                 mix_generator: torch.Generator = None) -> Dict[str, object]:
    """Train ``model`` (its parameters as loaded) on ``batches`` of
    ``(images, labels)``, one micro-step each, mixed from
    ``mix_generator`` where ``hp`` mixes. Returns the loss of each
    micro-step, the first update's clipped gradients and the parameters
    after the last micro-step."""
    if mixes(hp) and mix_generator is None:
        raise ValueError("mixup needs the program's mixup generator")
    model.train()
    params = dict(model.named_parameters())
    opt = AdamW(params, hp)
    accum = accumulation(hp)
    losses: List[float] = []
    first = acc = None
    for i, (images, labels) in enumerate(batches):
        for p in params.values():
            p.grad = None
        if mixes(hp):
            images, target = mix_batch(mix_generator, images, labels,
                                       num_classes, hp)
        else:
            target = smooth_targets(labels, num_classes,
                                    hp["label_smoothing"])
        loss = soft_target_loss(model(images), target)
        loss.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        for p in params.values():
            p.grad = None
        losses.append(float(loss.detach()))
        if accum > 1:
            # the running mean of the micro-gradients, as MultiSteps keeps it
            n = i % accum
            if n == 0:
                acc = {k: torch.zeros_like(g) for k, g in grads.items()}
            acc = {k: acc[k] + (g - acc[k]) / (n + 1)
                   for k, g in grads.items()}
            if n + 1 < accum:
                continue
            grads = acc
        taken = opt.step(grads)
        if first is None:
            first = {k: g.detach().clone() for k, g in taken.items()}
    return {"losses": losses, "grads": first,
            "params": {k: p.detach().clone() for k, p in params.items()}}
