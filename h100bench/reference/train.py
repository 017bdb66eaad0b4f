"""The training step of the plain reference: label-smoothed soft-target
cross-entropy, the global-norm clip and AdamW as optax chains them
(bias-corrected moments, decoupled weight decay on parameters of rank >= 2,
``* -lr``), and the step-wise cosine schedule with linear warmup."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F


def soft_target_loss(logits, labels, num_classes: int, smoothing: float):
    off = smoothing / num_classes
    target = F.one_hot(labels.long(), num_classes).float() \
        * (1.0 - smoothing) + off
    return -(target * torch.log_softmax(logits.float(), -1)).sum(-1).mean()


def cosine_lr(hp: dict, step: int) -> float:
    """The learning rate at optimizer step ``step`` (timm's cosine over all
    steps, warmup included)."""
    per = hp["steps_per_epoch"]
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


def replay_steps(model, batches, hp: dict, num_classes: int
                 ) -> Dict[str, object]:
    """Train ``model`` (its parameters as loaded) on ``batches`` of
    ``(images, labels)``, one step each. Returns the loss of each step,
    the first step's clipped gradients and the parameters after the
    last step."""
    model.train()
    params = dict(model.named_parameters())
    opt = AdamW(params, hp)
    losses: List[float] = []
    first = None
    for images, labels in batches:
        for p in params.values():
            p.grad = None
        loss = soft_target_loss(model(images), labels, num_classes,
                                hp["label_smoothing"])
        loss.backward()
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in params.items()}
        for p in params.values():
            p.grad = None
        taken = opt.step(grads)
        if first is None:
            first = {k: g.detach().clone() for k, g in taken.items()}
        losses.append(float(loss.detach()))
    return {"losses": losses, "grads": first,
            "params": {k: p.detach().clone() for k, p in params.items()}}
