"""Evaluation and throughput (counterpart of the eval side of the JAX
package's ``train/trainer.py``). Training is a later slice."""

from __future__ import annotations

import time
from typing import Callable, Dict

import torch
import torch.nn.functional as F

__all__ = ["make_eval_step", "throughput"]


def make_eval_step(config, model) -> Callable:
    """(images, labels) -> partial sums for the accuracy/loss
    meters: ``loss_sum``, ``top1``, ``top5``, ``count`` (plain CE, as the
    JAX package's ``make_eval_step``, ``trainer.py:191-220``)."""

    @torch.no_grad()
    def eval_step(images: torch.Tensor,
                  labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        logits = model(images).float()
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
    and 30 timed forwards of one batch, synchronised on a GPU."""
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
