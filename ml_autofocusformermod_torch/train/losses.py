"""Classification losses and batch mixup/cutmix (counterpart of the JAX
package's ``train/losses.py``).

Replaces timm's ``SoftTargetCrossEntropy`` / ``LabelSmoothingCrossEntropy``
and timm ``Mixup(mode='batch')`` with plain torch. Randomness comes from an
explicit ``torch.Generator``; the draws differ from ``jax.random`` for the
same seed, so mixup is held to the JAX function by its properties, not its
numbers.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "cross_entropy",
    "soft_target_cross_entropy",
    "smooth_one_hot",
    "mixup_cutmix",
]


def smooth_one_hot(labels: torch.Tensor, num_classes: int, smoothing: float):
    """timm ``mixup_target`` smoothing: on = 1-s+s/C, off = s/C (float32)."""
    off = smoothing / num_classes
    on = 1.0 - smoothing + off
    hot = F.one_hot(labels.long(), num_classes).float()
    return hot * (on - off) + off


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  smoothing: float = 0.0) -> torch.Tensor:
    """Label-smoothing CE over integer labels (mean over batch)."""
    target = smooth_one_hot(labels, logits.shape[-1], smoothing)
    return soft_target_cross_entropy(logits, target)


def soft_target_cross_entropy(logits: torch.Tensor,
                              target: torch.Tensor) -> torch.Tensor:
    """CE against soft targets (timm SoftTargetCrossEntropy), in float32."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -(target.float() * logp).sum(-1).mean()


def _uniform(gen: torch.Generator) -> float:
    return float(torch.rand((), generator=gen))


def _beta(gen: torch.Generator, alpha: float) -> float:
    """One Beta(alpha, alpha) draw: torch's Beta sampler takes no
    generator, so a numpy stream seeded from ``gen`` draws it."""
    seed = int(torch.randint(0, 2**62, (), generator=gen))
    return float(np.random.default_rng(seed).beta(alpha, alpha))


def _rand_bbox(gen: torch.Generator, h: int, w: int, lam: float):
    """timm cutmix box: cut ratio sqrt(1-lam), clipped to the image."""
    ratio = math.sqrt(1.0 - lam)
    cut_h, cut_w = int(h * ratio), int(w * ratio)
    cy = int(torch.randint(0, h, (), generator=gen))
    cx = int(torch.randint(0, w, (), generator=gen))
    y1, y2 = min(max(cy - cut_h // 2, 0), h), min(max(cy + cut_h // 2, 0), h)
    x1, x2 = min(max(cx - cut_w // 2, 0), w), min(max(cx + cut_w // 2, 0), w)
    return y1, y2, x1, x2


def mixup_cutmix(
    gen: torch.Generator,
    images: torch.Tensor,  # b x c x h x w
    labels: torch.Tensor,  # b (int)
    num_classes: int,
    mixup_alpha: float = 0.8,
    cutmix_alpha: float = 1.0,
    prob: float = 1.0,
    switch_prob: float = 0.5,
    smoothing: float = 0.1,
    partner: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batch-mode mixup/cutmix (timm ``Mixup(mode='batch')``, JAX package
    ``losses.py:62-117``).

    Mixes each image with its batch-flip partner using one lambda per
    batch; when both alphas are on, a coin picks mixup or cutmix. Returns
    the mixed NCHW images and soft targets (already label-smoothed). The
    scalar draws come from ``gen`` (a CPU generator), so the images stay on
    their device. ``partner`` maps a batch tensor to its partner rows
    (default ``flip(0)``); under data parallelism it returns the mirror
    data rank's rows reversed, as JAX pairs ``images[::-1]`` of the global
    batch (``losses.py:96``).
    """
    partner = partner or (lambda t: t.flip(0))
    b, _, h, w = images.shape
    use_mix, use_cut = mixup_alpha > 0.0, cutmix_alpha > 0.0
    target = smooth_one_hot(labels, num_classes, smoothing)
    if not use_mix and not use_cut:
        return images, target

    apply = _uniform(gen) < prob
    do_cut = (_uniform(gen) < switch_prob) if (use_mix and use_cut) else use_cut
    alpha = cutmix_alpha if do_cut else mixup_alpha
    lam = _beta(gen, alpha) if apply else 1.0
    flipped = partner(images)
    if do_cut:
        y1, y2, x1, x2 = _rand_bbox(gen, h, w, lam)
        mixed = images.clone()
        mixed[:, :, y1:y2, x1:x2] = flipped[:, :, y1:y2, x1:x2]
        lam = 1.0 - (y2 - y1) * (x2 - x1) / float(h * w)
    else:
        mixed = images * lam + flipped * (1.0 - lam)
    target = target * lam + partner(target) * (1.0 - lam)
    return mixed.to(images.dtype), target
