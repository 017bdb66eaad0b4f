"""Upsampling-ratio curriculum for the MaskFiner family (a copy of the JAX
package's ``train/curriculum.py``).

The reference anneals every backbone's ``upscale_ratio`` from 1.0 to its
final value linearly over training (``main.py:231-235,472-476``) and
crashes for ``aff`` models, which have none. Here the curriculum applies
only to models exposing ``final_upsampling_ratios``; AFF has none, so the
training loop skips it. Ratios are quantized so that the number of distinct
token counts stays bounded. :func:`set_upsample_ratios` applies an epoch's
ratios to the live backbones, so that parameters, BatchNorm statistics and
the optimizer's state carry over (the JAX package rebuilds its model from
the config; the parameter shapes do not depend on the ratios).
"""

from __future__ import annotations

from typing import List, Sequence

__all__ = ["get_upsample_ratio", "epoch_upsample_ratios", "applies_to",
           "set_upsample_ratios"]


def get_upsample_ratio(final_ratio: float, n_epochs: int,
                       curr_epoch: int) -> float:
    """Linear 1.0 -> final anneal (reference ``main.py:472-476``)."""
    start = 1.0
    progress = curr_epoch / n_epochs
    return start + (final_ratio - start) * progress


def quantize(ratio: float, levels: int) -> float:
    """Snap a ratio to a 1/levels lattice."""
    if levels <= 0:
        return ratio
    return round(ratio * levels) / levels


def epoch_upsample_ratios(final_ratios: Sequence[float], n_epochs: int,
                          epoch: int, quantize_levels: int = 20) -> List[float]:
    """Per-backbone annealed (and quantized) ratios for this epoch."""
    out = []
    for r in final_ratios:
        if r == 0.0:
            out.append(0.0)  # non-upsampling levels stay off
            continue
        out.append(quantize(get_upsample_ratio(r, n_epochs, epoch),
                            quantize_levels))
    return out


def applies_to(model) -> bool:
    """True for models with an upsampling curriculum (MaskFiner wrappers)."""
    return hasattr(model, "final_upsampling_ratios")


def set_upsample_ratios(model, ratios: Sequence[float]) -> None:
    """Set each backbone's ``upscale_ratio`` of a MaskFiner wrapper. A
    level that does not upsample (ratio 0) must stay at 0: its split
    parameters do not exist."""
    backbones = list(model.backbones)
    if len(ratios) != len(backbones) or any(
            (bb.upscale_ratio == 0.0) != (r == 0.0)
            for bb, r in zip(backbones, ratios)):
        raise ValueError(f"ratios {list(ratios)} do not fit the levels' "
                         f"{[bb.upscale_ratio for bb in backbones]}")
    for bb, r in zip(backbones, ratios):
        bb.upscale_ratio = float(r)
