"""Model complexity reporting (counterpart of the JAX package's
``utils/flops.py``): torch's ``FlopCounterMode`` instead of XLA's cost
analysis.

The reference prints ptflops MACs at startup (``main.py:108-111``); the JAX
package reports the compiled forward's cost analysis. Here the count is
``FlopCounterMode``'s over one eval forward of the model that runs: two
flops per multiply-add of every product the dispatcher sees (matmuls,
convolutions), and the fused kernels through the formulas registered
below, which count their matmul work as the plain versions compute it.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

from ..ops import cluster_attention as _attention  # noqa: F401 (the ops)
from ..ops import cluster_merge as _merge  # noqa: F401

__all__ = ["count_params", "model_complexity", "attention_flops",
           "merge_flops"]


def count_params(model: torch.nn.Module) -> int:
    """The number of parameter entries of ``model``."""
    return sum(p.numel() for p in model.parameters())


def attention_flops(q_shape, ncc_shape, num_heads: int, cs: int) -> int:
    """The flops of the attention forward as its plain version computes
    them: per query, the rel-pos bias (5 features x h heads) and q.k over
    its ``m = nnc * cs`` slots, q against the blank key, and P.V over the
    slots (the blank value's weighting is elementwise)."""
    b, n, c = q_shape
    m = ncc_shape[-1] * cs
    return 2 * b * n * (5 * num_heads * m + 2 * c * m + c)


def merge_flops(weights_shape, feat_shape) -> int:
    """The flops of the merge forward: the weights . features contraction
    over each centre's ``m`` slots, ``(b, n', m, ic) x (b, n', m, c)``."""
    b, n_, m, ic = weights_shape
    return 2 * b * n_ * m * ic * feat_shape[-1]


@register_flop_formula(torch.ops.mlaff.cluster_attention_fwd)
def _attention_formula(q, kv, ncc, pos, *args, out_shape=None, **kwargs):
    num_heads, cs = args[7], args[8]
    return attention_flops(q, ncc, num_heads, cs)


@register_flop_formula(torch.ops.mlaff.cluster_merge_fwd)
def _merge_formula(weights, feat, ncc, cluster_size, out_shape=None,
                   **kwargs):
    return merge_flops(weights, feat)


def model_complexity(model: torch.nn.Module, img_size: int,
                     batch: int = 1) -> Dict[str, float]:
    """Count one eval forward of ``batch`` zero images of ``img_size``² on
    the model's device.

    Returns ``flops`` per image (``FlopCounterMode``), ``bytes_accessed``
    per image (NaN: torch has no cost analysis, and JAX returns NaN where
    its backend reports none), ``peak_bytes`` (on the card the forward's
    own high-water mark of allocated memory above what was allocated
    before it, plus its arguments, the weights and the images, as JAX
    counts a compiled program's; NaN on the CPU) and ``params``. The model
    is left in eval mode."""
    device = next(model.parameters()).device
    x = torch.zeros((batch, 3, img_size, img_size), device=device)
    cuda = device.type == "cuda"
    model.eval()
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(x)
    peak = float("nan")
    if cuda:
        torch.cuda.synchronize(device)
        arguments = x.nbytes + sum(t.nbytes for t in (
            *model.parameters(), *model.buffers()))
        peak = float(torch.cuda.max_memory_allocated(device) - before
                     + arguments)
    return {"flops": counter.get_total_flops() / batch,
            "bytes_accessed": float("nan"), "peak_bytes": peak,
            "params": count_params(model)}
