"""The plain merge contraction (counterpart of ``wf_contract`` in the JAX
package's ``ops/clusten.py``)."""

from __future__ import annotations

import torch

__all__ = ["wf_contract"]


def wf_contract(weights: torch.Tensor, feat_g: torch.Tensor) -> torch.Tensor:
    """``out[b,n,ic,c] = sum_m weights[b,n,m,ic] * feat_g[b,n,m,c]``.

    Accumulates in float32 (float64 for float64 inputs) and returns
    ``weights``' dtype.
    """
    acc = torch.promote_types(weights.dtype, torch.float32)
    out = torch.einsum("bnmi,bnmc->bnic", weights.to(acc), feat_g.to(acc))
    return out.to(weights.dtype)
