"""The plain reference of the benchmark's models, in plain PyTorch and
float32 with TF32 off.

It imports nothing of the measured package and takes nothing it made:
the benchmark hands it the weights and inputs it generated itself, and it
works the clustering, the neighbour lists and the upsampling masks out
again. :func:`build` makes a model from a configuration file's ``model``
block; ``precision="fp8"`` makes the correctness control. The block's
``ref_query_chunk``, where it has one, sets the queries per checkpointed
chunk of the local attention, so that a large model's replay fits.
"""

from __future__ import annotations

import torch

from .aff import AutoFocusFormer
from .maskfiner import UpDown
from .precision import Precision

__all__ = ["build", "no_tf32"]


def no_tf32() -> None:
    """Keep float32 products in float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def build(model_cfg: dict, precision: str = "float32",
          mask_seed: int = 0) -> torch.nn.Module:
    """The reference model of ``model_cfg`` (a configuration file's
    ``model`` block) in eval mode, parameters zero until a state dict is
    loaded."""
    prec = Precision(precision)
    kind = model_cfg["type"]
    chunk = int(model_cfg.get("ref_query_chunk", 0))
    if kind == "aff":
        return AutoFocusFormer(model_cfg["arch"], prec, chunk).eval()
    if kind == "maskfinerUD":
        return UpDown(model_cfg["mr"], model_cfg["num_classes"],
                      model_cfg["upscale_ratios"], prec, mask_seed,
                      chunk).eval()
    raise ValueError(f"model type {kind!r} has no reference")
