"""Serving export (counterpart of the JAX package's ``ckpt/export.py``):
the eval forward as a ``torch.export`` program.

The program calls the fused kernels as the dispatcher ops
``mlaff::cluster_attention_fwd``, ``mlaff::cluster_merge_fwd`` and
``mlaff::layer_norm_fwd`` (on the card), and
holds the on-grid stage's clustering and the MaskFiner eval masks as
constants on the device it was traced on. Loading it needs the ops,
registered by importing this module (which imports the port's ``ops``
modules), and none of the port's model code.

Weights stay arguments, as in JAX: :func:`load_exported` returns a
function of a state dict and the images, so one artifact serves every
checkpoint of a config (a port checkpoint's model, or a reference ``.pth``
loaded into one). The artifact also holds the weights it was traced with,
which a call does not read.
"""

from __future__ import annotations

import io
import os
from typing import Callable, Optional

import torch

from ..ops import cluster_attention as _attention  # noqa: F401 (the ops)
from ..ops import cluster_merge as _merge  # noqa: F401
from ..ops import layer_norm as _layer_norm  # noqa: F401

__all__ = ["export_forward", "save_exported", "load_exported"]


def export_forward(model: torch.nn.Module, batch_size: int, img_size: int,
                   device: Optional[torch.device] = None) -> bytes:
    """Serialize ``model``'s eval forward of ``(batch_size, 3, img_size,
    img_size)`` float32 images, traced on ``device`` (default: where the
    model's parameters are; the model is moved there and put in eval
    mode), as ``torch.export.save`` bytes.

    One eager forward runs first: it fills the port's module-level caches
    (the grid constants, their tile metadata, the eval masks) with real
    tensors, so that the trace reads them as constants and never stores a
    traced tensor in them."""
    if device is None:
        device = next(model.parameters()).device
    model.to(device).eval()
    images = torch.zeros((batch_size, 3, img_size, img_size),
                         device=device)
    with torch.no_grad():
        model(images)
        program = torch.export.export(model, (images,), strict=False)
    program.example_inputs = None  # the zero images: not worth their bytes
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def save_exported(path: str, data: bytes) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)


def load_exported(path_or_bytes) -> Callable:
    """Deserialize an exported forward; returns ``fn(state_dict, images)``,
    which runs the program (without autograd) with the weights and buffers
    of ``state_dict`` (the model's ``state_dict()``; every key must be one
    of the program's) on ``images`` on the program's device."""
    if isinstance(path_or_bytes, (bytes, bytearray)):
        program = torch.export.load(io.BytesIO(bytes(path_or_bytes)))
    else:
        program = torch.export.load(path_or_bytes)
    module = program.module()

    def fn(state_dict, images):
        with torch.no_grad():
            return torch.func.functional_call(module, dict(state_dict),
                                              (images,), strict=True)

    return fn
