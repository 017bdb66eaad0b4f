"""AutoFocusFormer in PyTorch with hand-written CUDA kernels for Hopper.

The PyTorch port of :mod:`ml_autofocusformermod_tpu`. It imports torch,
numpy and the standard library only: never JAX and never the JAX package.
Module names mirror the JAX package, and ``state_dict()`` keys equal the
reference torch model's, so a reference ``.pth`` loads with plain
``load_state_dict``.

Entry points run on ``cuda`` unless the caller asks for ``cpu``; with no
GPU and no explicit ``cpu`` they raise (:func:`resolve_device`). On a CUDA
tensor each kernel wrapper launches its CUDA kernel (built from ``csrc/`` at
first use) or raises; on a CPU tensor it runs its plain PyTorch version.
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``torch.device(device)`` (``cuda``, ``cuda:N`` or ``cpu``), refusing
    CUDA when no GPU is visible and an index past the visible cards."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run the plain CPU path"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    if (dev.type == "cuda" and dev.index is not None
            and dev.index >= torch.cuda.device_count()):
        raise RuntimeError(f"device {device!r}: only "
                           f"{torch.cuda.device_count()} CUDA devices")
    return dev
