"""Load reference torch ``.pth`` checkpoints into the port's models
(counterpart of the JAX package's ``ckpt/pth_import.py``).

The port's ``state_dict()`` keys and layouts are the reference torch
model's, so no key map and no transpose is needed. Loading is
``strict=False`` like the reference (``utils.py:31``) and the JAX import:
keys of the model that the file lacks are reported as missing, keys of the
file that the model lacks as unexpected, neither is fatal. A key present in
both with another shape raises, so a 1000-class head never loads into a
10-class model. BatchNorm's ``num_batches_tracked`` has no counterpart in
the JAX package's variables: it is never reported, as missing or as
unexpected.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .io import local_state_dict

__all__ = ["load_pth_state_dict", "import_reference_state_dict",
           "load_reference_weights"]

_STEP_COUNTER = "num_batches_tracked"


def load_pth_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a torch checkpoint file, on the CPU.

    Accepts a bare ``state_dict`` and the reference trainer's wrapper
    ``{'model': state_dict, ...}`` (``utils.py:58-69``). A URL raises
    ``ValueError``: the port downloads nothing (the JAX package's download
    branch is not ported); fetch the file and pass its path. The file is
    unpickled in full (``weights_only=False``, as the reference trainer's
    wrapper holds its config object), so load only files you trust.
    """
    if path.startswith(("http://", "https://")):
        raise ValueError(
            f"{path!r} is a URL: the port loads local files only; download "
            "the checkpoint and pass its path")
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and "model" in ckpt:
        ckpt = ckpt["model"]
    return {k: v.detach() for k, v in ckpt.items()}


def import_reference_state_dict(model: torch.nn.Module,
                                state_dict: Dict[str, torch.Tensor]
                                ) -> Tuple[List[str], List[str]]:
    """Copy ``state_dict`` into ``model`` in place (strict=False).

    Each value is cast to the model tensor's dtype and copied to its
    device. Returns ``(missing, unexpected)``: the model's keys the file
    lacks, and the file's keys the model never took, both without
    ``num_batches_tracked``. Raises ``ValueError`` on a shape mismatch.
    """
    missing: List[str] = []
    consumed = set()
    with torch.no_grad():
        for key, target in model.state_dict(keep_vars=True).items():
            if key not in state_dict:
                if not key.endswith(_STEP_COUNTER):
                    missing.append(key)
                continue
            src = torch.as_tensor(state_dict[key])
            if tuple(src.shape) != tuple(target.shape):
                raise ValueError(
                    f"shape mismatch for {key}: checkpoint "
                    f"{tuple(src.shape)} vs model {tuple(target.shape)}")
            target.copy_(src.to(target.dtype))
            consumed.add(key)
    unexpected = [k for k in state_dict
                  if k not in consumed and not k.endswith(_STEP_COUNTER)]
    return missing, unexpected


def load_reference_weights(path: str, model: torch.nn.Module, layout=None
                           ) -> Tuple[List[str], List[str]]:
    """:func:`load_pth_state_dict` then :func:`import_reference_state_dict`
    into ``model`` (this rank's blocks of it under ``layout``, a
    ``parallel/zero.py::Layout``); returns ``(missing, unexpected)``."""
    state_dict = local_state_dict(load_pth_state_dict(path), layout)
    return import_reference_state_dict(model, state_dict)
