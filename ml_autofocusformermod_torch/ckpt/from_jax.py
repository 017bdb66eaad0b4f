"""Flax variables -> a torch ``state_dict`` for the port's modules.

Inverts the JAX package's ``ckpt/pth_import.py:79-154``: HWIO -> OIHW for
convs, (in, out) -> (out, in) for linears (``pos_embed`` included),
``scale`` -> ``weight``, ``mean``/``var`` -> ``running_mean``/``running_var``.
The key map is this module's own copy of ``pth_import._torch_key``. The
input is the ``{'params', 'batch_stats'}`` tree with numpy leaves, so this
module needs neither JAX nor flax.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from ..parallel.tp import shard_tensor

__all__ = ["state_dict_from_flax", "rank_state_dict_from_flax", "torch_key",
           "load_stacked_blocks"]

_SEG_MAP = {
    "weight_net_fc": "weight_net.0",
    "weight_net_norm": "weight_net.1",
}
# flax module names that flatten a nested torch container
_SEG_REGEX = [(r"layers_blocks_(\d+)", r"layers.blocks.\1")]
_LEAF_MAP = {
    "kernel": "weight",
    "scale": "weight",
    "bias": "bias",
    "mean": "running_mean",
    "var": "running_var",
}


def torch_key(path: Tuple[str, ...]) -> str:
    """Translate a flax variable path (collection dropped) to the torch key."""
    segs: List[str] = []
    for seg in path[:-1]:
        if seg in _SEG_MAP:
            segs.append(_SEG_MAP[seg])
            continue
        for pat, repl in _SEG_REGEX:
            m = re.fullmatch(pat, seg)
            if m:
                segs.append(m.expand(repl))
                break
        else:
            # list segments: layers_3 -> layers.3, blocks_0 -> blocks.0
            m = re.fullmatch(r"(.+)_(\d+)", seg)
            segs.append(f"{m.group(1)}.{m.group(2)}" if m else seg)
    segs.append(_LEAF_MAP.get(path[-1], path[-1]))
    return ".".join(segs)


def _leaves(tree: Mapping[str, Any], prefix=()) -> Iterator[Tuple[tuple, Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def state_dict_from_flax(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{'params': ..., 'batch_stats': ...}`` (numpy leaves) -> state_dict.

    Each BatchNorm also gets ``num_batches_tracked = 0``, so the result
    loads with a strict ``load_state_dict``. Raises if two flax leaves map
    to one torch key. Bare parameters (``blank_k``, ``rel_pos_emb``,
    ``register_tokens``, ``gamma1``, ...) keep their name and layout;
    depthwise conv kernels (H, W, 1, C) become (C, 1, H, W) like every
    conv.
    """
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection, {})):
            arr = np.asarray(leaf)
            if path[-1] == "kernel":
                if arr.ndim == 4:  # conv HWIO -> OIHW
                    arr = arr.transpose(3, 2, 0, 1)
                elif arr.ndim == 2:  # linear (in, out) -> (out, in)
                    arr = arr.T
            key = torch_key(path)
            if key in out:
                raise ValueError(f"two flax leaves map to {key}")
            out[key] = torch.from_numpy(np.array(arr))  # an owned, writable copy
            if collection == "batch_stats" and path[-1] == "mean":
                out[key[: -len("running_mean")] + "num_batches_tracked"] = (
                    torch.tensor(0, dtype=torch.long))
    return out


def rank_state_dict_from_flax(variables: Mapping[str, Any], specs: Mapping,
                              rank: int, size: int) -> Dict[str, torch.Tensor]:
    """One model rank's ``state_dict`` of a tensor-parallel model: the
    blocks that ``parallel/tp.py::plan`` (``specs``, at ``model`` size
    ``size``) gives rank ``rank`` of :func:`state_dict_from_flax`'s
    tensors, the rest whole. ZeRO-1 cuts no weight (only the optimizer's
    moments and the EMA, which start from zeros and the weights), so a data
    rank takes its model rank's dict as it is."""
    return {k: (shard_tensor(t, specs[k], rank, size) if k in specs else t)
            for k, t in state_dict_from_flax(variables).items()}


def _take(tree: Mapping[str, Any], i: int) -> Dict[str, Any]:
    """Entry ``i`` of the leading axis of every leaf of ``tree``."""
    return {k: (_take(v, i) if isinstance(v, Mapping) else np.asarray(v)[i])
            for k, v in tree.items()}


def load_stacked_blocks(blocks: Sequence[torch.nn.Module],
                        variables: Mapping[str, Any], first: int = 0) -> None:
    """Load flax variables of stacked blocks (the JAX package's
    ``parallel/pp.py::stack_block_params``: every leaf has a leading axis
    of ``L`` blocks; numpy leaves) into ``blocks``: ``blocks[j]`` takes
    block ``first + j``, through :func:`state_dict_from_flax`. The whole
    chain at ``first = 0``; a pipe rank's stage
    (``parallel/pp.py::stage_blocks``) at its first block. Raises when the
    leaves disagree on ``L``, when ``blocks`` reach past it, and on a leaf
    that a block lacks or a parameter that no leaf gives."""
    lengths = {int(np.shape(leaf)[0]) for collection in variables.values()
               for _, leaf in _leaves(collection)}
    if len(lengths) != 1:
        raise ValueError(f"stacked leaves of several lengths {lengths}")
    (L,) = lengths
    if first < 0 or first + len(blocks) > L:
        raise ValueError(f"blocks [{first}, {first + len(blocks)}) of a "
                         f"stack of {L}")
    for j, blk in enumerate(blocks):
        sd = state_dict_from_flax({k: _take(v, first + j)
                                   for k, v in variables.items()})
        want = set(blk.state_dict())
        missing, extra = sorted(want - set(sd)), sorted(set(sd) - want)
        if missing or extra:
            raise ValueError(f"block {first + j}: missing {missing}, "
                             f"unexpected {extra}")
        blk.load_state_dict(sd)
