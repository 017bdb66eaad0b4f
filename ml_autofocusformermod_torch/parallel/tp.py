"""Tensor parallelism over the mesh ``model`` axis (counterpart of the JAX
package's ``parallel/tp.py``).

The JAX package's Megatron rules, on the port's ``state_dict`` keys (the
flax paths of ``ckpt/from_jax.py::torch_key``, with torch's ``(out, in)``
linear and ``OIHW`` conv layouts):

* column-parallel ``attn.q``, ``attn.kv``, ``attn.qkv``, ``mlp.fc1`` and
  the MixResViT ``mlp.dwconv.dwconv``: their outputs are sharded;
* head-sharded ``attn.pos_embed`` and ``attn.blank_k`` / ``blank_v``;
* row-parallel ``attn.proj`` and ``mlp.fc2`` (weight only: the bias is
  added once, after the all-reduce);
* everything else replicated.

The port decides per layer, where JAX decides per leaf: a
``ClusterAttention`` or MixResViT ``Attention`` is sharded when its heads
divide by the ``model`` size (so every rank holds whole heads, and calls
the attention kernel on its ``h/tp`` heads), an ``Mlp`` or
``FeedForward`` when its hidden width does; otherwise the whole layer stays
replicated. ``q`` and ``kv`` are head-major (``(h, c_)`` and ``(h, 2,
c_)`` columns), so a contiguous block of rows is whole heads; MixResViT's
``qkv`` is laid out ``(3, h, c_)``, so a rank takes its heads' rows of each
of q, k and v (``parts`` 3), where JAX's column split hands XLA half-heads
to reshard. A sharded layer takes Megatron's f at its input and g after its
row-parallel product (:mod:`.comm`).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Mapping, Tuple

import torch
import torch.nn as nn

from ..models.layers import ClusterAttention, Mlp
from ..models.mixres_vit import Attention, FeedForward
from . import comm

__all__ = ["RULES", "spec_for_key", "plan", "shard_model", "shard_tensor",
           "unshard", "jax_dim_order", "global_norm"]

# (key regex, sharded torch dim, interleaved parts). First match wins.
RULES = (
    (re.compile(r"attn\.(q|kv)\.(weight|bias)$"), 0, 1),
    (re.compile(r"attn\.qkv\.(weight|bias)$"), 0, 3),
    (re.compile(r"attn\.pos_embed\.(weight|bias)$"), 0, 1),
    (re.compile(r"attn\.blank_[kv]$"), 0, 1),
    (re.compile(r"attn\.proj\.weight$"), 1, 1),
    (re.compile(r"mlp\.fc1\.(weight|bias)$"), 0, 1),
    (re.compile(r"mlp\.dwconv\.dwconv\.(weight|bias)$"), 0, 1),
    (re.compile(r"mlp\.fc2\.weight$"), 1, 1),
)

Spec = Tuple[int, int]  # (sharded dim, interleaved parts)


def spec_for_key(key: str, shape, tp: int):
    """The leaf's rule ``(dim, parts)`` when it has one and its dim divides
    by ``tp`` into whole parts, else None (replicated)."""
    if tp <= 1:
        return None
    for rx, dim, parts in RULES:
        if rx.search(key):
            if dim < len(shape) and shape[dim] % (tp * parts) == 0:
                return dim, parts
            return None
    return None


def _layers(model: nn.Module):
    for name, mod in model.named_modules():
        if isinstance(mod, (ClusterAttention, Attention)):
            yield name, mod, mod.num_heads if isinstance(
                mod, ClusterAttention) else mod.heads
        elif isinstance(mod, (Mlp, FeedForward)):
            yield name, mod, mod.fc1.weight.shape[0]


def _sharded_layers(model: nn.Module, tp: int):
    """``(name, layer, {key: spec})`` of each layer that shards at ``tp``."""
    for name, mod, units in _layers(model):
        if units % tp:
            continue
        specs = {key: spec_for_key(key, p.shape, tp)
                 for key, p in mod.named_parameters(prefix=name)
                 if any(rx.search(key) for rx, _, _ in RULES)}
        if specs and all(s is not None for s in specs.values()):
            yield name, mod, specs


def plan(model: nn.Module, tp: int) -> Dict[str, Spec]:
    """``{parameter name: (dim, parts)}`` of the leaves ``model`` shards at
    ``model`` size ``tp``: every rule leaf of each layer whose heads (or
    hidden width) divide by ``tp``, and whose leaves all do."""
    if tp <= 1:
        return {}
    return {k: s for _, _, specs in _sharded_layers(model, tp)
            for k, s in specs.items()}


def shard_tensor(full: torch.Tensor, spec: Spec, rank: int,
                 size: int) -> torch.Tensor:
    """Rank ``rank``'s block of ``full`` (a copy) under ``spec``."""
    dim, parts = spec
    t = full.unflatten(dim, (parts, -1))
    return t.chunk(size, dim=dim + 1)[rank].flatten(dim, dim + 1).clone()


def unshard(blocks: Iterable[torch.Tensor], spec: Spec) -> torch.Tensor:
    """The full tensor from every rank's block, in rank order."""
    dim, parts = spec
    return torch.cat([b.unflatten(dim, (parts, -1)) for b in blocks],
                     dim=dim + 1).flatten(dim, dim + 1)


@torch.no_grad()
def shard_model(model: nn.Module, tp: int, rank: int,
                group) -> Dict[str, Spec]:
    """Shard ``model``'s layers in place for ``model`` rank ``rank`` of
    ``tp`` (:func:`plan`): each sharded parameter becomes its block, each
    sharded layer keeps its local head count and ``tp_group``. Returns the
    plan (full-model names)."""
    if tp <= 1:
        return {}
    layers = list(_sharded_layers(model, tp))
    specs: Dict[str, Spec] = {}
    for name, mod, layer_specs in layers:
        for key, spec in layer_specs.items():
            owner_name, leaf = key.rsplit(".", 1)
            owner = model.get_submodule(owner_name)
            block = shard_tensor(getattr(owner, leaf).detach(), spec, rank,
                                 tp)
            setattr(owner, leaf, nn.Parameter(block))
        specs.update(layer_specs)
        mod.tp_group = group
        if isinstance(mod, ClusterAttention):
            mod.num_heads //= tp
        elif isinstance(mod, Attention):
            mod.heads //= tp
    return specs


def jax_dim_order(key: str, ndim: int) -> Tuple[int, ...]:
    """The torch dims of a leaf in the order of its flax dims (a linear's
    ``(out, in)`` is flax ``(in, out)``; a conv's OIHW is flax HWIO; bare
    parameters keep their order), as ``ckpt/from_jax.py`` transposes."""
    if key.endswith(".weight") and ndim == 2:
        return (1, 0)
    if key.endswith(".weight") and ndim == 4:
        return (2, 3, 1, 0)
    return tuple(range(ndim))


def global_norm(grads: Mapping[str, torch.Tensor], sharded: Iterable[str],
                group) -> torch.Tensor:
    """``optax.global_norm`` of the full gradients from this rank's blocks:
    the squares of the sharded leaves summed over ``group`` (each counted
    once), the replicated leaves' added once."""
    sharded = set(sharded)
    rep = [g for k, g in grads.items() if k not in sharded]
    sh = [g for k, g in grads.items() if k in sharded]
    zero = next(iter(grads.values())).new_zeros(())
    sq_rep = sum((torch.sum(g * g) for g in rep), zero)
    sq_sh = sum((torch.sum(g * g) for g in sh), zero)
    return torch.sqrt(sq_rep + comm.all_reduce(sq_sh, group))
