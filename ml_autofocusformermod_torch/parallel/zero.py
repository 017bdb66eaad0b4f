"""ZeRO-1: the AdamW moments and the EMA sharded over the ``data`` axis
(counterpart of the JAX package's ``parallel/zero.py``), on top of the
tensor-parallel layout, and the :class:`Layout` that the trainer, the
optimizer and the checkpoints read.

As ``zero1_spec_for_path`` has it, a moment or EMA leaf of a parameter is
cut on its first dimension, in the flax order of its dims
(``tp.jax_dim_order``), that tensor parallelism leaves free and that
divides by the data size; a leaf with none stays replicated. The EMA of
the BatchNorm buffers (JAX's ``ema_batch_stats``) is never cut. The
parameters and gradients stay replicated over ``data``: each data rank
updates its block of the moments and computes its block of the update,
then the ranks all-gather the update (one flat collective per step), so
every rank ends the step with the same parameters. ``TPU.ZERO1`` turns it on.
The seq ranks of a data rank hold the same blocks: ZeRO-1 cuts over ``data``
only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional

import torch

from . import comm, tp
from .mesh import Mesh, set_mesh

__all__ = ["Layout", "zero1_dim", "zero1_plan", "make_layout", "block",
           "gather_update"]


@dataclass
class Layout:
    """How one rank holds the train state: ``tp`` maps the parameters
    sharded over the model axis to their ``(dim, parts)``; ``zero`` maps
    the parameters whose moments and EMA are cut over the data axis to
    that dim."""

    mesh: Mesh
    tp: Dict[str, tp.Spec] = field(default_factory=dict)
    zero: Dict[str, int] = field(default_factory=dict)

    @property
    def data_group(self):
        return self.mesh.data_group

    @property
    def model_group(self):
        return self.mesh.model_group

    @property
    def replica_group(self):
        """The data x seq ranks that hold this rank's parameters."""
        return self.mesh.replica_group


def zero1_dim(key: str, shape, tp_spec: Optional[tp.Spec],
              data: int) -> Optional[int]:
    """The dim that ZeRO-1 cuts the moments and EMA of parameter ``key``
    (full ``shape``) on, or None (JAX ``zero.py:36-55``)."""
    if data <= 1:
        return None
    taken = tp_spec[0] if tp_spec else None
    for dim in tp.jax_dim_order(key, len(shape)):
        if dim != taken and shape[dim] % data == 0 and shape[dim] >= data:
            return dim
    return None


def zero1_plan(shapes: Mapping[str, tuple], tp_specs: Mapping[str, tp.Spec],
               data: int) -> Dict[str, int]:
    """``{parameter: dim}`` of every parameter ZeRO-1 cuts."""
    out = {}
    for key, shape in shapes.items():
        dim = zero1_dim(key, shape, tp_specs.get(key), data)
        if dim is not None:
            out[key] = dim
    return out


def make_layout(model: torch.nn.Module, mesh: Mesh, zero1: bool) -> Layout:
    """Shard ``model`` in place over the mesh's model axis
    (``tp.shard_model``) and plan ZeRO-1 over its data axis when
    ``zero1``; the :class:`Layout` of the result. Installs ``mesh`` as the
    running program's (``mesh.set_mesh``), which the model's batch-wide
    reductions read, so that they and the layout cannot disagree."""
    specs = tp.shard_model(model, mesh.model, mesh.model_rank,
                           mesh.model_group)
    zero = {}
    if zero1:
        zero = zero1_plan({k: tuple(p.shape)
                           for k, p in model.named_parameters()},
                          specs, mesh.data)
    set_mesh(mesh)
    return Layout(mesh, specs, zero)


def block(t: torch.Tensor, dim: int, mesh: Mesh) -> torch.Tensor:
    """This data rank's block of ``t`` along ``dim`` (a view)."""
    return t.chunk(mesh.data, dim=dim)[mesh.data_rank]


@torch.no_grad()
def gather_update(blocks: Mapping[str, torch.Tensor],
                  dims: Mapping[str, int], group) -> Dict[str, torch.Tensor]:
    """Every data rank's blocks of the same names, put back together along
    their dims: one flat all-gather for all of them."""
    names = list(blocks)
    flat = torch.cat([blocks[k].reshape(-1) for k in names])
    rows = comm.all_gather(flat[None], group, dim=0)  # (W, total)
    out, off = {}, 0
    for k in names:
        b = blocks[k]
        pieces = [row[off:off + b.numel()].view(b.shape) for row in rows]
        out[k] = torch.cat(pieces, dim=dims[k])
        off += b.numel()
    return out
