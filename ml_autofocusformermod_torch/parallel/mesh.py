"""Process groups over a ``(data, model, seq)`` layout (counterpart of the
JAX package's ``parallel/mesh.py`` and of its ``main.py:70-74``
multi-host start).

:func:`init_distributed` starts ``torch.distributed`` from torchrun's
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and, for
``env://``, ``MASTER_ADDR`` / ``MASTER_PORT``); without ``WORLD_SIZE`` the
process stays alone and no collective ever runs. :func:`make_mesh` lays the
ranks out as ``arange(world).reshape(data, model, seq)``, ``seq``
innermost, as the JAX mesh lays out its devices, and makes one process
group per axis line, and one per ``(data, seq)`` plane (the ranks that
hold one model rank's parameters: the gradient's mean runs over it). The
mesh of the running program is ambient, as a JAX mesh in context is:
``parallel/zero.py::make_layout`` installs the mesh of the layout it makes
(:func:`set_mesh`), :func:`current` reads it (None when there is none),
and the model's batch-wide reductions and per-image draws consult it
through :mod:`.comm`.

``shard_batch`` has no counterpart: each data rank loads its own shard of
the batch (``build_loaders(config, host=data_rank, num_hosts=data)``), so
the global batch is the concatenation of the data ranks' batches in rank
order, as JAX's ``make_array_from_process_local_data`` assembles it.
``shard_tokens`` (the ``seq`` axis) is :func:`token_range`: a rank of
seq rank ``s`` holds the tokens ``[n s / seq, n (s + 1) / seq)`` of every
stage of ``n`` tokens (rounded down), the rows JAX's constraint puts on
that device when ``seq`` divides ``n``; ``parallel/comm.py`` slices and
gathers them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "init_distributed", "make_mesh", "set_mesh", "current",
           "destroy", "default_backend", "token_range"]


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the layout: the axis sizes, its coordinates and
    the process group of each axis line through it (None for an axis of
    one rank, where nothing is communicated); ``replica_group`` holds the
    ``data x seq`` ranks of its model rank (the data group when ``seq`` is
    1)."""

    data: int
    model: int
    seq: int
    rank: int
    data_rank: int
    model_rank: int
    data_group: Optional[object] = None
    model_group: Optional[object] = None
    seq_rank: int = 0
    seq_group: Optional[object] = None
    replica_group: Optional[object] = None

    @property
    def world(self) -> int:
        return self.data * self.model * self.seq


def default_backend(device) -> str:
    """``nccl`` for a CUDA device, ``gloo`` for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_distributed(device, backend: Optional[str] = None,
                     init_method: str = "env://",
                     env: Mapping[str, str] = os.environ
                     ) -> Tuple[int, int, int]:
    """``(rank, world, local_rank)``; starts the default process group when
    ``env`` holds ``WORLD_SIZE`` (torchrun's environment) and the group is
    not up yet. ``backend`` defaults to :func:`default_backend` of
    ``device``; a backend is never chosen after a failure. Without
    ``WORLD_SIZE`` it returns ``(0, 1, 0)`` and starts nothing."""
    if "WORLD_SIZE" not in env:
        return 0, 1, 0
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    if not dist.is_initialized():
        dist.init_process_group(backend or default_backend(device),
                                init_method=init_method, rank=rank,
                                world_size=world)
    return rank, world, local_rank


def make_mesh(data: int = -1, model: int = 1, seq: int = 1) -> Mesh:
    """The ``(data, model, seq)`` mesh over the default process group's
    ranks (one rank when none is up). ``data=-1`` takes every rank that
    ``model * seq`` leaves; the sizes must multiply to the world, as JAX
    ``mesh.py:48-53`` asserts. Every rank must call it, in the same order,
    since it creates the groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data == -1:
        if world % (model * seq):
            raise ValueError(f"{world} ranks not divisible by "
                             f"model*seq={model * seq}")
        data = world // (model * seq)
    if data * model * seq != world:
        raise ValueError(f"mesh {data}x{model}x{seq} != {world} ranks")
    arr = np.arange(world).reshape(data, model, seq)
    d, m, s = (int(i[0]) for i in np.nonzero(arr == rank))
    data_group = model_group = seq_group = replica_group = None
    # every rank creates every group, in one order (torch.distributed's rule)
    if data > 1:
        for mm in range(model):
            for ss in range(seq):
                g = dist.new_group([int(r) for r in arr[:, mm, ss]])
                if (mm, ss) == (m, s):
                    data_group = g
    if model > 1:
        for dd in range(data):
            for ss in range(seq):
                g = dist.new_group([int(r) for r in arr[dd, :, ss]])
                if (dd, ss) == (d, s):
                    model_group = g
    if seq > 1:
        for dd in range(data):
            for mm in range(model):
                g = dist.new_group([int(r) for r in arr[dd, mm, :]])
                if (dd, mm) == (d, m):
                    seq_group = g
        if data > 1:
            for mm in range(model):
                g = dist.new_group([int(r) for r in arr[:, mm, :].ravel()])
                if mm == m:
                    replica_group = g
        else:
            replica_group = seq_group
    else:
        replica_group = data_group
    return Mesh(data, model, seq, rank, d, m, data_group, model_group, s,
                seq_group, replica_group)


def token_range(n: int, seq: int, seq_rank: int) -> Tuple[int, int]:
    """``(lo, hi)``: the tokens of ``n`` that seq rank ``seq_rank`` of
    ``seq`` holds (the counterpart of JAX's ``shard_tokens``; contiguous,
    in rank order, sizes differing by at most one)."""
    return n * seq_rank // seq, n * (seq_rank + 1) // seq


_CURRENT: Optional[Mesh] = None


def set_mesh(mesh: Optional[Mesh]) -> None:
    """Install ``mesh`` as the running program's (None removes it)."""
    global _CURRENT
    _CURRENT = mesh


def current() -> Optional[Mesh]:
    """The installed mesh, or None."""
    return _CURRENT


def destroy() -> None:
    """Remove the mesh and end the default process group, if one is up."""
    set_mesh(None)
    if dist.is_initialized():
        dist.destroy_process_group()
