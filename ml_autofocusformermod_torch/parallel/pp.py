"""GPipe pipeline parallelism over a ``pipe`` axis of processes
(counterpart of the JAX package's ``parallel/pp.py``).

A library, as JAX's is: no entry point, config key or switch reaches it.
It runs a uniform residual chain of blocks, such as AFF stage 3's six
``ClusterTransformerBlock``s (all of one shape), over ``P`` pipe ranks,
each holding a contiguous chunk of the blocks (:func:`stage_blocks`).

Schedule (:func:`pipeline_blocks`): the batch is cut into ``M``
microbatches and run in ``M + P - 1`` steps. At step ``t`` stage ``p``
holds microbatch ``t - p``: stage 0 injects microbatch ``t``, the last
stage collects microbatch ``t - (P - 1)``, and between steps every stage
hands its state to stage ``(p + 1) % P`` (:func:`.comm.shift`). A stage
whose microbatch index lies outside ``[0, M)`` is in the bubble: it
skips the blocks and hands on zeros, since the result would be discarded
(JAX runs them on stale states and masks them out; skipping gives the
same result and no NaN can reach a parameter's gradient through a zero
cotangent). Each stage thus runs its blocks on ``M`` microbatches; the
bubble is ``(P - 1) / (M + P - 1)`` of the steps. The backward is
autograd through the same schedule: each hand-off's backward is the
reverse shift.

Every rank issues the same collectives in the same order, forward and
backward, whatever stage it is: ``M + P - 2`` shifts, then the
replication of the output. In the backward, autograd would run a
shift's backward only where something read what it handed on, and in an
order that follows each rank's own graph; so the shifts are threaded on
one chain of 0-dim tokens, from the input to the output
(:func:`.comm.shift`'s ``token``), which makes every rank run every
shift's backward, the last first.

The gradient rule (``parallel/__init__.py``): every pipe rank computes the
loss whole on the replicated output. The last stage's collected outputs
are replicated with :func:`.comm.reduce_from_model` (all-reduce forward,
identity backward: a sum's backward would hand the chain ``P`` times its
gradient), and ``x`` enters through :func:`.comm.copy_to_model`
(identity forward, all-reduce backward), so every pipe rank gets ``x``'s
whole gradient, which only stage 0's injections receive. Each stage's
block gradients live on its own pipe rank; on a ``(data, pipe)`` layout
the data ranks of a pipe rank average them over the data line
(:func:`.comm.all_reduce_mean_` over ``PipeMesh.data_group``), as data
parallelism does.

The chain must not draw randomness while training (Dropout, DropPath,
attention dropout above 0): JAX's ``block_fn`` takes no key, and a
pipelined draw would differ from the sequential one. The mesh is not the
ambient ``(data, model, seq)`` mesh (``parallel/mesh.py::set_mesh``), so
the blocks' own collectives stay no-ops.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn

from ..models.layers import Dropout, DropPath
from . import comm

__all__ = ["PIPE_AXIS", "PipeMesh", "make_pipe_mesh", "stage_blocks",
           "pipeline_blocks", "sequential_blocks"]

PIPE_AXIS = "pipe"


@dataclass(frozen=True)
class PipeMesh:
    """One rank's view of a ``(data, pipe)`` layout: the sizes, its
    coordinates and the process group of each axis line through it (None
    for an axis of one rank)."""

    data: int
    pipe: int
    rank: int
    data_rank: int
    pipe_rank: int
    data_group: Optional[object] = None
    pipe_group: Optional[object] = None


def make_pipe_mesh(pipe: int, data: int = 1) -> PipeMesh:
    """The ``(data, pipe)`` mesh over the default process group's ranks
    (one rank when none is up), laid out as ``arange(world).reshape(data,
    pipe)``, ``pipe`` innermost as JAX lays out its devices. Raises when
    ``data * pipe`` is not the world. Every rank must call it, in the same
    order, since it creates the groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data * pipe != world:
        raise ValueError(f"mesh {data}x{pipe} != {world} ranks")
    arr = np.arange(world).reshape(data, pipe)
    d, p = (int(i[0]) for i in np.nonzero(arr == rank))
    data_group = pipe_group = None
    # every rank creates every group, in one order (torch.distributed's rule)
    if pipe > 1:
        for dd in range(data):
            g = dist.new_group([int(r) for r in arr[dd]])
            if dd == d:
                pipe_group = g
    if data > 1:
        for pp in range(pipe):
            g = dist.new_group([int(r) for r in arr[:, pp]])
            if pp == p:
                data_group = g
    return PipeMesh(data, pipe, rank, d, p, data_group, pipe_group)


def stage_blocks(blocks: Sequence, mesh: PipeMesh) -> Sequence:
    """This pipe rank's stage of the chain ``blocks`` (or of anything
    indexed like it, such as the blocks' state dicts): the contiguous chunk
    ``[p L / P, (p + 1) L / P)`` of its ``L`` entries (JAX's
    ``stack_block_params`` with the ``pipe`` sharding of its leading axis).
    Raises when ``P`` does not divide ``L``."""
    n, nstage = len(blocks), mesh.pipe
    if n == 0 or n % nstage:
        raise ValueError(f"{n} blocks not divisible by {nstage} stages")
    chunk = n // nstage
    return blocks[mesh.pipe_rank * chunk:(mesh.pipe_rank + 1) * chunk]


def _draws(stage: Sequence) -> List[str]:
    """The modules of ``stage`` that would draw randomness now."""
    out = []
    for i, blk in enumerate(stage):
        if not isinstance(blk, nn.Module):
            continue
        for name, m in blk.named_modules():
            rate = (m.p if isinstance(m, (Dropout, nn.modules.dropout
                                          ._DropoutNd))
                    else m.rate if isinstance(m, DropPath) else 0.0)
            if m.training and rate > 0.0:
                out.append(f"{i}.{name}" if name else str(i))
    return out


def _micro(c, b: int, M: int) -> list:
    """The ``M`` microbatches of a const: a tensor whose leading axis is
    the batch ``b`` cut along it, one whose leading axis is 1 (broadcast
    over the batch) whole; a tuple (or NamedTuple, such as a
    ``TileMeta``) field by field."""
    if isinstance(c, torch.Tensor):
        if c.ndim and c.shape[0] == 1:
            return [c] * M
        if c.ndim and c.shape[0] == b:
            return list(c.split(b // M))
        raise ValueError(f"const of shape {tuple(c.shape)}: its leading "
                         f"axis is neither the batch {b} nor 1")
    if isinstance(c, tuple):
        fields = zip(*(_micro(f, b, M) for f in c))
        make = (lambda fs: type(c)(*fs)) if hasattr(c, "_fields") else tuple
        return [make(fs) for fs in fields]
    raise TypeError(f"a const is a tensor or a tuple of tensors, not "
                    f"{type(c).__name__}: bind it into block_fn")


class _Join(torch.autograd.Function):
    """``a`` as it is, with ``b`` joined into its graph: autograd runs back
    through ``b`` (with a zero gradient) whenever it runs back through
    ``a``."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.like = (b.shape, b.dtype, b.device)
        return a.view_as(a)

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.like
        return grad, torch.zeros(shape, dtype=dtype, device=device)


def pipeline_blocks(block_fn: Callable, stage: Sequence, x: torch.Tensor,
                    consts: Sequence = (), *, mesh: PipeMesh,
                    num_microbatches: int) -> torch.Tensor:
    """``x -> block_fn(blocks[L-1], ... block_fn(blocks[0], x, *consts))``
    pipelined over ``mesh``'s pipe ranks (the module docstring has the
    schedule); the full-batch output on every pipe rank.

    Args:
      block_fn: ``(block, x_micro, *consts_micro) -> y_micro``, ``y_micro``
        of ``x_micro``'s shape and dtype (a uniform residual chain).
        Arguments that are not per-example tensors (``global_attn``,
        ``cluster_size``) are bound into it by the caller.
      stage: this rank's blocks, :func:`stage_blocks` of the chain (which
        refuses a chain that the pipe ranks do not divide).
      x: this data rank's batch, leading axis ``b``, cut into
        ``num_microbatches`` equal microbatches.
      consts: per-example tensors shared by every block (neighbour
        indices, positions), and tuples of them (a ``TileMeta``): a
        leading axis ``b`` is microbatched alongside ``x``, a leading axis
        of 1 is broadcast and passed whole.

    Raises when ``num_microbatches`` does not divide ``b`` and when a
    block of the stage would draw randomness (training mode with Dropout,
    DropPath or attention dropout above 0).
    """
    b, M = x.shape[0], num_microbatches
    if M < 1 or b % M:
        raise ValueError(f"batch {b} not divisible by {M} microbatches")
    drawn = _draws(stage)
    if drawn:
        raise ValueError(f"blocks {drawn} draw randomness in training: the "
                         "pipelined chain would differ from the sequential "
                         "one (set their rates to 0 or call eval())")
    nstage, p, group = mesh.pipe, mesh.pipe_rank, mesh.pipe_group
    xs = comm.copy_to_model(x, group)
    mx = xs.split(b // M)
    mc = list(zip(*(_micro(c, b, M) for c in consts))) or [()] * M
    # the start of the shifts' token chain: from x, so that x's all-reduce
    # backward runs after every shift's, or a leaf when x needs no gradient
    token = torch.zeros((), device=x.device)
    if xs.requires_grad:
        token = _Join.apply(token, xs)
    elif torch.is_grad_enabled() and any(
            t.requires_grad for blk in stage if isinstance(blk, nn.Module)
            for t in blk.parameters()):
        token.requires_grad_()
    idle = torch.zeros_like(mx[0])
    state, outs = None, []
    steps = M + nstage - 1
    for t in range(steps):
        i = t - p
        if 0 <= i < M:
            y = mx[i] if p == 0 else state
            for blk in stage:
                y = block_fn(blk, y, *mc[i])
            if y.shape != idle.shape or y.dtype != idle.dtype:
                raise ValueError(
                    f"block_fn maps {tuple(idle.shape)} {idle.dtype} to "
                    f"{tuple(y.shape)} {y.dtype}: the chain must keep both")
            if p == nstage - 1:
                outs.append(y)
        else:
            y = idle  # the bubble
        if t < steps - 1:
            state, token = comm.shift(y, group, token)
    out = torch.cat(outs) if p == nstage - 1 else torch.zeros_like(x)
    out = comm.reduce_from_model(out, group)
    return _Join.apply(out, token) if token.requires_grad else out


def sequential_blocks(block_fn: Callable, blocks: Sequence, x: torch.Tensor,
                      consts: Sequence = ()) -> torch.Tensor:
    """Reference semantics for :func:`pipeline_blocks`: every block of the
    chain in turn on the whole batch."""
    for blk in blocks:
        x = block_fn(blk, x, *consts)
    return x
