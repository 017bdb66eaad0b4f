"""The collectives of the data, model and seq axes, differentiable where
the model needs a gradient through them.

* :func:`all_reduce`: the sum with its gradient, the max without one;
* Megatron's f and g pair: :func:`copy_to_model` (identity forward,
  all-reduce backward) at the input of a column-parallel layer and
  :func:`reduce_from_model` (all-reduce forward, identity backward) after a
  row-parallel one;
* :func:`all_gather` along a dimension, and :func:`mirror`, the tensor of
  the mirror rank ``W-1-r`` (mixup's partner rows);
* :func:`all_reduce_mean_`, the data-parallel mean of the gradients in a
  few flat buckets;
* the seq axis's pair (:class:`TokenRange`, :func:`token_range_of`):
  :func:`slice_tokens`, this rank's token rows (its backward is the
  slice's own: the gradient on the rank's rows, zero elsewhere), and
  :func:`gather_tokens`, every rank's rows put together (all-gather
  forward, reduce-scatter backward: the sum over the seq ranks of the
  gradient, kept on the rank's rows);
* the pipe axis's hand-off, :func:`shift`: every rank's tensor to the
  next rank of the group, the previous rank's returned (its backward is
  the reverse shift).

Every one returns its input (or does nothing) when the group is None or
has one rank, so a single process runs exactly the ops it runs without
this module.

Routes: NCCL, and gloo on CPU tensors, use the native collectives
(``all_gather``; ``reduce_scatter_tensor`` of token rows padded to the
largest range). Gloo on CUDA tensors implements only ``broadcast`` and
``all_reduce``, so there an all-gather is an all-reduce sum of a zero
buffer in which each rank fills its own slot (exact: the other slots add
zeros) and a reduce-scatter an all-reduce sum of which each rank keeps
its rows. The token all-gather gathers each rank's rows padded to the
largest range, and a shift the previous rank's slot of an all-gather
(``W`` times the bytes of point-to-point). Half-precision tensors travel
as float32 through gloo. The route is chosen by the backend's name, never
after a failure.

The helpers ``data_*`` and :func:`global_draw` read the ambient mesh
(:func:`.mesh.current`): the model's batch-wide reductions and per-image
draws call them unconditionally.

:data:`STATS` counts the collectives and the host seconds spent in them.
With ``MLAFF_COMM_TIMING=1`` in the environment each collective on a CUDA
tensor first waits for the device (``torch.cuda.synchronize``), so the
seconds are the collective's own and not the wait for the work that
produces its input; that costs the overlap, so it is off by default.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Iterable, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from . import mesh as mesh_lib

__all__ = ["size", "rank", "all_reduce", "copy_to_model", "reduce_from_model",
           "all_gather", "mirror", "all_reduce_mean_", "data_coords",
           "data_all_reduce", "global_draw", "TokenRange", "token_range_of",
           "slice_tokens", "gather_tokens", "shift", "STATS"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}
_BUCKET_BYTES = 32 << 20
_TIMING = os.environ.get("MLAFF_COMM_TIMING") == "1"
STATS = {"calls": 0, "seconds": 0.0}


def _collective(fn, t: torch.Tensor, *args, **kwargs):
    """``fn(*args, **kwargs)``, counted in :data:`STATS`."""
    if _TIMING and t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    STATS["calls"] += 1
    STATS["seconds"] += time.perf_counter() - t0


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _route(group, t: torch.Tensor) -> str:
    """``reduce`` where the backend lacks the native op for ``t`` (gloo on
    a CUDA tensor), else ``native``."""
    return ("reduce" if t.is_cuda and dist.get_backend(group) == "gloo"
            else "native")


def _reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """In-place all-reduce of a fresh contiguous tensor, returned."""
    _collective(dist.all_reduce, t, t, op=_OPS[op], group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _reduce(x.detach().clone().contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        # the output is the same on every rank and each rank's loss reads
        # it: its gradient is the sum over ranks
        return _reduce(grad.contiguous().clone(), ctx.group), None


def all_reduce(x: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """Sum or max of ``x`` over ``group``. The sum carries its gradient
    (the sum of the ranks' gradients); the max carries none (it only ever
    feeds the clustering's sort key)."""
    if size(group) == 1:
        return x
    if op == "max":
        return _reduce(x.detach().clone().contiguous(), group, "max")
    return _AllReduceSum.apply(x, group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad.contiguous().clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: ``x`` as it is; its gradient summed over ``group``."""
    if size(group) == 1:
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: ``x`` summed over ``group`` (in float32 at least: gloo
    takes no bfloat16, and the partial sums keep their precision),
    returned in ``x``'s dtype; the gradient passes as it is."""
    if size(group) == 1:
        return x
    wide = torch.promote_types(x.dtype, torch.float32)
    return _ReduceFromModel.apply(x.to(wide), group).to(x.dtype)


def _wide(x: torch.Tensor, group) -> bool:
    """Whether ``x`` must travel as float32 (gloo takes no half type)."""
    return (x.dtype in (torch.float16, torch.bfloat16)
            and dist.get_backend(group) == "gloo")


def _gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``(W,) + x.shape``: every rank's ``x`` in rank order."""
    w, r = size(group), rank(group)
    src = x.float() if _wide(x, group) else x
    if _route(group, x) == "reduce":
        buf = src.new_zeros((w,) + tuple(x.shape))
        buf[r] = src
        return _reduce(buf, group).to(x.dtype)
    out = src.new_empty((w,) + tuple(x.shape))
    _collective(dist.all_gather, x, list(out.unbind(0)), src.contiguous(),
                group=group)
    return out.to(x.dtype)


@torch.no_grad()
def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` (equal shapes) concatenated along ``dim`` in rank
    order; no gradient."""
    if size(group) == 1:
        return x
    return torch.cat(list(_gather_rows(x, group).unbind(0)), dim=dim)


@torch.no_grad()
def mirror(x: torch.Tensor, group) -> torch.Tensor:
    """The ``x`` of rank ``W-1-r`` of ``group`` (``x`` itself on one
    rank); no gradient."""
    w = size(group)
    if w == 1:
        return x
    return _gather_rows(x, group)[w - 1 - rank(group)]


@torch.no_grad()
def all_reduce_mean_(tensors: Iterable[torch.Tensor], group) -> None:
    """Replace each tensor by its mean over ``group``, in flat buckets of
    about 32 MiB per dtype and device."""
    w = size(group)
    if w == 1:
        return
    buckets: dict = {}
    for t in tensors:
        key = (t.dtype, t.device)
        cur = buckets.setdefault(key, [[]])
        if (cur[-1] and sum(x.numel() for x in cur[-1]) * t.element_size()
                >= _BUCKET_BYTES):
            cur.append([])
        cur[-1].append(t)
    for lists in buckets.values():
        for bucket in lists:
            flat = torch.cat([t.reshape(-1) for t in bucket])
            _reduce(flat, group)
            flat /= w
            off = 0
            for t in bucket:
                t.copy_(flat[off:off + t.numel()].view_as(t))
                off += t.numel()


# ------------------------------------------------------ the ambient mesh ----

def data_coords() -> Tuple[int, int, Optional[object]]:
    """``(data rank, data size, data group)`` of the ambient mesh;
    ``(0, 1, None)`` without one."""
    m = mesh_lib.current()
    if m is None or m.data == 1:
        return 0, 1, None
    return m.data_rank, m.data, m.data_group


def data_all_reduce(x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """:func:`all_reduce` over the ambient mesh's data axis: a batch-wide
    reduction over the global batch."""
    return all_reduce(x, data_coords()[2], op)


def global_draw(draw: Callable[[int], torch.Tensor], b: int) -> torch.Tensor:
    """A per-image draw for this data rank's ``b`` rows: ``draw(b)`` on one
    rank; with W data ranks ``draw(b * W)`` (the global batch's draw, the
    same on every rank) sliced to this rank's rows, so a W-rank step draws
    what the one-process step of the global batch draws."""
    r, w, _ = data_coords()
    if w == 1:
        return draw(b)
    return draw(b * w)[r * b:(r + 1) * b]



# --------------------------------------------------------- the seq axis ----

class TokenRange(NamedTuple):
    """This seq rank's tokens ``[lo, hi)`` of a stage of ``n``, and the seq
    group (``parallel/mesh.py::token_range``)."""

    lo: int
    hi: int
    n: int
    group: object

    @property
    def size(self) -> int:
        return self.hi - self.lo

    def ranges(self) -> List[Tuple[int, int]]:
        """Every seq rank's ``(lo, hi)``, in rank order."""
        w = size(self.group)
        return [mesh_lib.token_range(self.n, w, r) for r in range(w)]


def token_range_of(n: int) -> Optional[TokenRange]:
    """The :class:`TokenRange` of a stage of ``n`` tokens on the ambient
    mesh, or None without a seq axis (then every rank holds every
    token)."""
    m = mesh_lib.current()
    if m is None or m.seq == 1:
        return None
    lo, hi = mesh_lib.token_range(n, m.seq, m.seq_rank)
    return TokenRange(lo, hi, n, m.seq_group)


def slice_tokens(x: torch.Tensor, tokens: Optional[TokenRange],
                 dim: int = 1) -> torch.Tensor:
    """This rank's rows of ``x`` along its token ``dim`` (``x`` itself
    without ``tokens``); its gradient is zero outside them."""
    if tokens is None:
        return x
    return x.narrow(dim, tokens.lo, tokens.size)


def _gather_ranges(x: torch.Tensor, tokens: TokenRange) -> torch.Tensor:
    """``(n, ...)`` from every rank's ``(size, ...)`` rows (token dim
    first): the rows padded to the widest range, gathered, and cut."""
    ranges = tokens.ranges()
    width = max(hi - lo for lo, hi in ranges)
    pad = x.new_zeros((width,) + tuple(x.shape[1:]))
    pad[:tokens.size] = x
    rows = _gather_rows(pad, tokens.group)
    return torch.cat([rows[r, :hi - lo] for r, (lo, hi) in enumerate(ranges)])


def _scatter_ranges(g: torch.Tensor, tokens: TokenRange) -> torch.Tensor:
    """This rank's ``(size, ...)`` rows of the sum over the ranks of the
    ``(n, ...)`` ``g`` (token dim first)."""
    group = tokens.group
    src = g.float() if _wide(g, group) else g
    if _route(group, g) == "reduce":
        return _reduce(src.clone(), group)[tokens.lo:tokens.hi].to(g.dtype)
    ranges = tokens.ranges()
    width = max(hi - lo for lo, hi in ranges)
    stacked = src.new_zeros((len(ranges) * width,) + tuple(g.shape[1:]))
    for r, (lo, hi) in enumerate(ranges):
        stacked[r * width:r * width + hi - lo] = src[lo:hi]
    out = src.new_empty((width,) + tuple(g.shape[1:]))
    _collective(dist.reduce_scatter_tensor, g, out, stacked,
                op=dist.ReduceOp.SUM, group=group)
    return out[:tokens.size].to(g.dtype)


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tokens, dim):
        ctx.tokens, ctx.dim = tokens, dim
        full = _gather_ranges(x.detach().movedim(dim, 0).contiguous(), tokens)
        return full.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        g = grad.movedim(ctx.dim, 0).contiguous()
        return (_scatter_ranges(g, ctx.tokens).movedim(0, ctx.dim)
                .contiguous(), None, None)


def gather_tokens(x: torch.Tensor, tokens: Optional[TokenRange],
                  dim: int = 1) -> torch.Tensor:
    """Every seq rank's rows of ``x`` (this rank's ``tokens``, along
    ``dim``) put together into the stage's ``n`` (``x`` itself without
    ``tokens``). The gradient is the sum over the seq ranks of the
    gradient of the whole, on this rank's rows: each rank's whole-stage
    consumers (the next stage, a k/v read by another rank's queries) add
    their share."""
    if tokens is None:
        return x
    return _GatherTokens.apply(x, tokens, dim)


# -------------------------------------------------------- the pipe axis ----

def _exchange(send: torch.Tensor, recv: torch.Tensor, dst: int, src: int,
              group) -> None:
    """Send ``send`` to global rank ``dst`` while receiving ``recv`` from
    ``src``, and wait for both."""
    for req in dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, dst, group),
            dist.P2POp(dist.irecv, recv, src, group)]):
        req.wait()


def _shift_rows(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """On rank ``r`` of ``group``, the ``x`` of rank ``r - step`` (every
    rank sends its ``x`` to rank ``r + step``, modulo the group's size)."""
    w, r = size(group), rank(group)
    if _route(group, x) == "reduce":
        return _gather_rows(x, group)[(r - step) % w]
    src = (x.float() if _wide(x, group) else x).contiguous()
    out = torch.empty_like(src)
    _collective(_exchange, x, src, out,
                dist.get_global_rank(group, (r + step) % w),
                dist.get_global_rank(group, (r - step) % w), group)
    return out.to(x.dtype)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, token, group):
        ctx.group = group
        return _shift_rows(x.detach(), group, 1), token.detach().clone()

    @staticmethod
    def backward(ctx, grad, grad_token):
        # every rank sends its gradient back, also one that no input of its
        # own wants, so that the ranks' collectives stay in step
        back = _shift_rows(grad.contiguous(), ctx.group, -1)
        return (back if ctx.needs_input_grad[0] else None), grad_token, None


def shift(x: torch.Tensor, group, token: Optional[torch.Tensor] = None):
    """The hand-off of a pipeline: every rank of ``group`` sends ``x`` to
    the next rank (the last to the first) and gets the previous rank's
    tensor, of ``x``'s shape and dtype, which it returns. The backward is
    the reverse shift: each rank sends the gradient of what it got back to
    the rank that sent it.

    ``token`` (a 0-dim tensor) threads a schedule's shifts into one chain
    for autograd: the call then returns ``(shifted, next token)``, and a
    shift whose token comes from an earlier one runs its backward after
    that one's, on every rank, whatever each rank computed in between.
    ``x`` itself on a group of one rank."""
    if size(group) == 1:
        return x if token is None else (x, token)
    if token is None:
        return _Shift.apply(x, x.new_zeros(()), group)[0]
    return _Shift.apply(x, token, group)
