"""Fused local cluster attention (counterpart of ``fused_cluster_attention``
in the JAX package's ``ops/clusten_pallas.py``).

The forward and the backward are dispatcher ops,
``torch.ops.mlaff.cluster_attention_fwd`` and ``..._bwd``, the forward
with an autograd formula that calls the backward. On a CUDA tensor the
forward launches the CUDA kernel ``csrc/cluster_attention.cu`` and the
backward ``csrc/cluster_attention_bwd{,_saved}.cu``; on a CPU tensor they
run :func:`cluster_attention_reference` and
:func:`cluster_attention_backward_reference`, the plain PyTorch versions.
There is no fallback between the two. Each op has a fake kernel, so
``torch.export`` traces it and ``FlopCounterMode`` and selective
checkpointing see it.

Two modes of the JAX kernels are kept. The saved-stats mode (JAX
``_fca_fwd``, the default; ``MLAFF_BWD_SAVED=0`` selects the recompute
backward): the forward also writes each row's softmax max and denominator
(``stats``, (b, n, 2h) f32 in JAX's lane layout) and the backward takes
them and the forward's output instead of recomputing the softmax, with
S = rowsum(g * out). Attention-probability dropout (JAX ``_fca_drop``):
the probabilities of the slots and of the blank are multiplied by the
keep/scale of :func:`drop_keep`, a stateless hash of the global (image,
head, query row, kv token) that the backward replays; the denominator is
not dropped.

The kernels work on tiles of :data:`TILE` consecutive query rows: a block
stages the union of its tile's neighbour clusters in shared memory.
:func:`tile_metadata` computes that union per tile once per stage (the
model calls it where ``ncc`` is made and hands it to every block of the
stage, forward and backward; :func:`constant_tile_metadata` keeps that of
a constant ``ncc``, such as the on-grid stage's); without it the wrappers
compute it themselves.

Every entry takes a query range (sequence parallelism,
``parallel/__init__.py``): ``q`` (and ``ncc``, the output, the statistics,
``g_out`` and ``dq``) may hold ``nq`` rows of each image, its tokens ``[q0,
q0 + nq)``, while ``kv`` and ``pos`` hold all ``n``. A query reads its
position and its dropout row at its token, its neighbours' k and v rows
by token, and the backward's ``dkv`` has all ``n`` rows: the range's
queries' share of the gradient. The tile metadata is that of the range's
``ncc``. ``q0 = 0`` with ``nq = n`` is the plain call, bit for bit.
"""

from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional

import numpy as np

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..utils.profiling import span
from . import _build
from .cluster_gather import cluster_token_index, gather_clusters

__all__ = ["fused_cluster_attention", "cluster_attention_reference",
           "cluster_attention_backward",
           "cluster_attention_backward_reference", "cluster_attention_forward",
           "offset_features", "drop_keep", "draw_drop_seed", "head_offset_seed",
           "image_offset_seed", "saved_mode",
           "TILE", "TileMeta", "tile_metadata", "constant_tile_metadata",
           "union_rows", "BLANK_COL"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # query rows per kernel tile, csrc/cluster_attention_tile.cuh::kTile
BLANK_COL = 65535  # the hash's kv column of the blank slot
_MASK32 = 0xFFFFFFFF
# the hash's multipliers of the image and head index
_IMG_MUL = -1640531535 & _MASK32
_HEAD_MUL = -2048144777 & _MASK32


def saved_mode() -> bool:
    """Whether the backward takes the forward's saved softmax statistics
    (the default) or recomputes them (``MLAFF_BWD_SAVED=0``, the JAX
    package's switch), read at each forward."""
    return os.environ.get("MLAFF_BWD_SAVED", "1") == "1"


def _mul32(x, m):
    """``x * m mod 2**32`` for int64 ``x`` in [0, 2**32) and a constant
    ``m`` in [0, 2**32), without overflowing int64."""
    lo, hi = m & 0xFFFF, m >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _drop_params(rate):
    """(threshold, scale) of a drop rate, in Python doubles as the JAX
    package computes them: a hash below the threshold drops, a kept
    probability is scaled by float32(1 / (1 - rate))."""
    return (int(rate * 2147483647.0),
            float(np.float32(1.0 / (1.0 - rate))))


def drop_keep(seed, img, head, rows, cols, rate):
    """The keep/scale of attention-probability dropout at global (image,
    head, query row, kv column): a bit-exact copy of the JAX package's
    ``clusten_pallas.py::_drop_keep`` (lowbias32-style hash in int32
    arithmetic that wraps). ``img``, ``head``, ``rows`` and ``cols`` are
    integer tensors (or ints) that broadcast together; the column of the
    blank slot is :data:`BLANK_COL`. Returns float32: 0 where dropped,
    float32(1 / (1 - rate)) where kept."""
    as_t = [t if torch.is_tensor(t) else torch.tensor(t)
            for t in (img, head, rows, cols)]
    img, head, rows, cols = (t.long() for t in as_t)
    # int32 wrap-around as uint32 in int64: every step masked to 32 bits
    x = (rows * 65536 + cols + (int(seed) & _MASK32)
         + img * _IMG_MUL + head * _HEAD_MUL) & _MASK32
    x = x ^ (x >> 16)
    x = _mul32(x, 2146121005)
    x = x ^ (x >> 15)
    x = _mul32(x, -2073219445 & _MASK32)
    x = x ^ (x >> 16)
    thresh, scale = _drop_params(rate)
    keep = (x & 0x7FFFFFFF) >= thresh
    return torch.where(keep, torch.tensor(scale, dtype=torch.float32),
                       torch.tensor(0.0, dtype=torch.float32))


def draw_drop_seed(generator: Optional[torch.Generator] = None) -> int:
    """One dropout seed in [0, 2**31 - 1), as the JAX layer's
    ``randint(0, iinfo(int32).max)``, from a CPU ``generator`` (torch's
    default CPU generator when None): a host integer, so the kernels take
    it by value, and the same seed on every device."""
    return int(torch.randint(0, 2**31 - 1, (1,), generator=generator))


def head_offset_seed(seed: int, head0: int) -> int:
    """The seed whose masks at head ``h`` are :func:`drop_keep`'s of
    ``seed`` at head ``head0 + h``: the hash adds ``head * _HEAD_MUL`` to
    the seed before it mixes, so a tensor-parallel rank that holds the
    heads from ``head0`` on drops them as one process does."""
    return (int(seed) + head0 * _HEAD_MUL) & _MASK32


def image_offset_seed(seed: int, img0: int) -> int:
    """The seed whose masks at image ``i`` are :func:`drop_keep`'s of
    ``seed`` at image ``img0 + i``: the hash adds ``img * _IMG_MUL`` to the
    seed before it mixes, so a data rank whose batch starts at image
    ``img0`` of the global batch drops as one process does."""
    return (int(seed) + img0 * _IMG_MUL) & _MASK32


def _drop_planes(ncc, cs, num_heads, drop, device, img0=0, q0=0):
    """The keep/scale planes of ``drop = (rate, seed)``: of the slots, (b,
    h, nq, m), and of the blank, (b, h, nq, 1), float32; the images are
    ``img0 + [0, b)`` of the batch, the query rows ``q0 + [0, nq)`` of
    the tokens (``ncc`` holds ``nq`` rows)."""
    rate, seed = drop
    b, nq, _ = ncc.shape
    img = torch.arange(img0, img0 + b, device=device)[:, None, None, None]
    head = torch.arange(num_heads, device=device)[None, :, None, None]
    rows = torch.arange(q0, q0 + nq, device=device)[None, None, :, None]
    cols = cluster_token_index(ncc, cs)[:, None]  # b 1 n m
    return (drop_keep(seed, img, head, rows, cols, rate),
            drop_keep(seed, img, head, rows, BLANK_COL, rate))


class TileMeta(NamedTuple):
    """The neighbour-cluster union of each tile of :data:`TILE` query rows.

    ``B`` is the batch of ``ncc``, or 1 when ``ncc`` is batch-broadcast;
    ``nt = ceil(n / TILE)``.

    * ``ucl`` (B, nt, TILE * nnc) int32: the union's cluster ids, sorted
      ascending, in the first ``ucount`` entries;
    * ``ucount`` (B, nt) int32: the union's size;
    * ``nidx`` (B, nt * TILE, nnc) int32: for each query row, the union
      indices of its nnc clusters, sorted ascending (rows past n repeat
      the last row), so that a union chunk covers a contiguous run of
      each row's slots.
    """

    ucl: torch.Tensor
    ucount: torch.Tensor
    nidx: torch.Tensor


def tile_metadata(ncc):
    """:class:`TileMeta` of the (b, n, nnc) nearest-cluster indices
    ``ncc`` (plain torch, on ``ncc``'s device). A batch-broadcast ``ncc``
    (stride 0) gives one image's metadata. Counted in
    ``tile_metadata.calls``."""
    with span("geom.tile_metadata"):
        tile_metadata.calls += 1
        if ncc.shape[0] > 1 and ncc.stride(0) == 0:
            ncc = ncc[:1]
        B, n, nnc = ncc.shape
        nt = -(-n // TILE)
        rows = ncc.long()
        if nt * TILE != n:
            rows = torch.cat(
                [rows, rows[:, -1:].expand(B, nt * TILE - n, nnc)], dim=1)
        ids = rows.reshape(B, nt, TILE * nnc)
        srt, perm = torch.sort(ids, dim=-1)
        new = torch.ones_like(srt, dtype=torch.bool)
        new[..., 1:] = srt[..., 1:] != srt[..., :-1]
        rank = torch.cumsum(new, dim=-1) - 1  # union index of each sorted id
        nidx = torch.empty_like(rank).scatter_(-1, perm, rank)
        nidx = torch.sort(nidx.reshape(B, nt * TILE, nnc), dim=-1)[0]
        ucl = torch.zeros_like(srt).scatter_(-1, rank, srt)
        ucount = rank[..., -1] + 1 if nnc else rank.new_zeros((B, nt))
        i32 = torch.int32
        return TileMeta(ucl.to(i32), ucount.to(i32), nidx.to(i32))


tile_metadata.calls = 0

_CONST_META = WeakIdKeyDictionary()


def constant_tile_metadata(ncc, lo: int = 0, hi: Optional[int] = None):
    """:func:`tile_metadata` of the rows ``[lo, hi)`` (default: all) of a
    constant (n, nnc) ``ncc`` that is broadcast over the batch (the
    on-grid stage's), computed once per tensor and range and kept while
    the tensor lives."""
    hi = ncc.shape[0] if hi is None else hi
    per = _CONST_META.setdefault(ncc, {})
    if (lo, hi) not in per:
        per[(lo, hi)] = tile_metadata(ncc[None, lo:hi])
    return per[(lo, hi)]


def offset_features(dx, dy):
    """(..., 5) rel-pos features (dx, dy, dist, sin, cos) of the offsets
    ``(dx, dy)``; sin and cos are 0 where dist is 0."""
    dist = torch.sqrt(dx * dx + dy * dy)
    safe = torch.where(dist == 0, torch.ones_like(dist), dist)
    sin = torch.where(dist == 0, torch.zeros_like(dist), dy / safe)
    cos = torch.where(dist == 0, torch.zeros_like(dist), dx / safe)
    return torch.stack([dx, dy, dist, sin, cos], dim=-1)


def _rel_feat(pos, ncc, cs, rel_width, clamp_width, q0=0):
    """(b, nq, m, 5) rel-pos features of the neighbourhood slots of the
    queries at tokens ``q0 + [0, nq)`` (JAX package
    ``clusten_pallas.py:2920``)."""
    pos_g = gather_clusters(pos[:, None], ncc, cs)[:, 0]  # b nq m 2
    rel = pos_g - pos[:, q0:q0 + ncc.shape[1], None, :]
    if clamp_width:
        rel = torch.clamp(rel + rel_width, 0, clamp_width - 1) - rel_width
    return offset_features(rel[..., 0], rel[..., 1])


def _softmax_parts(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, num_heads,
                   cs, rel_width, clamp_width, stats=None, q0=0):
    """The pieces the forward and backward share, in the accumulation type
    (f32, or f64 for f64 inputs): head-split q, gathered k and v, the
    rel-pos features, the normalised probabilities of the slots and of the
    blank token (``clusten_pallas.py:3080-3106``; 0 at padded slots), and
    the softmax max and denominator, (b, h, nq, 1) each, of the queries at
    tokens ``q0 + [0, nq)``. With ``stats`` (b, nq, 2h), a forward's saved
    max (lanes [0, h)) and denominator (lanes [h, 2h)) take the place of
    the row's own."""
    b, nq, c = q.shape
    n = kv.shape[1]
    h = num_heads
    c_ = c // h
    acc = torch.promote_types(q.dtype, torch.float32)
    pos = pos.to(acc)
    qh = q.to(acc).reshape(b, nq, h, c_).permute(0, 2, 1, 3)  # b h nq c_
    kvh = kv.to(acc).reshape(b, n, h, 2, c_)
    kh = kvh[..., 0, :].permute(0, 2, 1, 3)
    vh = kvh[..., 1, :].permute(0, 2, 1, 3)

    feat5 = _rel_feat(pos, ncc, cs, rel_width, clamp_width, q0)  # b nq m 5
    bias = (
        torch.einsum("bnmf,fh->bhnm", feat5, pe_kernel.to(acc))
        + pe_bias.to(acc)[None, :, None, None]
    )
    pad_ok = (cluster_token_index(ncc, cs) < n)[:, None]  # b 1 n m
    kg = gather_clusters(kh, ncc, cs)  # b h n m c_
    vg = gather_clusters(vh, ncc, cs)
    logits = torch.einsum("bhic,bhimc->bhim", qh, kg) + bias
    logits = logits.masked_fill(~pad_ok, float("-inf"))
    blank = torch.einsum("bhic,ch->bhi", qh, blank_k.to(acc))[..., None]
    if stats is None:
        mx = torch.maximum(logits.amax(-1, keepdim=True), blank)
    else:
        mx = stats[..., :h].to(acc).permute(0, 2, 1)[..., None]
    p = torch.exp(logits - mx)  # exactly 0 at padded slots
    pb = torch.exp(blank - mx)
    if stats is None:
        denom = p.sum(-1, keepdim=True) + pb
    else:
        denom = stats[..., h:].to(acc).permute(0, 2, 1)[..., None]
    return qh, kg, vg, feat5, p / denom, pb / denom, mx, denom


def cluster_attention_reference(q, kv, ncc, pos, pe_kernel, pe_bias,
                                blank_k, blank_v, num_heads, cs, rel_width,
                                clamp_width=0, drop=None, want_stats=False,
                                img0=0, q0=0):
    """Plain PyTorch version of the forward, in f32 (f64 for f64 inputs).

    Follows the algebra of the JAX package's oracle
    (``clusten_pallas.py:3080-3106``): gathered k/v, rel-pos bias, padded
    slots excluded from a joint softmax with the blank logit. With ``drop
    = (rate, seed)`` the normalised probabilities of the slots and of the
    blank are multiplied by their :func:`drop_keep` (JAX ``_fwd_kernel``,
    ``:940-957``). Returns q's dtype; with ``want_stats`` also the
    softmax statistics (b, n, 2h): per head the max over the slots and the
    blank logit (lane hi) and the denominator, blank included (lane
    h + hi), in the accumulation type, as JAX's stats output. ``img0``:
    the index in the batch of the first image (the masks of a batch
    chunk). ``q0``: the token of q's first row (the query range).
    """
    b, n, c = q.shape
    _, _, vg, _, p, pb, mx, denom = _softmax_parts(
        q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, num_heads, cs,
        rel_width, clamp_width, q0=q0)
    if drop is not None:
        keep, keep_b = _drop_planes(ncc, cs, num_heads, drop, q.device,
                                    img0, q0)
        p = p * keep.to(p.dtype)
        pb = pb * keep_b.to(p.dtype)
    out = torch.einsum("bhim,bhimc->bhic", p, vg)
    out = out + pb * blank_v.to(p.dtype)[None, :, None, :]
    out = out.permute(0, 2, 1, 3).reshape(b, n, c).to(q.dtype)
    if not want_stats:
        return out
    stats = torch.cat([mx[..., 0], denom[..., 0]], dim=1)  # b 2h n
    return out, stats.permute(0, 2, 1).contiguous()


def cluster_attention_backward_reference(q, kv, ncc, pos, pe_kernel,
                                         pe_bias, blank_k, blank_v, g_out,
                                         num_heads, cs, rel_width,
                                         clamp_width=0, saved=None,
                                         drop=None, img0=0, q0=0):
    """Plain PyTorch version of the backward, formula for formula the JAX
    package's oracle backward (``clusten_pallas.py:3080-3149``).

    ``saved = (out, stats)``, the forward's output and statistics (the
    saved-stats mode, JAX ``_fca_fwd``): the probabilities come from the
    saved max and denominator, and S = rowsum(g * out) (the delta trick)
    replaces sum_s p_s dp_s + pb dpb. ``drop = (rate, seed)`` replays the
    forward's dropout: with M the keep/scale, dV = (P M)^T g, dP' = M (g
    V^T) and dL = P (dP' - S), the blank alike; ``img0`` and ``q0`` as
    for the forward (``dkv`` has all ``n`` rows of ``kv``).

    Returns ``(dq, dkv, d_pe_kernel, d_pe_bias, d_blank_k, d_blank_v)``,
    each in its input's dtype. d_pe_bias is summed as -sum(dlb), the
    oracle's sum of dL over the slots without its cancellation. The
    scatter into dkv is an ``index_add_`` over the slots' token rows
    (deterministic on the CPU).
    """
    b, nq, c = q.shape
    n = kv.shape[1]
    h = num_heads
    c_ = c // h
    nnc = ncc.shape[-1]
    m = nnc * cs
    qh, kg, vg, feat5, p, pb, _, _ = _softmax_parts(
        q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, num_heads, cs,
        rel_width, clamp_width, stats=None if saved is None else saved[1],
        q0=q0)
    acc = p.dtype
    goh = g_out.to(acc).reshape(b, nq, h, c_).permute(0, 2, 1, 3)
    bk = blank_k.to(acc).t()  # (h, c_)
    bv = blank_v.to(acc)  # (h, c_)

    dp = torch.einsum("bhic,bhimc->bhim", goh, vg)
    dpb = torch.einsum("bhic,hc->bhi", goh, bv)[..., None]
    pk, pbk = p, pb  # the probabilities as the output weighed them
    if drop is not None:
        keep, keep_b = _drop_planes(ncc, cs, num_heads, drop, q.device,
                                    img0, q0)
        dp = dp * keep.to(acc)
        dpb = dpb * keep_b.to(acc)
        pk = p * keep.to(acc)
        pbk = pb * keep_b.to(acc)
    if saved is None:
        s = (dp * p).sum(-1, keepdim=True) + dpb * pb
    else:
        outh = saved[0].to(acc).reshape(b, nq, h, c_).permute(0, 2, 1, 3)
        s = (goh * outh).sum(-1, keepdim=True)
    dlogits = p * (dp - s)  # zero at padded slots, where p is 0
    dlb = pb * (dpb - s)  # b h n 1

    dqh = torch.einsum("bhim,bhimc->bhic", dlogits, kg)
    dqh = dqh + dlb * bk[None, :, None, :]
    d_pe_kernel = torch.einsum("bhnm,bnmf->fh", dlogits, feat5)
    # the sum of dl over the slots is -dlb per row (sum p + pb = 1): summed
    # so, as the kernel sums it, without the cancellation of the slots'
    # terms (in the saved mode the two differ by pb times the rounding of
    # the stored output in S)
    d_pe_bias = -dlb.sum(dim=(0, 2, 3))
    d_blank_k = torch.einsum("bhic,bhi->ch", qh, dlb[..., 0])
    d_blank_v = torch.einsum("bhi,bhic->hc", pbk[..., 0], goh)

    # scatter-add of the slots' dk / dv rows onto their tokens; padded slots
    # point past n into the zero-padded tail, which is cut off
    np_ = -(-n // cs) * cs
    rows = cluster_token_index(ncc, cs)  # b n m
    rows = rows + torch.arange(b, device=rows.device)[:, None, None] * np_
    dkg = qh[:, :, :, None, :] * dlogits[..., None]  # b h nq m c_
    dvg = pk[..., None] * goh[:, :, :, None, :]
    src = torch.stack([dkg, dvg], dim=-2)  # b h nq m 2 c_
    src = src.permute(0, 2, 3, 1, 4, 5).reshape(b * nq * m, h, 2, c_)
    dkv = torch.zeros(b * np_, h, 2, c_, dtype=acc, device=q.device)
    dkv.index_add_(0, rows.reshape(-1), src)
    dkv = dkv.reshape(b, np_, 2 * c)[:, :n]
    dq = dqh.permute(0, 2, 1, 3).reshape(b, nq, c)
    return (dq.to(q.dtype), dkv.to(kv.dtype),
            d_pe_kernel.to(pe_kernel.dtype), d_pe_bias.to(pe_bias.dtype),
            d_blank_k.to(blank_k.dtype), d_blank_v.to(blank_v.dtype))


def _check_cuda_args(q, kv, ncc, pos, num_heads, q0=0):
    b, nq, c = q.shape
    n = kv.shape[1] if kv.dim() == 3 else -1
    dev = q.device
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if kv.dtype != q.dtype:
        raise TypeError(f"kv dtype {kv.dtype} != q dtype {q.dtype}")
    if c % num_heads:
        raise ValueError(f"channels {c} not divisible by {num_heads} heads")
    if kv.dim() != 3 or tuple(kv.shape) != (b, n, 2 * c):
        raise ValueError(f"kv shape {tuple(kv.shape)} != (b, n, 2c) with "
                         f"b, 2c = {b}, {2 * c}")
    if not 0 <= q0 <= q0 + nq <= n:
        raise ValueError(f"query rows [{q0}, {q0 + nq}) outside the {n} "
                         "tokens of kv")
    if ncc.dtype != torch.int32 or ncc.dim() != 3 or ncc.shape[:2] != (b, nq):
        raise ValueError(f"ncc must be int32 (b, nq, nnc), got "
                         f"{ncc.dtype} {tuple(ncc.shape)}")
    if pos.dtype != torch.float32 or tuple(pos.shape) != (b, n, 2):
        raise ValueError(f"pos must be float32 (b, n, 2), got "
                         f"{pos.dtype} {tuple(pos.shape)}")
    for name, t in (("q", q), ("kv", kv), ("ncc", ncc), ("pos", pos)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if not (q.is_contiguous() and kv.is_contiguous()):
        raise ValueError("q and kv must be contiguous")
    if kv.data_ptr() % 16:
        raise ValueError("kv must be 16-byte aligned")
    # the batch dim of ncc / pos may be broadcast (stride 0, on-grid stage)
    if ncc.stride(2) != 1 or ncc.stride(1) != ncc.shape[2]:
        raise ValueError("ncc rows must be contiguous (b may be broadcast)")
    if pos.stride(2) != 1 or pos.stride(1) != 2:
        raise ValueError("pos rows must be contiguous (b may be broadcast)")


def _small_params(q, num_heads, pe_kernel, pe_bias, blank_k, blank_v):
    """The four small parameters as contiguous f32 on q's device, shape
    checked: the kernels read them as plain f32 arrays."""
    h = num_heads
    c_ = q.shape[2] // h
    f32 = dict(device=q.device, dtype=torch.float32)
    out = [t.detach().to(**f32).contiguous()
           for t in (pe_kernel, pe_bias, blank_k, blank_v)]
    if [tuple(t.shape) for t in out] != [(5, h), (h,), (c_, h), (h, c_)]:
        raise ValueError("pe_kernel/pe_bias/blank_k/blank_v shapes must be "
                         f"(5,{h})/({h},)/({c_},{h})/({h},{c_})")
    return out


def _meta_args(meta, ncc):
    """The metadata of ``ncc`` (computed when ``meta`` is None), checked,
    and 1 when it has the batch of ``ncc``, 0 when it is broadcast."""
    if meta is None:
        meta = tile_metadata(ncc)
    b, n, nnc = ncc.shape
    B = meta.nidx.shape[0]
    nt = -(-n // TILE)
    shapes = [tuple(t.shape) for t in meta]
    if (B not in (1, b) or shapes != [(B, nt, TILE * nnc), (B, nt),
                                      (B, nt * TILE, nnc)]
            or any(t.dtype != torch.int32 or t.device != ncc.device
                   or not t.is_contiguous() or t.data_ptr() % 16
                   for t in meta)):
        raise ValueError(f"tile metadata {shapes} does not fit ncc "
                         f"{tuple(ncc.shape)}: use tile_metadata(ncc)")
    return meta, int(B == b and b > 1)


_UNION_ROWS = WeakIdKeyDictionary()


def union_rows(meta, cs):
    """Rows per tile of the backward's dk/dv partials: ``cs`` times the
    largest union of ``meta``. Read from the device once per metadata (a
    host sync) and kept while its ``ucount`` lives."""
    if meta.ucount not in _UNION_ROWS:
        _UNION_ROWS[meta.ucount] = int(meta.ucount.max()) if \
            meta.ucount.numel() else 0
    return _UNION_ROWS[meta.ucount] * cs


def _launch(fn, name, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def _check_drop(c_):
    if c_ % 8:
        raise ValueError("attention dropout requires c_ % 8 == 0, as the "
                         "JAX package's fused dropout does")


def _drop_args(drop, c_, *rows):
    """The kernels' dropout scalars (on, seed as int32, threshold, scale)
    of ``drop = (rate, seed)`` or None; ``rows``: the tensors whose rows
    the kernels then read in 16-byte pieces, which must be aligned."""
    if drop is None:
        return [0, 0, 0, 1.0]
    _check_drop(c_)
    if any(t.data_ptr() % 16 for t in rows):
        raise ValueError("attention dropout on the card needs 16-byte "
                         "aligned q, kv, g_out and out")
    rate, seed = drop
    seed = (int(seed) + 2**31) % 2**32 - 2**31
    return [1, seed, *_drop_params(rate)]


# ---------------------------------------------------------------- ops ----
# Each kernel entry is a dispatcher op of the ``mlaff`` namespace, so that
# torch.export, FlopCounterMode, selective checkpointing and the profiler see
# it: a CPU kernel (the plain version), a CUDA kernel (the launch, counted), a
# fake kernel (shapes and dtypes only) and, for the forward, an autograd
# formula. The tile metadata travels as its three tensors (absent: the CUDA
# kernel makes it), dropout as its rate (0: none) and host seed, the query
# range as the token ``q0`` of q's first row. The backward returns the four
# small parameters' gradients as one flat vector (d_pe_kernel, d_pe_bias,
# d_blank_k, d_blank_v, each row-major), the kernel's per-tile rows summed
# once: an op's outputs may not share storage, and four copies would cost four
# launches.

_LIB = torch.library.Library("mlaff", "FRAGMENT")
_LIB.define(
    "cluster_attention_fwd(Tensor q, Tensor kv, Tensor ncc, Tensor pos, "
    "Tensor pe_kernel, Tensor pe_bias, Tensor blank_k, Tensor blank_v, "
    "Tensor? ucl, Tensor? ucount, Tensor? nidx, int num_heads, int cs, "
    "int rel_width, int clamp_width, float drop_rate, int drop_seed, "
    "bool want_stats, int q0=0) -> (Tensor out, Tensor stats)")
_LIB.define(
    "cluster_attention_bwd(Tensor q, Tensor kv, Tensor ncc, Tensor pos, "
    "Tensor pe_kernel, Tensor pe_bias, Tensor blank_k, Tensor blank_v, "
    "Tensor? ucl, Tensor? ucount, Tensor? nidx, Tensor g_out, Tensor? out, "
    "Tensor? stats, int num_heads, int cs, int rel_width, int clamp_width, "
    "float drop_rate, int drop_seed, int q0=0) -> (Tensor dq, Tensor dkv, "
    "Tensor d_small)")


def _drop(rate, seed):
    return (float(rate), int(seed)) if rate > 0.0 else None


def _meta(ucl, ucount, nidx):
    return None if ucl is None else TileMeta(ucl, ucount, nidx)


def _stats_dtype(q):
    return torch.promote_types(q.dtype, torch.float32)


def _fwd_cpu(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, blank_v, ucl,
             ucount, nidx, num_heads, cs, rel_width, clamp_width, drop_rate,
             drop_seed, want_stats, q0=0):
    res = cluster_attention_reference(
        q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, blank_v, num_heads, cs,
        rel_width, clamp_width, drop=_drop(drop_rate, drop_seed),
        want_stats=want_stats, q0=q0)
    if want_stats:
        return res
    return res, q.new_empty((0,), dtype=_stats_dtype(q))


def _fwd_cuda(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, blank_v, ucl,
              ucount, nidx, num_heads, cs, rel_width, clamp_width, drop_rate,
              drop_seed, want_stats, q0=0):
    _check_cuda_args(q, kv, ncc, pos, num_heads, q0)
    b, nq, c = q.shape
    n = kv.shape[1]
    h = num_heads
    drop = _drop(drop_rate, drop_seed)
    meta, batched = _meta_args(_meta(ucl, ucount, nidx), ncc)
    params = _small_params(q, h, pe_kernel, pe_bias, blank_k, blank_v)
    out = torch.empty_like(q)
    stats = torch.empty((b, nq, 2 * h) if want_stats else (0,),
                        dtype=torch.float32, device=q.device)
    fn = _build.library("cluster_attention").cluster_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 10
                   + [ctypes.c_longlong] + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch(fn, "cluster_attention_fwd", q.data_ptr(), kv.data_ptr(),
                pos.data_ptr(), *(t.data_ptr() for t in meta),
                *(t.data_ptr() for t in params), out.data_ptr(),
                stats.data_ptr() if want_stats else None, b, n, nq, q0, h,
                c // h, ncc.shape[2], cs, int(rel_width), int(clamp_width),
                pos.stride(0), batched, _DTYPE_CODE[q.dtype],
                *_drop_args(drop, c // h, q, kv, out), stream)
    fused_cluster_attention.launches += 1
    fused_cluster_attention.stats_launches += want_stats
    fused_cluster_attention.drop_launches += drop is not None
    fused_cluster_attention.range_launches += nq < n
    return out, stats


def _fwd_fake(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, blank_v, ucl,
              ucount, nidx, num_heads, cs, rel_width, clamp_width, drop_rate,
              drop_seed, want_stats, q0=0):
    b, n, _ = q.shape
    return (torch.empty_like(q, memory_format=torch.contiguous_format),
            q.new_empty((b, n, 2 * num_heads) if want_stats else (0,),
                        dtype=_stats_dtype(q)))


def _check_saved(q, saved, h):
    b, n, _ = q.shape
    out, stats = saved
    if (out.dtype != q.dtype or out.shape != q.shape
            or out.device != q.device or not out.is_contiguous()):
        raise ValueError("saved out must be q's dtype and shape, "
                         "contiguous on q's device")
    if (stats.dtype != torch.float32 or stats.shape != (b, n, 2 * h)
            or stats.device != q.device or not stats.is_contiguous()):
        raise ValueError(f"saved stats must be contiguous float32 "
                         f"{(b, n, 2 * h)} on q's device")


def _bwd_cpu(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, blank_v, ucl,
             ucount, nidx, g_out, out, stats, num_heads, cs, rel_width,
             clamp_width, drop_rate, drop_seed, q0=0):
    dq, dkv, *small = cluster_attention_backward_reference(
        q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, blank_v, g_out,
        num_heads, cs, rel_width, clamp_width,
        saved=None if out is None else (out, stats),
        drop=_drop(drop_rate, drop_seed), q0=q0)
    return (dq.contiguous(), dkv.contiguous(),
            torch.cat([t.reshape(-1) for t in small]))


def _bwd_cuda(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, blank_v, ucl,
              ucount, nidx, g_out, out, stats, num_heads, cs, rel_width,
              clamp_width, drop_rate, drop_seed, q0=0):
    _check_cuda_args(q, kv, ncc, pos, num_heads, q0)
    if g_out.dtype != q.dtype or g_out.shape != q.shape:
        raise ValueError(f"g_out must match q: {g_out.dtype} "
                         f"{tuple(g_out.shape)} vs {q.dtype} {tuple(q.shape)}")
    if g_out.device != q.device or not g_out.is_contiguous():
        raise ValueError("g_out must be contiguous on q's device")
    b, nq, c = q.shape
    n = kv.shape[1]
    h = num_heads
    c_ = c // h
    saved = None if out is None else (out, stats)
    if saved is not None:
        _check_saved(q, saved, h)
    if b * nq == 0:  # no query: nothing reads kv or the parameters
        return (torch.empty_like(q), torch.zeros_like(kv),
                pe_kernel.new_zeros((6 * h + 2 * c,)))
    drop = _drop(drop_rate, drop_seed)
    meta, batched = _meta_args(_meta(ucl, ucount, nidx), ncc)
    params = _small_params(q, h, pe_kernel, pe_bias, blank_k, blank_v)
    nt = -(-nq // TILE)
    ucap = union_rows(meta, cs)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dkv = torch.empty_like(kv)
    part = torch.empty(b * nt * ucap * 2 * c, **f32)
    rows = torch.empty((b * nt, 6 * h + 2 * c), **f32)
    name = ("cluster_attention_bwd" if saved is None
            else "cluster_attention_bwd_saved")
    fn = getattr(_build.library(name), name)
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 10
                   + [ctypes.c_longlong] + [ctypes.c_int] * 6
                   + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch(fn, "cluster_attention_bwd", q.data_ptr(), kv.data_ptr(),
                pos.data_ptr(), *(t.data_ptr() for t in meta),
                *(t.data_ptr() for t in params), g_out.data_ptr(),
                *((None, None) if saved is None
                  else (t.data_ptr() for t in saved)),
                dq.data_ptr(), dkv.data_ptr(), part.data_ptr(),
                rows.data_ptr(), b, n, nq, q0, h, c_, ncc.shape[2], cs,
                int(rel_width), int(clamp_width), pos.stride(0), batched,
                ucap, _DTYPE_CODE[q.dtype],
                *_drop_args(drop, c_, q, kv, g_out, *(saved or ())),
                stream)
    cluster_attention_backward.launches += 1
    cluster_attention_backward.saved_launches += saved is not None
    cluster_attention_backward.drop_launches += drop is not None
    cluster_attention_backward.range_launches += nq < n
    return dq, dkv, rows.sum(0).to(pe_kernel.dtype)


def _bwd_fake(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, blank_v, ucl,
              ucount, nidx, g_out, out, stats, num_heads, cs, rel_width,
              clamp_width, drop_rate, drop_seed, q0=0):
    return (q.new_empty(q.shape), kv.new_empty(kv.shape),
            pe_kernel.new_empty((6 * num_heads + 2 * q.shape[2],)))


def _fwd_setup(ctx, inputs, output):
    (q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, blank_v, ucl, ucount,
     nidx, num_heads, cs, rel_width, clamp_width, drop_rate, drop_seed,
     want_stats, q0) = inputs
    ctx.args = (num_heads, cs, rel_width, clamp_width)
    ctx.q0 = q0
    ctx.drop = _drop(drop_rate, drop_seed)
    ctx.saved_mode = want_stats
    ctx.mark_non_differentiable(output[1])
    ctx.save_for_backward(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k,
                          blank_v, ucl, ucount, nidx,
                          *(output if want_stats else ()))


def _fwd_backward(ctx, g_out, _g_stats):
    """With the statistics saved (the saved-stats mode) the backward takes
    them and the forward's output; else it recomputes the softmax. The
    forward and the backward share one tile metadata."""
    s = ctx.saved_tensors
    dq, dkv, dpk, dpb, dbk, dbv = cluster_attention_backward(
        *s[:8], g_out.to(s[0].dtype).contiguous(), *ctx.args,
        meta=_meta(*s[8:11]), saved=tuple(s[11:]) if ctx.saved_mode else None,
        drop=ctx.drop, q0=ctx.q0)
    return (dq, dkv, None, None, dpk, dpb, dbk, dbv) + (None,) * 11


_LIB.impl("cluster_attention_fwd", _fwd_cpu, "CPU")
_LIB.impl("cluster_attention_fwd", _fwd_cuda, "CUDA")
_LIB.impl("cluster_attention_bwd", _bwd_cpu, "CPU")
_LIB.impl("cluster_attention_bwd", _bwd_cuda, "CUDA")
torch.library.register_fake("mlaff::cluster_attention_fwd", _fwd_fake,
                            lib=_LIB)
torch.library.register_fake("mlaff::cluster_attention_bwd", _bwd_fake,
                            lib=_LIB)
torch.library.register_autograd("mlaff::cluster_attention_fwd",
                                _fwd_backward, setup_context=_fwd_setup,
                                lib=_LIB)


def cluster_attention_forward(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k,
                              blank_v, num_heads, cs, rel_width,
                              clamp_width=0, meta=None, drop=None,
                              want_stats=False, q0=0):
    """The forward, through the op ``mlaff::cluster_attention_fwd``: the
    CUDA kernel on a CUDA tensor (counted in
    ``fused_cluster_attention.launches``, and in its ``stats_launches``,
    ``drop_launches`` and ``range_launches`` where it writes the
    statistics, drops or takes a proper part of the tokens), the
    plain version on the CPU. ``drop = (rate, seed)`` with a host integer
    seed; ``want_stats``: also return the (b, nq, 2h) f32 statistics of
    :func:`cluster_attention_reference`; ``q0``: the token of q's first
    row (the query range). Differentiable (the op's autograd formula), the
    statistics excepted."""
    rate, seed = drop if drop is not None else (0.0, 0)
    meta = meta if meta is not None else (None, None, None)
    out, stats = torch.ops.mlaff.cluster_attention_fwd(
        q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, blank_v, *meta,
        num_heads, cs, int(rel_width), int(clamp_width), float(rate),
        int(seed), bool(want_stats), int(q0))
    return (out, stats) if want_stats else out


def cluster_attention_backward(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k,
                               blank_v, g_out, num_heads, cs, rel_width,
                               clamp_width=0, meta=None, saved=None,
                               drop=None, q0=0):
    """Gradients of the fused attention with respect to ``q, kv, pe_kernel,
    pe_bias, blank_k, blank_v``, each in its input's dtype, through the op
    ``mlaff::cluster_attention_bwd``.

    ``saved = (out, stats)``: the forward's output and statistics, the
    saved-stats mode; None recomputes them. ``drop = (rate, seed)``:
    the forward's dropout, replayed. ``q0``: the query range's first
    token; ``dkv`` then holds the range's share of every token's gradient.

    On a CUDA tensor this launches ``csrc/cluster_attention_bwd_saved.cu``
    with ``saved``, ``csrc/cluster_attention_bwd.cu`` without (and
    adds one to ``cluster_attention_backward.launches``, and to its
    ``saved_launches``, ``drop_launches`` and ``range_launches`` in those
    modes), with
    ``meta`` the :class:`TileMeta` of ``ncc`` (computed when None); on a
    CPU tensor it runs :func:`cluster_attention_backward_reference`. The
    CUDA path adds no float atomics: a repeated call gives the same bits.
    Its scratch is the tiles' dk/dv partials, ``b * ceil(n / TILE) *``
    :func:`union_rows` ``* 2c`` f32, and one row of ``6h + 2c`` f32
    parameter sums per (image, tile), summed here in a fixed order.
    """
    rate, seed = drop if drop is not None else (0.0, 0)
    meta = meta if meta is not None else (None, None, None)
    out, stats = saved if saved is not None else (None, None)
    dq, dkv, small = torch.ops.mlaff.cluster_attention_bwd(
        q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, blank_v, *meta, g_out,
        out, stats, num_heads, cs, int(rel_width), int(clamp_width),
        float(rate), int(seed), int(q0))
    params = (pe_kernel, pe_bias, blank_k, blank_v)
    return (dq, dkv, *(d.view(p.shape).to(p.dtype) for d, p in zip(
        torch.split(small, [p.numel() for p in params]), params)))


cluster_attention_backward.launches = 0
cluster_attention_backward.saved_launches = 0
cluster_attention_backward.drop_launches = 0
cluster_attention_backward.range_launches = 0


def fused_cluster_attention(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k,
                            blank_v, num_heads, cs, rel_width, clamp_width=0,
                            drop_rate=0.0, drop_seed=None, meta=None, q0=0):
    """Fused local cluster attention, differentiable in ``q, kv, pe_kernel,
    pe_bias, blank_k, blank_v``.

    Args:
        q: (b, nq, c) pre-scaled queries, token-major (head hi occupies
            channels [hi*c_, (hi+1)*c_), c_ = c // num_heads); cluster-ordered
            rows, the tokens ``[q0, q0 + nq)`` (nq = n: all). float32 or
            bfloat16 (float64 on the CPU).
        kv: (b, n, 2c) fused keys/values, channel structure (h, 2, c_).
        ncc: (b, nq, nnc) int32 nearest-cluster indices of q's rows.
        pos: (b, n, 2) float32 token positions (cluster-ordered).
        pe_kernel: (5, h) pos_embed weights; pe_bias: (h,).
        blank_k: (c_, h) blank-key slices; blank_v: (h, c_) blank values.
        num_heads: h. cs: cluster size. rel_width: R.
        clamp_width: table width for the MixRes clamp (0 = no clamp).
        drop_rate / drop_seed: post-softmax attention dropout of the slots
            and the blank (JAX ``_fca_drop``); a rate above 0 needs the
            seed, a host integer (:func:`draw_drop_seed`), whose masks
            (:func:`drop_keep`) are the same on every device and are
            replayed by the backward, and heads of c_ % 8 == 0 channels,
            as JAX's fused dropout does.
        meta: :func:`tile_metadata` of this same ``ncc``, which the CUDA
            kernels read instead of ``ncc``; computed here when None. Only
            its shapes are checked: metadata of another ``ncc`` gives
            attention over the wrong neighbourhoods. The CPU path does not
            use it.
        q0: the token of q's first row (the query range; 0 by default).

    Returns:
        out (b, nq, c) in q's dtype, the blank-token contribution included.
        When autograd records the call, the backward takes the forward's
        softmax statistics unless ``MLAFF_BWD_SAVED=0`` (:func:`saved_mode`).
    """
    drop = None
    if drop_rate > 0.0:
        if drop_seed is None:
            raise ValueError("drop_rate > 0 requires drop_seed")
        _check_drop(q.shape[-1] // num_heads)
        drop = (float(drop_rate), int(drop_seed))
    if meta is None and q.device.type == "cuda":
        meta = tile_metadata(ncc)  # one for the forward and the backward
    # the small parameters go to the accumulation type outside the op, with
    # differentiable casts, so their gradients reach the f32 params
    acc = torch.promote_types(q.dtype, torch.float32)
    small = [t.to(acc) for t in (pe_kernel, pe_bias, blank_k, blank_v)]
    stats = (torch.is_grad_enabled() and saved_mode()
             and any(t.requires_grad for t in (q, kv, *small)))
    res = cluster_attention_forward(
        q, kv, ncc, pos, *small, num_heads, cs, rel_width, clamp_width, meta,
        drop, want_stats=stats, q0=q0)
    return res[0] if stats else res


fused_cluster_attention.launches = 0
fused_cluster_attention.stats_launches = 0
fused_cluster_attention.drop_launches = 0
fused_cluster_attention.range_launches = 0
