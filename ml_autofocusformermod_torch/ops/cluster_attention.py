"""Fused local cluster attention (counterpart of ``fused_cluster_attention``
in the JAX package's ``ops/clusten_pallas.py``).

:func:`fused_cluster_attention` is a ``torch.autograd.Function`` on both
devices. Its forward launches the CUDA kernel ``csrc/cluster_attention.cu``
on a CUDA tensor and runs :func:`cluster_attention_reference`, the plain
PyTorch version, on a CPU tensor; its backward
(:func:`cluster_attention_backward`) launches ``csrc/cluster_attention_bwd.cu``
on a CUDA tensor and runs :func:`cluster_attention_backward_reference` on a
CPU tensor. There is no fallback between the two.

The kernels work on tiles of :data:`TILE` consecutive query rows: a block
stages the union of its tile's neighbour clusters in shared memory.
:func:`tile_metadata` computes that union per tile once per stage (the
model calls it where ``ncc`` is made and hands it to every block of the
stage, forward and backward; :func:`constant_tile_metadata` keeps that of
a constant ``ncc``, such as the on-grid stage's); without it the wrappers
compute it themselves.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch.utils.weak import WeakIdKeyDictionary

from . import _build
from .cluster_gather import cluster_token_index, gather_clusters

__all__ = ["fused_cluster_attention", "cluster_attention_reference",
           "cluster_attention_backward",
           "cluster_attention_backward_reference", "offset_features",
           "TILE", "TileMeta", "tile_metadata", "constant_tile_metadata",
           "union_rows"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
TILE = 64  # query rows per kernel tile, csrc/cluster_attention_tile.cuh::kTile


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
    tile_metadata.calls += 1
    if ncc.shape[0] > 1 and ncc.stride(0) == 0:
        ncc = ncc[:1]
    B, n, nnc = ncc.shape
    nt = -(-n // TILE)
    rows = ncc.long()
    if nt * TILE != n:
        rows = torch.cat([rows, rows[:, -1:].expand(B, nt * TILE - n, nnc)],
                         dim=1)
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


def constant_tile_metadata(ncc):
    """:func:`tile_metadata` of a constant (n, nnc) ``ncc`` that is
    broadcast over the batch (the on-grid stage's), computed once per
    tensor and kept while the tensor lives."""
    if ncc not in _CONST_META:
        _CONST_META[ncc] = tile_metadata(ncc[None])
    return _CONST_META[ncc]


def offset_features(dx, dy):
    """(..., 5) rel-pos features (dx, dy, dist, sin, cos) of the offsets
    ``(dx, dy)``; sin and cos are 0 where dist is 0."""
    dist = torch.sqrt(dx * dx + dy * dy)
    safe = torch.where(dist == 0, torch.ones_like(dist), dist)
    sin = torch.where(dist == 0, torch.zeros_like(dist), dy / safe)
    cos = torch.where(dist == 0, torch.zeros_like(dist), dx / safe)
    return torch.stack([dx, dy, dist, sin, cos], dim=-1)


def _rel_feat(pos, ncc, cs, rel_width, clamp_width):
    """(b, n, m, 5) rel-pos features of each query's neighbourhood slots
    (JAX package ``clusten_pallas.py:2920``)."""
    pos_g = gather_clusters(pos[:, None], ncc, cs)[:, 0]  # b n m 2
    rel = pos_g - pos[:, :, None, :]
    if clamp_width:
        rel = torch.clamp(rel + rel_width, 0, clamp_width - 1) - rel_width
    return offset_features(rel[..., 0], rel[..., 1])


def _softmax_parts(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, num_heads,
                   cs, rel_width, clamp_width):
    """The pieces the forward and backward share, in the accumulation type
    (f32, or f64 for f64 inputs): head-split q, gathered k and v, the
    rel-pos features, the padding mask and the normalised probabilities of
    the slots and of the blank token (``clusten_pallas.py:3080-3106``)."""
    b, n, c = q.shape
    h = num_heads
    c_ = c // h
    acc = torch.promote_types(q.dtype, torch.float32)
    pos = pos.to(acc)
    qh = q.to(acc).reshape(b, n, h, c_).permute(0, 2, 1, 3)  # b h n c_
    kvh = kv.to(acc).reshape(b, n, h, 2, c_)
    kh = kvh[..., 0, :].permute(0, 2, 1, 3)
    vh = kvh[..., 1, :].permute(0, 2, 1, 3)

    feat5 = _rel_feat(pos, ncc, cs, rel_width, clamp_width)  # b n m 5
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
    mx = torch.maximum(logits.amax(-1, keepdim=True), blank)
    p = torch.exp(logits - mx)  # exactly 0 at padded slots
    pb = torch.exp(blank - mx)
    denom = p.sum(-1, keepdim=True) + pb
    return qh, kg, vg, feat5, p / denom, pb / denom


def cluster_attention_reference(q, kv, ncc, pos, pe_kernel, pe_bias,
                                blank_k, blank_v, num_heads, cs, rel_width,
                                clamp_width=0):
    """Plain PyTorch version of the forward, in f32 (f64 for f64 inputs).

    Follows the algebra of the JAX package's oracle
    (``clusten_pallas.py:3080-3106``): gathered k/v, rel-pos bias, padded
    slots excluded from a joint softmax with the blank logit. Returns q's
    dtype.
    """
    b, n, c = q.shape
    _, _, vg, _, p, pb = _softmax_parts(
        q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, num_heads, cs,
        rel_width, clamp_width)
    out = torch.einsum("bhim,bhimc->bhic", p, vg)
    out = out + pb * blank_v.to(p.dtype)[None, :, None, :]
    return out.permute(0, 2, 1, 3).reshape(b, n, c).to(q.dtype)


def cluster_attention_backward_reference(q, kv, ncc, pos, pe_kernel,
                                         pe_bias, blank_k, blank_v, g_out,
                                         num_heads, cs, rel_width,
                                         clamp_width=0):
    """Plain PyTorch version of the backward, formula for formula the JAX
    package's oracle backward (``clusten_pallas.py:3080-3149``).

    Returns ``(dq, dkv, d_pe_kernel, d_pe_bias, d_blank_k, d_blank_v)``,
    each in its input's dtype. The scatter into dkv is an ``index_add_``
    over the slots' token rows (deterministic on the CPU).
    """
    b, n, c = q.shape
    h = num_heads
    c_ = c // h
    nnc = ncc.shape[-1]
    m = nnc * cs
    qh, kg, vg, feat5, p, pb = _softmax_parts(
        q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, num_heads, cs,
        rel_width, clamp_width)
    acc = p.dtype
    goh = g_out.to(acc).reshape(b, n, h, c_).permute(0, 2, 1, 3)
    bk = blank_k.to(acc).t()  # (h, c_)
    bv = blank_v.to(acc)  # (h, c_)

    dp = torch.einsum("bhic,bhimc->bhim", goh, vg)
    dpb = torch.einsum("bhic,hc->bhi", goh, bv)[..., None]
    s = (dp * p).sum(-1, keepdim=True) + dpb * pb
    dlogits = p * (dp - s)  # zero at padded slots, where p is 0
    dlb = pb * (dpb - s)  # b h n 1

    dqh = torch.einsum("bhim,bhimc->bhic", dlogits, kg)
    dqh = dqh + dlb * bk[None, :, None, :]
    d_pe_kernel = torch.einsum("bhnm,bnmf->fh", dlogits, feat5)
    d_pe_bias = dlogits.sum(dim=(0, 2, 3))
    d_blank_k = torch.einsum("bhic,bhi->ch", qh, dlb[..., 0])
    d_blank_v = torch.einsum("bhi,bhic->hc", pb[..., 0], goh)

    # scatter-add of the slots' dk / dv rows onto their tokens; padded slots
    # point past n into the zero-padded tail, which is cut off
    np_ = -(-n // cs) * cs
    rows = cluster_token_index(ncc, cs)  # b n m
    rows = rows + torch.arange(b, device=rows.device)[:, None, None] * np_
    dkg = qh[:, :, :, None, :] * dlogits[..., None]  # b h n m c_
    dvg = p[..., None] * goh[:, :, :, None, :]
    src = torch.stack([dkg, dvg], dim=-2)  # b h n m 2 c_
    src = src.permute(0, 2, 3, 1, 4, 5).reshape(b * n * m, h, 2, c_)
    dkv = torch.zeros(b * np_, h, 2, c_, dtype=acc, device=q.device)
    dkv.index_add_(0, rows.reshape(-1), src)
    dkv = dkv.reshape(b, np_, 2 * c)[:, :n]
    dq = dqh.permute(0, 2, 1, 3).reshape(b, n, c)
    return (dq.to(q.dtype), dkv.to(kv.dtype),
            d_pe_kernel.to(pe_kernel.dtype), d_pe_bias.to(pe_bias.dtype),
            d_blank_k.to(blank_k.dtype), d_blank_v.to(blank_v.dtype))


def _check_cuda_args(q, kv, ncc, pos, num_heads):
    b, n, c = q.shape
    dev = q.device
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if kv.dtype != q.dtype:
        raise TypeError(f"kv dtype {kv.dtype} != q dtype {q.dtype}")
    if c % num_heads:
        raise ValueError(f"channels {c} not divisible by {num_heads} heads")
    if tuple(kv.shape) != (b, n, 2 * c):
        raise ValueError(f"kv shape {tuple(kv.shape)} != {(b, n, 2 * c)}")
    if ncc.dtype != torch.int32 or ncc.dim() != 3 or ncc.shape[:2] != (b, n):
        raise ValueError(f"ncc must be int32 (b, n, nnc), got "
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


def _attention_forward(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k,
                       blank_v, num_heads, cs, rel_width, clamp_width,
                       meta=None):
    """The forward: the CUDA kernel on a CUDA tensor (counted in
    ``fused_cluster_attention.launches``), the plain version on the CPU."""
    if q.device.type == "cpu":
        return cluster_attention_reference(
            q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, blank_v,
            num_heads, cs, rel_width, clamp_width)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda_args(q, kv, ncc, pos, num_heads)
    b, n, c = q.shape
    h = num_heads
    meta, batched = _meta_args(meta, ncc)
    params = _small_params(q, h, pe_kernel, pe_bias, blank_k, blank_v)
    out = torch.empty_like(q)
    fn = _build.library("cluster_attention").cluster_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] + [ctypes.c_int] * 2
                   + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch(fn, "cluster_attention_fwd", q.data_ptr(), kv.data_ptr(),
                pos.data_ptr(), *(t.data_ptr() for t in meta),
                *(t.data_ptr() for t in params), out.data_ptr(), b, n, h,
                c // h, ncc.shape[2], cs, int(rel_width), int(clamp_width),
                pos.stride(0), batched, _DTYPE_CODE[q.dtype], stream)
    fused_cluster_attention.launches += 1
    return out


def cluster_attention_backward(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k,
                               blank_v, g_out, num_heads, cs, rel_width,
                               clamp_width=0, meta=None):
    """Gradients of the fused attention with respect to ``q, kv, pe_kernel,
    pe_bias, blank_k, blank_v``, each in its input's dtype.

    On a CUDA tensor this launches ``csrc/cluster_attention_bwd.cu`` (and
    adds one to ``cluster_attention_backward.launches``), with ``meta``
    the :class:`TileMeta` of ``ncc`` (computed when None); on a CPU tensor
    it runs :func:`cluster_attention_backward_reference`. The CUDA path
    adds no float atomics: a repeated call gives the same bits. Its
    scratch is the tiles' dk/dv partials, ``b * ceil(n / TILE) *``
    :func:`union_rows` ``* 2c`` f32, and one row of ``6h + 2c`` f32
    parameter sums per (image, tile), summed here in a fixed order.
    """
    if q.device.type == "cpu":
        return cluster_attention_backward_reference(
            q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, blank_v, g_out,
            num_heads, cs, rel_width, clamp_width)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda_args(q, kv, ncc, pos, num_heads)
    if g_out.dtype != q.dtype or g_out.shape != q.shape:
        raise ValueError(f"g_out must match q: {g_out.dtype} "
                         f"{tuple(g_out.shape)} vs {q.dtype} {tuple(q.shape)}")
    if g_out.device != q.device or not g_out.is_contiguous():
        raise ValueError("g_out must be contiguous on q's device")
    b, n, c = q.shape
    h = num_heads
    c_ = c // h
    meta, batched = _meta_args(meta, ncc)
    params = _small_params(q, h, pe_kernel, pe_bias, blank_k, blank_v)
    nt = -(-n // TILE)
    ucap = union_rows(meta, cs)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty_like(q)
    dkv = torch.empty_like(kv)
    part = torch.empty(b * nt * ucap * 2 * c, **f32)
    rows = torch.empty((b * nt, 6 * h + 2 * c), **f32)
    fn = _build.library("cluster_attention_bwd").cluster_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _launch(fn, "cluster_attention_bwd", q.data_ptr(), kv.data_ptr(),
                pos.data_ptr(), *(t.data_ptr() for t in meta),
                *(t.data_ptr() for t in params), g_out.data_ptr(),
                dq.data_ptr(), dkv.data_ptr(), part.data_ptr(),
                rows.data_ptr(), b, n, h, c_, ncc.shape[2], cs,
                int(rel_width), int(clamp_width), pos.stride(0), batched,
                ucap, _DTYPE_CODE[q.dtype], stream)
    cluster_attention_backward.launches += 1
    d_pe_kernel, d_pe_bias, d_blank_k, d_blank_v = torch.split(
        rows.sum(0), [5 * h, h, c_ * h, h * c_])
    return (dq, dkv,
            d_pe_kernel.reshape(5, h).to(pe_kernel.dtype),
            d_pe_bias.to(pe_bias.dtype),
            d_blank_k.reshape(c_, h).to(blank_k.dtype),
            d_blank_v.reshape(h, c_).to(blank_v.dtype))


cluster_attention_backward.launches = 0


class _FusedClusterAttention(torch.autograd.Function):
    """Forward and backward through the kernels (CUDA) or the plain
    versions (CPU); the backward recomputes the softmax. On the card the
    forward and the backward share one :class:`TileMeta`."""

    @staticmethod
    def forward(ctx, q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, blank_v,
                num_heads, cs, rel_width, clamp_width, meta):
        if q.device.type == "cuda":
            meta = _meta_args(meta, ncc)[0]
        ctx.args = (num_heads, cs, rel_width, clamp_width)
        ctx.tiles = meta
        ctx.save_for_backward(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k,
                              blank_v)
        return _attention_forward(q, kv, ncc, pos, pe_kernel, pe_bias,
                                  blank_k, blank_v, num_heads, cs, rel_width,
                                  clamp_width, meta)

    @staticmethod
    def backward(ctx, g_out):
        saved = ctx.saved_tensors
        q = saved[0]
        g_out = g_out.to(q.dtype).contiguous()
        dq, dkv, dpk, dpb, dbk, dbv = cluster_attention_backward(
            *saved, g_out, *ctx.args, meta=ctx.tiles)
        return (dq, dkv, None, None, dpk, dpb, dbk, dbv,
                None, None, None, None, None)


def fused_cluster_attention(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k,
                            blank_v, num_heads, cs, rel_width, clamp_width=0,
                            drop_rate=0.0, meta=None):
    """Fused local cluster attention, differentiable in ``q, kv, pe_kernel,
    pe_bias, blank_k, blank_v``.

    Args:
        q: (b, n, c) pre-scaled queries, token-major (head hi occupies
            channels [hi*c_, (hi+1)*c_), c_ = c // num_heads); cluster-ordered
            rows. float32 or bfloat16 (float64 on the CPU).
        kv: (b, n, 2c) fused keys/values, channel structure (h, 2, c_).
        ncc: (b, n, nnc) int32 nearest-cluster indices.
        pos: (b, n, 2) float32 token positions (cluster-ordered).
        pe_kernel: (5, h) pos_embed weights; pe_bias: (h,).
        blank_k: (c_, h) blank-key slices; blank_v: (h, c_) blank values.
        num_heads: h. cs: cluster size. rel_width: R.
        clamp_width: table width for the MixRes clamp (0 = no clamp).
        drop_rate: post-softmax attention dropout; only 0 is ported.
        meta: :func:`tile_metadata` of this same ``ncc``, which the CUDA
            kernels read instead of ``ncc``; computed here when None. Only
            its shapes are checked: metadata of another ``ncc`` gives
            attention over the wrong neighbourhoods. The CPU path does not
            use it.

    Returns:
        out (b, n, c) in q's dtype, the blank-token contribution included.
    """
    if drop_rate > 0.0:
        raise NotImplementedError(
            "attention-prob dropout inside the fused kernels is not ported "
            "(ROADMAP.md queue B item 7); every AFF preset has attn_drop 0")
    # the small parameters go to the accumulation type outside the Function,
    # with differentiable casts, so their gradients reach the f32 params
    acc = torch.promote_types(q.dtype, torch.float32)
    return _FusedClusterAttention.apply(
        q, kv, ncc, pos, pe_kernel.to(acc), pe_bias.to(acc),
        blank_k.to(acc), blank_v.to(acc), num_heads, cs, rel_width,
        clamp_width, meta)


fused_cluster_attention.launches = 0
