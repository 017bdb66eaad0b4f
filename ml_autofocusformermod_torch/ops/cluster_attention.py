"""Fused local cluster attention (counterpart of ``fused_cluster_attention``
in the JAX package's ``ops/clusten_pallas.py``).

:func:`fused_cluster_attention` is a ``torch.autograd.Function`` on both
devices. Its forward launches the CUDA kernel ``csrc/cluster_attention.cu``
on a CUDA tensor and runs :func:`cluster_attention_reference`, the plain
PyTorch version, on a CPU tensor; its backward
(:func:`cluster_attention_backward`) launches ``csrc/cluster_attention_bwd.cu``
on a CUDA tensor and runs :func:`cluster_attention_backward_reference` on a
CPU tensor. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .cluster_gather import cluster_token_index, gather_clusters

__all__ = ["fused_cluster_attention", "cluster_attention_reference",
           "cluster_attention_backward",
           "cluster_attention_backward_reference", "offset_features"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SHMEM_LIMIT = 48 * 1024  # static-launch shared memory per block
_WARPS = 8  # warps per block, csrc/cluster_attention{,_bwd}.cu::kWarps


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


def _check_shmem(q, num_heads, nnc, cs, backward):
    """Raise when a block of the forward or backward kernel would need more
    shared memory than a static launch gets."""
    c = q.shape[2]
    c_ = c // num_heads
    m = nnc * cs
    if backward:
        shmem = 4 * (6 * num_heads + 2 * c + _WARPS * (2 * c_ + 3 * m))
    else:
        shmem = 4 * _WARPS * (c_ + 2 * m)
    if shmem > _SHMEM_LIMIT:
        raise ValueError(f"c_={c_}, m={m} need {shmem} B of shared memory "
                         f"per block (limit {_SHMEM_LIMIT})")


def _attention_forward(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k,
                       blank_v, num_heads, cs, rel_width, clamp_width):
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
    nnc = ncc.shape[2]
    _check_shmem(q, h, nnc, cs, backward=False)
    pe_kernel, pe_bias, blank_k, blank_v = _small_params(
        q, h, pe_kernel, pe_bias, blank_k, blank_v)
    out = torch.empty_like(q)
    lib = _build.library("cluster_attention")
    fn = lib.cluster_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), kv.data_ptr(), ncc.data_ptr(), pos.data_ptr(),
                pe_kernel.data_ptr(), pe_bias.data_ptr(), blank_k.data_ptr(),
                blank_v.data_ptr(), out.data_ptr(), b, n, h, c // h, nnc, cs,
                int(rel_width), int(clamp_width), ncc.stride(0),
                pos.stride(0), _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"cluster_attention_fwd launch failed: CUDA error {rc}")
    fused_cluster_attention.launches += 1
    return out


def cluster_attention_backward(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k,
                               blank_v, g_out, num_heads, cs, rel_width,
                               clamp_width=0):
    """Gradients of the fused attention with respect to ``q, kv, pe_kernel,
    pe_bias, blank_k, blank_v``, each in its input's dtype.

    On a CUDA tensor this launches ``csrc/cluster_attention_bwd.cu`` (and
    adds one to ``cluster_attention_backward.launches``); on a CPU tensor it
    runs :func:`cluster_attention_backward_reference`.
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
    nnc = ncc.shape[2]
    _check_shmem(q, h, nnc, cs, backward=True)
    params = _small_params(q, h, pe_kernel, pe_bias, blank_k, blank_v)
    dq = torch.empty_like(q)
    dkv = torch.zeros((b, n, 2 * c), dtype=torch.float32, device=q.device)
    dparams = torch.zeros(6 * h + 2 * c, dtype=torch.float32, device=q.device)
    lib = _build.library("cluster_attention_bwd")
    fn = lib.cluster_attention_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 8
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), kv.data_ptr(), ncc.data_ptr(), pos.data_ptr(),
                *(t.data_ptr() for t in params), g_out.data_ptr(),
                dq.data_ptr(), dkv.data_ptr(), dparams.data_ptr(), b, n, h,
                c_, nnc, cs, int(rel_width), int(clamp_width), ncc.stride(0),
                pos.stride(0), _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"cluster_attention_bwd launch failed: CUDA error {rc}")
    cluster_attention_backward.launches += 1
    d_pe_kernel, d_pe_bias, d_blank_k, d_blank_v = torch.split(
        dparams, [5 * h, h, c_ * h, h * c_])
    return (dq, dkv.to(kv.dtype),
            d_pe_kernel.reshape(5, h).to(pe_kernel.dtype),
            d_pe_bias.to(pe_bias.dtype),
            d_blank_k.reshape(c_, h).to(blank_k.dtype),
            d_blank_v.reshape(h, c_).to(blank_v.dtype))


cluster_attention_backward.launches = 0


class _FusedClusterAttention(torch.autograd.Function):
    """Forward and backward through the kernels (CUDA) or the plain
    versions (CPU); the backward recomputes the softmax."""

    @staticmethod
    def forward(ctx, q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, blank_v,
                num_heads, cs, rel_width, clamp_width):
        ctx.meta = (num_heads, cs, rel_width, clamp_width)
        ctx.save_for_backward(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k,
                              blank_v)
        return _attention_forward(q, kv, ncc, pos, pe_kernel, pe_bias,
                                  blank_k, blank_v, num_heads, cs, rel_width,
                                  clamp_width)

    @staticmethod
    def backward(ctx, g_out):
        saved = ctx.saved_tensors
        q = saved[0]
        g_out = g_out.to(q.dtype).contiguous()
        dq, dkv, dpk, dpb, dbk, dbv = cluster_attention_backward(
            *saved, g_out, *ctx.meta)
        return (dq, dkv, None, None, dpk, dpb, dbk, dbv,
                None, None, None, None)


def fused_cluster_attention(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k,
                            blank_v, num_heads, cs, rel_width, clamp_width=0,
                            drop_rate=0.0):
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
        clamp_width)


fused_cluster_attention.launches = 0
