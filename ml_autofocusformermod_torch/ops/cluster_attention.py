"""Fused local cluster attention (counterpart of ``fused_cluster_attention``
in the JAX package's ``ops/clusten_pallas.py``).

:func:`fused_cluster_attention` launches the CUDA kernel
``csrc/cluster_attention.cu`` on a CUDA tensor and runs
:func:`cluster_attention_reference`, the plain PyTorch version, on a CPU
tensor. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .cluster_gather import cluster_token_index, gather_clusters

__all__ = ["fused_cluster_attention", "cluster_attention_reference",
           "offset_features"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SHMEM_LIMIT = 48 * 1024  # static-launch shared memory per block
_WARPS = 8  # warps per block, csrc/cluster_attention.cu::kWarps


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


def cluster_attention_reference(q, kv, ncc, pos, pe_kernel, pe_bias,
                                blank_k, blank_v, num_heads, cs, rel_width,
                                clamp_width=0):
    """Plain PyTorch version of :func:`fused_cluster_attention`, in f32.

    Follows the algebra of the JAX package's oracle
    (``clusten_pallas.py:3080-3106``): gathered k/v, rel-pos bias, padded
    slots excluded from a joint softmax with the blank logit. Returns q's
    dtype.
    """
    b, n, c = q.shape
    h = num_heads
    c_ = c // h
    pos = pos.float()
    qh = q.float().reshape(b, n, h, c_).permute(0, 2, 1, 3)  # b h n c_
    kvh = kv.float().reshape(b, n, h, 2, c_)
    kh = kvh[..., 0, :].permute(0, 2, 1, 3)
    vh = kvh[..., 1, :].permute(0, 2, 1, 3)

    feat5 = _rel_feat(pos, ncc, cs, rel_width, clamp_width)  # b n m 5
    bias = (
        torch.einsum("bnmf,fh->bhnm", feat5, pe_kernel.float())
        + pe_bias.float()[None, :, None, None]
    )
    pad_ok = (cluster_token_index(ncc, cs) < n)[:, None]  # b 1 n m
    kg = gather_clusters(kh, ncc, cs)  # b h n m c_
    vg = gather_clusters(vh, ncc, cs)
    logits = torch.einsum("bhic,bhimc->bhim", qh, kg) + bias
    logits = logits.masked_fill(~pad_ok, float("-inf"))
    blank = torch.einsum("bhic,ch->bhi", qh, blank_k.float())[..., None]
    mx = torch.maximum(logits.amax(-1, keepdim=True), blank)
    p = torch.exp(logits - mx)  # exactly 0 at padded slots
    pb = torch.exp(blank - mx)
    denom = p.sum(-1, keepdim=True) + pb
    out = torch.einsum("bhim,bhimc->bhic", p, vg)
    out = (out + pb * blank_v.float()[None, :, None, :]) / denom
    return out.permute(0, 2, 1, 3).reshape(b, n, c).to(q.dtype)


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


def fused_cluster_attention(q, kv, ncc, pos, pe_kernel, pe_bias, blank_k,
                            blank_v, num_heads, cs, rel_width, clamp_width=0):
    """Fused local cluster attention.

    Args:
        q: (b, n, c) pre-scaled queries, token-major (head hi occupies
            channels [hi*c_, (hi+1)*c_), c_ = c // num_heads); cluster-ordered
            rows. float32 or bfloat16.
        kv: (b, n, 2c) fused keys/values, channel structure (h, 2, c_).
        ncc: (b, n, nnc) int32 nearest-cluster indices.
        pos: (b, n, 2) float32 token positions (cluster-ordered).
        pe_kernel: (5, h) pos_embed weights; pe_bias: (h,).
        blank_k: (c_, h) blank-key slices; blank_v: (h, c_) blank values.
        num_heads: h. cs: cluster size. rel_width: R.
        clamp_width: table width for the MixRes clamp (0 = no clamp).

    Returns:
        out (b, n, c) in q's dtype, the blank-token contribution included.
    """
    if q.device.type == "cpu":
        return cluster_attention_reference(
            q, kv, ncc, pos, pe_kernel, pe_bias, blank_k, blank_v,
            num_heads, cs, rel_width, clamp_width)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    _check_cuda_args(q, kv, ncc, pos, num_heads)
    b, n, c = q.shape
    h = num_heads
    c_ = c // h
    nnc = ncc.shape[2]
    shmem = 4 * _WARPS * (c_ + 2 * nnc * cs)
    if shmem > _SHMEM_LIMIT:
        raise ValueError(f"c_={c_}, m={nnc * cs} need {shmem} B of shared "
                         f"memory per block (limit {_SHMEM_LIMIT})")
    f32 = dict(device=q.device, dtype=torch.float32)
    pe_kernel = pe_kernel.detach().to(**f32).contiguous()
    pe_bias = pe_bias.detach().to(**f32).contiguous()
    blank_k = blank_k.detach().to(**f32).contiguous()
    blank_v = blank_v.detach().to(**f32).contiguous()
    if (tuple(pe_kernel.shape) != (5, h) or tuple(pe_bias.shape) != (h,)
            or tuple(blank_k.shape) != (c_, h)
            or tuple(blank_v.shape) != (h, c_)):
        raise ValueError("pe_kernel/pe_bias/blank_k/blank_v shapes must be "
                         f"(5,{h})/({h},)/({c_},{h})/({h},{c_})")
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
                blank_v.data_ptr(), out.data_ptr(), b, n, h, c_, nnc, cs,
                int(rel_width), int(clamp_width), ncc.stride(0),
                pos.stride(0), _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"cluster_attention_fwd launch failed: CUDA error {rc}")
    fused_cluster_attention.launches += 1
    return out


fused_cluster_attention.launches = 0
