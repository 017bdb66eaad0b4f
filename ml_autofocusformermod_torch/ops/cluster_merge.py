"""Fused PointConv cluster merge (counterpart of ``fused_cluster_merge`` in
the JAX package's ``ops/merge_pallas.py``).

:func:`fused_cluster_merge` is a ``torch.autograd.Function`` on both
devices. Its forward launches the CUDA kernel ``csrc/cluster_merge.cu`` on a
CUDA tensor and runs :func:`cluster_merge_reference`, the plain PyTorch
version, on a CPU tensor; its backward (:func:`cluster_merge_backward`)
launches ``csrc/cluster_merge_bwd.cu`` on a CUDA tensor and runs
:func:`cluster_merge_backward_reference` on a CPU tensor. There is no
fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .cluster_gather import cluster_token_index, gather_clusters
from .clusten import wf_contract

__all__ = ["fused_cluster_merge", "cluster_merge_reference",
           "cluster_merge_backward", "cluster_merge_backward_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_IC = 4  # csrc/cluster_merge{,_bwd}.cu::kIC
_SHMEM_LIMIT = 48 * 1024


def cluster_merge_reference(weights, feat, ncc, cluster_size):
    """Plain version: gather + ``wf_contract`` (JAX ``merge_pallas.py:641``)."""
    feat_g = gather_clusters(
        feat[:, None].to(weights.dtype), ncc, cluster_size
    )[:, 0]
    return wf_contract(weights, feat_g)


def cluster_merge_backward_reference(weights, feat, ncc, cluster_size, g):
    """Plain backward of the merge (the JAX package's ``_merge_bwd_impl``,
    ``merge_pallas.py:596-638``): ``(dw, dfeat)``.

    ``dw[t,(j,s),i] = sum_c g[t,i,c] feat[r,c]`` in the weights' dtype, and
    ``dfeat[r,c] = sum over the slots that read row r of sum_i w g``,
    accumulated in f32 (f64 for f64 inputs) by ``index_add_`` and returned
    in feat's dtype. ``r = ncc[t,j]*cs + s``; padded rows (``r >= n``) are
    dropped.
    """
    b, n_, m, ic = weights.shape
    n, c = feat.shape[1], feat.shape[2]
    cs = cluster_size
    acc = torch.promote_types(weights.dtype, torch.float32)
    w = weights.to(acc)
    gf = g.to(acc)
    feat_g = gather_clusters(feat[:, None].to(acc), ncc, cs)[:, 0]  # b n' m c
    dw = torch.einsum("bnic,bnmc->bnmi", gf, feat_g)
    np_ = -(-n // cs) * cs
    rows = cluster_token_index(ncc, cs)  # b n' m
    rows = rows + torch.arange(b, device=rows.device)[:, None, None] * np_
    src = torch.einsum("bnmi,bnic->bnmc", w, gf).reshape(b * n_ * m, c)
    dfeat = torch.zeros(b * np_, c, dtype=acc, device=feat.device)
    dfeat.index_add_(0, rows.reshape(-1), src)
    dfeat = dfeat.reshape(b, np_, c)[:, :n]
    return dw.to(weights.dtype), dfeat.to(feat.dtype)


def _check_cuda_args(weights, feat, ncc, cluster_size):
    b, n_, m, ic = weights.shape
    nnc = ncc.shape[-1]
    if weights.dtype not in _DTYPE_CODE or feat.dtype != weights.dtype:
        raise TypeError(f"weights/feat must share float32 or bfloat16, got "
                        f"{weights.dtype}/{feat.dtype}")
    if ic != _IC or m != nnc * cluster_size:
        raise ValueError(f"weights (b, n', m, ic) needs ic={_IC}, m=nnc*cs; "
                         f"got {tuple(weights.shape)} with nnc={nnc}, "
                         f"cs={cluster_size}")
    if feat.shape[0] != b or tuple(ncc.shape[:2]) != (b, n_):
        raise ValueError("batch / centre counts of weights, feat, ncc differ")
    if ncc.dtype != torch.int32:
        raise TypeError(f"ncc must be int32, got {ncc.dtype}")
    for name, t in (("feat", feat), ("ncc", ncc)):
        if t.device != weights.device:
            raise ValueError(f"{name} on {t.device}, weights on {weights.device}")
    if not (weights.is_contiguous() and feat.is_contiguous()
            and ncc.is_contiguous()):
        raise ValueError("weights, feat and ncc must be contiguous")


def _merge_forward(weights, feat, ncc, cluster_size):
    """The forward: the CUDA kernel on a CUDA tensor (counted in
    ``fused_cluster_merge.launches``), the plain version on the CPU."""
    if weights.device.type == "cpu":
        return cluster_merge_reference(weights, feat, ncc, cluster_size)
    if weights.device.type != "cuda":
        raise ValueError(f"unsupported device {weights.device}")
    _check_cuda_args(weights, feat, ncc, cluster_size)
    b, n_, m, ic = weights.shape
    n, c = feat.shape[1], feat.shape[2]
    nnc = ncc.shape[-1]
    tx = min(-(-c // 32) * 32, 256)
    shmem = 4 * (256 // tx) * m * (_IC + 1)
    if shmem > _SHMEM_LIMIT:
        raise ValueError(f"m={m} needs {shmem} B of shared memory per block")
    out = torch.empty((b, n_, ic, c), dtype=weights.dtype,
                      device=weights.device)
    lib = _build.library("cluster_merge")
    fn = lib.cluster_merge_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    with torch.cuda.device(weights.device):
        stream = torch.cuda.current_stream(weights.device).cuda_stream
        rc = fn(weights.data_ptr(), feat.data_ptr(), ncc.data_ptr(),
                out.data_ptr(), b, n, n_, c, nnc, cluster_size,
                _DTYPE_CODE[weights.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"cluster_merge_fwd launch failed: CUDA error {rc}")
    fused_cluster_merge.launches += 1
    return out


def cluster_merge_backward(weights, feat, ncc, cluster_size, g):
    """``(dw, dfeat)`` of the merge for the output gradient ``g``
    ``(b, n', ic, c)``: dw in the weights' dtype, dfeat accumulated in f32
    and returned in feat's dtype.

    On a CUDA tensor this launches ``csrc/cluster_merge_bwd.cu`` (and adds
    one to ``cluster_merge_backward.launches``); on a CPU tensor it runs
    :func:`cluster_merge_backward_reference`.
    """
    if weights.device.type == "cpu":
        return cluster_merge_backward_reference(weights, feat, ncc,
                                                cluster_size, g)
    if weights.device.type != "cuda":
        raise ValueError(f"unsupported device {weights.device}")
    _check_cuda_args(weights, feat, ncc, cluster_size)
    b, n_, m, ic = weights.shape
    n, c = feat.shape[1], feat.shape[2]
    nnc = ncc.shape[-1]
    if (g.dtype != weights.dtype or tuple(g.shape) != (b, n_, ic, c)
            or g.device != weights.device or not g.is_contiguous()):
        raise ValueError(f"g must be contiguous {weights.dtype} "
                         f"{(b, n_, ic, c)} on {weights.device}, got "
                         f"{g.dtype} {tuple(g.shape)}")
    dw = torch.empty_like(weights)
    dfeat = torch.zeros((b, n, c), dtype=torch.float32, device=feat.device)
    lib = _build.library("cluster_merge_bwd")
    fn = lib.cluster_merge_bwd
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    with torch.cuda.device(weights.device):
        stream = torch.cuda.current_stream(weights.device).cuda_stream
        rc = fn(weights.data_ptr(), feat.data_ptr(), ncc.data_ptr(),
                g.data_ptr(), dw.data_ptr(), dfeat.data_ptr(), b, n, n_, c,
                nnc, cluster_size, _DTYPE_CODE[weights.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"cluster_merge_bwd launch failed: CUDA error {rc}")
    cluster_merge_backward.launches += 1
    return dw, dfeat.to(feat.dtype)


cluster_merge_backward.launches = 0


class _FusedClusterMerge(torch.autograd.Function):
    """Forward and backward through the kernels (CUDA) or the plain
    versions (CPU)."""

    @staticmethod
    def forward(ctx, weights, feat, ncc, cluster_size):
        ctx.cluster_size = cluster_size
        ctx.save_for_backward(weights, feat, ncc)
        return _merge_forward(weights, feat, ncc, cluster_size)

    @staticmethod
    def backward(ctx, g):
        weights, feat, ncc = ctx.saved_tensors
        g = g.to(weights.dtype).contiguous()
        dw, dfeat = cluster_merge_backward(weights, feat, ncc,
                                           ctx.cluster_size, g)
        return dw, dfeat, None, None


def fused_cluster_merge(weights, feat, ncc, cluster_size):
    """PointConv merge over cluster neighbourhoods, differentiable in
    ``weights`` and ``feat``.

    Args:
        weights: ``(b, n', m, ic)`` pointconv weights, ``m = nnc * cs``
            member-major (cluster j's slot s at ``j*cs + s``), ic = 4.
        feat: ``(b, n, c)`` cluster-ordered token features, weights' dtype.
        ncc: ``(b, n', nnc)`` int32 nearest-cluster indices per centre.
        cluster_size: ``cs``.

    Returns:
        ``(b, n', ic, c)`` in weights' dtype; rows of the padded last
        cluster contribute zero; accumulation in f32.
    """
    return _FusedClusterMerge.apply(weights, feat, ncc, cluster_size)


fused_cluster_merge.launches = 0
