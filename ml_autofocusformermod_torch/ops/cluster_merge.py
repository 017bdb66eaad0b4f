"""Fused PointConv cluster merge (counterpart of ``fused_cluster_merge`` in
the JAX package's ``ops/merge_pallas.py``).

:func:`fused_cluster_merge` launches the CUDA kernel
``csrc/cluster_merge.cu`` on a CUDA tensor and runs
:func:`cluster_merge_reference`, the plain PyTorch version, on a CPU
tensor. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .cluster_gather import gather_clusters
from .clusten import wf_contract

__all__ = ["fused_cluster_merge", "cluster_merge_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_IC = 4  # csrc/cluster_merge.cu::kIC
_SHMEM_LIMIT = 48 * 1024


def cluster_merge_reference(weights, feat, ncc, cluster_size):
    """Plain version: gather + ``wf_contract`` (JAX ``merge_pallas.py:641``)."""
    feat_g = gather_clusters(
        feat[:, None].to(weights.dtype), ncc, cluster_size
    )[:, 0]
    return wf_contract(weights, feat_g)


def fused_cluster_merge(weights, feat, ncc, cluster_size):
    """PointConv merge over cluster neighbourhoods.

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
    if weights.device.type == "cpu":
        return cluster_merge_reference(weights, feat, ncc, cluster_size)
    if weights.device.type != "cuda":
        raise ValueError(f"unsupported device {weights.device}")
    b, n_, m, ic = weights.shape
    n, c = feat.shape[1], feat.shape[2]
    nnc = ncc.shape[-1]
    cs = cluster_size
    if weights.dtype not in _DTYPE_CODE or feat.dtype != weights.dtype:
        raise TypeError(f"weights/feat must share float32 or bfloat16, got "
                        f"{weights.dtype}/{feat.dtype}")
    if ic != _IC or m != nnc * cs:
        raise ValueError(f"weights (b, n', m, ic) needs ic={_IC}, m=nnc*cs; "
                         f"got {tuple(weights.shape)} with nnc={nnc}, cs={cs}")
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
                out.data_ptr(), b, n, n_, c, nnc, cs,
                _DTYPE_CODE[weights.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"cluster_merge_fwd launch failed: CUDA error {rc}")
    fused_cluster_merge.launches += 1
    return out


fused_cluster_merge.launches = 0
