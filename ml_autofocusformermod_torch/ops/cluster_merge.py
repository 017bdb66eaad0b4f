"""Fused PointConv cluster merge (counterpart of ``fused_cluster_merge`` in
the JAX package's ``ops/merge_pallas.py``).

The forward, the backward and the backward's inverse index are dispatcher
ops (``torch.ops.mlaff.cluster_merge_fwd``, ``..._bwd``,
``...merge_inverse_index``), each with a fake kernel, the forward with an
autograd formula. On a CUDA tensor the forward launches the CUDA kernel
``csrc/cluster_merge.cu`` and the backward ``csrc/cluster_merge_bwd.cu``;
on a CPU tensor they run :func:`cluster_merge_reference` and
:func:`cluster_merge_backward_reference`, the plain PyTorch versions.
There is no fallback between the two. The backward kernel owns clusters,
not centres: :func:`merge_inverse_index` (a counting-sort kernel on the
card, its plain version :func:`merge_inverse_index_reference` on the CPU)
lists, per cluster, the (centre, slot) pairs that name it, so every dw and
dfeat entry is written once, without atomics, and the gradients are
bitwise reproducible on the card.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build
from .cluster_gather import cluster_token_index, gather_clusters
from .clusten import wf_contract

__all__ = ["fused_cluster_merge", "cluster_merge_reference",
           "cluster_merge_backward", "cluster_merge_backward_reference",
           "MergeIndex", "merge_inverse_index",
           "merge_inverse_index_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_IC = 4  # csrc/cluster_merge_tile.cuh::kIC


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


def _aligned(t):
    """``t``, or a copy of it when its data does not start 16-byte aligned
    (the kernels read rows in 16-byte pieces)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


_ENTRY = {}


def _launch(lib, name, n_ptr, device, *args):
    """Calls the C entry point ``name`` of ``csrc/<lib>.cu`` (pointers,
    then ints, then the stream) on ``device``'s current stream; returns
    its cudaError_t. The entry point is typed once: the wrappers sit on
    the model's host-bound path."""
    fn = _ENTRY.get(name)
    if fn is None:
        fn = getattr(_build.library(lib), name)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr
                       + [ctypes.c_int] * (len(args) - n_ptr)
                       + [ctypes.c_void_p])
        _ENTRY[name] = fn
    index = device.index
    if index is not None and index != torch.cuda.current_device():
        with torch.cuda.device(device):
            return fn(*args, torch.cuda.current_stream(device).cuda_stream)
    return fn(*args, torch.cuda.current_stream(device).cuda_stream)


_LIB = torch.library.Library("mlaff", "FRAGMENT")
_LIB.define("cluster_merge_fwd(Tensor weights, Tensor feat, Tensor ncc, "
            "int cluster_size) -> Tensor")
_LIB.define("cluster_merge_bwd(Tensor weights, Tensor feat, Tensor ncc, "
            "int cluster_size, Tensor g) -> (Tensor dw, Tensor dfeat)")
_LIB.define("merge_inverse_index(Tensor ncc, int n, int cluster_size) -> "
            "(Tensor entry, Tensor offset)")


def _fwd_cuda(weights, feat, ncc, cluster_size):
    """The forward kernel, counted in ``fused_cluster_merge.launches``."""
    _check_cuda_args(weights, feat, ncc, cluster_size)
    weights, feat = _aligned(weights), _aligned(feat)
    b, n_, m, ic = weights.shape
    n, c = feat.shape[1], feat.shape[2]
    nnc = ncc.shape[-1]
    out = torch.empty((b, n_, ic, c), dtype=weights.dtype,
                      device=weights.device)
    rc = _launch("cluster_merge", "cluster_merge_fwd", 4, weights.device,
                 weights.data_ptr(), feat.data_ptr(), ncc.data_ptr(),
                 out.data_ptr(), b, n, n_, c, nnc, cluster_size,
                 _DTYPE_CODE[weights.dtype])
    if rc != 0:
        raise RuntimeError(f"cluster_merge_fwd launch failed: CUDA error {rc}")
    fused_cluster_merge.launches += 1
    return out


def _fwd_fake(weights, feat, ncc, cluster_size):
    b, n_, _, ic = weights.shape
    return weights.new_empty((b, n_, ic, feat.shape[2]))


class MergeIndex(NamedTuple):
    """The clusters' lists of the (centre, slot) pairs that name them.

    ``entry`` (b, n' * nnc) int32: per image, the flat pairs ``t * nnc + j``
    ordered by cluster ``ncc[t, j]``, ties by ``(t, j)`` ascending;
    ``offset`` (b, k + 1) int32: cluster ``kappa``'s list is
    ``entry[bi, offset[bi, kappa]:offset[bi, kappa + 1]]``.
    """

    entry: torch.Tensor
    offset: torch.Tensor


def merge_inverse_index_reference(ncc, n, cluster_size):
    """Plain version of :func:`merge_inverse_index`: one stable sort of the
    flattened ids and a ``searchsorted`` for the bounds."""
    b, n_, nnc = ncc.shape
    k = -(-n // cluster_size)
    image = torch.arange(b, dtype=torch.int32, device=ncc.device)[:, None]
    key = (ncc.reshape(b, n_ * nnc) + image * k).reshape(-1)
    srt, order = torch.sort(key, stable=True)
    entry = (order.view(b, n_ * nnc) - image * (n_ * nnc)).to(torch.int32)
    # each image's k + 1 cluster bounds among its own sorted ids
    bounds = image * k + torch.arange(k + 1, dtype=torch.int32,
                                      device=ncc.device)
    offset = torch.searchsorted(srt, bounds) - image * (n_ * nnc)
    return MergeIndex(entry, offset.to(torch.int32))


def _index_cuda(ncc, n, cluster_size):
    """The counting-sort kernel, counted in
    ``merge_inverse_index.launches``."""
    if ncc.dtype != torch.int32 or not ncc.is_contiguous():
        raise TypeError("ncc must be contiguous int32")
    b, n_, nnc = ncc.shape
    k = -(-n // cluster_size)
    # separate allocations, each 16-byte aligned as the kernel reads them
    entry = torch.empty((b, n_ * nnc), dtype=torch.int32, device=ncc.device)
    offset = torch.empty((b, k + 1), dtype=torch.int32, device=ncc.device)
    rc = _launch("cluster_merge_bwd", "merge_inverse_index", 3, ncc.device,
                 ncc.data_ptr(), entry.data_ptr(), offset.data_ptr(), b,
                 n_ * nnc, k)
    if rc != 0:
        raise RuntimeError(f"merge_inverse_index launch failed: CUDA error "
                           f"{rc}")
    merge_inverse_index.launches += 1
    return entry, offset


def _index_fake(ncc, n, cluster_size):
    b, n_, nnc = ncc.shape
    k = -(-n // cluster_size)
    return (ncc.new_empty((b, n_ * nnc), dtype=torch.int32),
            ncc.new_empty((b, k + 1), dtype=torch.int32))


def merge_inverse_index(ncc, n, cluster_size):
    """:class:`MergeIndex` of the (b, n', nnc) int32 cluster indices ``ncc``
    (each in ``[0, k)``, ``k = ceil(n / cluster_size)``), on ``ncc``'s
    device, through the op ``mlaff::merge_inverse_index``. Counted in
    ``merge_inverse_index.calls``. On a CUDA tensor one launch of the
    counting sort in ``csrc/cluster_merge_bwd.cu`` (counted in
    ``merge_inverse_index.launches``); on a CPU tensor
    :func:`merge_inverse_index_reference`."""
    merge_inverse_index.calls += 1
    return MergeIndex(*torch.ops.mlaff.merge_inverse_index(
        ncc, n, cluster_size))


merge_inverse_index.calls = 0
merge_inverse_index.launches = 0


def _fwd_cpu(weights, feat, ncc, cluster_size):
    return cluster_merge_reference(weights, feat, ncc,
                                   cluster_size).contiguous()


def _bwd_cpu(weights, feat, ncc, cluster_size, g):
    # dfeat is a slice of the padded rows: contiguous, as the fake says
    return tuple(t.contiguous() for t in cluster_merge_backward_reference(
        weights, feat, ncc, cluster_size, g))


def _bwd_cuda(weights, feat, ncc, cluster_size, g):
    """The backward kernel on the :func:`merge_inverse_index` of ``ncc``,
    counted in ``cluster_merge_backward.launches``."""
    _check_cuda_args(weights, feat, ncc, cluster_size)
    b, n_, m, ic = weights.shape
    n, c = feat.shape[1], feat.shape[2]
    nnc = ncc.shape[-1]
    if (g.dtype != weights.dtype or tuple(g.shape) != (b, n_, ic, c)
            or g.device != weights.device or not g.is_contiguous()):
        raise ValueError(f"g must be contiguous {weights.dtype} "
                         f"{(b, n_, ic, c)} on {weights.device}, got "
                         f"{g.dtype} {tuple(g.shape)}")
    weights, feat, g = _aligned(weights), _aligned(feat), _aligned(g)
    index = merge_inverse_index(ncc, n, cluster_size)
    dw = torch.empty_like(weights)
    dfeat = torch.empty_like(feat)
    rc = _launch("cluster_merge_bwd", "cluster_merge_bwd", 7, weights.device,
                 weights.data_ptr(), feat.data_ptr(), g.data_ptr(),
                 index.entry.data_ptr(), index.offset.data_ptr(),
                 dw.data_ptr(), dfeat.data_ptr(), b, n, n_, c, nnc,
                 cluster_size, _DTYPE_CODE[weights.dtype])
    if rc != 0:
        raise RuntimeError(f"cluster_merge_bwd launch failed: CUDA error {rc}")
    cluster_merge_backward.launches += 1
    return dw, dfeat


def _bwd_fake(weights, feat, ncc, cluster_size, g):
    return weights.new_empty(weights.shape), feat.new_empty(feat.shape)


def cluster_merge_backward(weights, feat, ncc, cluster_size, g):
    """``(dw, dfeat)`` of the merge for the output gradient ``g``
    ``(b, n', ic, c)``: dw in the weights' dtype, dfeat summed in f32 and
    returned in feat's dtype, through the op ``mlaff::cluster_merge_bwd``.

    On a CUDA tensor this makes the :func:`merge_inverse_index` of ``ncc``
    and launches ``csrc/cluster_merge_bwd.cu`` on it (adding one to
    ``cluster_merge_backward.launches``); on a CPU tensor it runs
    :func:`cluster_merge_backward_reference`.
    """
    return torch.ops.mlaff.cluster_merge_bwd(weights, feat, ncc,
                                             cluster_size, g)


cluster_merge_backward.launches = 0


def _fwd_setup(ctx, inputs, output):
    weights, feat, ncc, cluster_size = inputs
    ctx.cluster_size = cluster_size
    ctx.save_for_backward(weights, feat, ncc)


def _fwd_backward(ctx, g):
    weights, feat, ncc = ctx.saved_tensors
    dw, dfeat = cluster_merge_backward(weights, feat, ncc, ctx.cluster_size,
                                       g.to(weights.dtype).contiguous())
    return dw, dfeat, None, None


_LIB.impl("cluster_merge_fwd", _fwd_cpu, "CPU")
_LIB.impl("cluster_merge_fwd", _fwd_cuda, "CUDA")
_LIB.impl("cluster_merge_bwd", _bwd_cpu, "CPU")
_LIB.impl("cluster_merge_bwd", _bwd_cuda, "CUDA")
_LIB.impl("merge_inverse_index", merge_inverse_index_reference, "CPU")
_LIB.impl("merge_inverse_index", _index_cuda, "CUDA")
for _name, _fake in (("cluster_merge_fwd", _fwd_fake),
                     ("cluster_merge_bwd", _bwd_fake),
                     ("merge_inverse_index", _index_fake)):
    torch.library.register_fake(f"mlaff::{_name}", _fake, lib=_LIB)
torch.library.register_autograd("mlaff::cluster_merge_fwd", _fwd_backward,
                                setup_context=_fwd_setup, lib=_LIB)


def fused_cluster_merge(weights, feat, ncc, cluster_size):
    """PointConv merge over cluster neighbourhoods, differentiable in
    ``weights`` and ``feat``, through the op ``mlaff::cluster_merge_fwd``:
    the CUDA kernel on a CUDA tensor (counted in
    ``fused_cluster_merge.launches``), the plain version on the CPU.

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
    return torch.ops.mlaff.cluster_merge_fwd(weights, feat, ncc,
                                             cluster_size)


fused_cluster_merge.launches = 0
