"""Balanced clustering of 2-D token point clouds along a space-filling curve
(counterpart of the JAX package's ``ops/sfc.py``, default route:
boustrophedon scanline order over an anchor grid).

* The anchor grid and its curve order depend only on ``(h, w, k)``: host
  numpy constants (:func:`_anchor_tables`), moved to the device once per
  ``(h, w, k, device)``.
* The per-token part is a rank-and-argsort: each token is keyed by (curve
  rank of its anchor, dist-to-prev-anchor / dist-to-next-anchor) and sorted
  with a stable argsort (:func:`space_filling_cluster`).
* The first stage's tokens sit on the regular grid, so its clustering and
  kNN are pure functions of ``(h, w, m)``: :func:`grid_cluster` and
  :func:`grid_nearest_clusters` are host numpy constants, and
  :func:`grid_tensors` caches them on the device once per
  ``(h, w, m, nnc, device)``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import span

__all__ = [
    "space_filling_cluster",
    "grid_cluster",
    "grid_nearest_clusters",
    "grid_tensors",
]


@functools.lru_cache(maxsize=None)
def _anchor_tables(h: int, w: int, k: int):
    """Anchor grid + scanline ordering for ``(h, w, k)``: host constants.

    Returns ``(num_patch_w, patch_len_hw(2,), anchor_rank(nump,),
    prev_means(nump, 2), next_means(nump, 2))`` where ``anchor_rank[cell]``
    is the curve rank of row-major grid cell ``cell`` (JAX package
    ``sfc.py:242-318``, ``sf_type=''``).
    """
    patch_len = (h * w / k) ** 0.5
    num_patch_h = int(round(h / patch_len))
    num_patch_w = int(round(w / patch_len))
    patch_len_h, patch_len_w = h / num_patch_h, w / num_patch_w

    ys, xs = np.meshgrid(
        np.arange(num_patch_h), np.arange(num_patch_w), indexing="ij"
    )
    grid_pos = np.stack([xs, ys], axis=2).reshape(-1, 2).astype(np.float32)
    # the token canvas width `w` (not num_patch_w) enters the order value,
    # as in the reference (point_utils.py:127); the relative order is equal
    ys_f = ys.astype(np.int64)
    xs_f = xs.astype(np.int64)
    sign = np.where(ys_f % 2 == 1, -1, 1)
    order_mask = sign * xs_f + ys_f * w + np.where(ys_f % 2 == 1, w - 1, 0)
    order_idx = np.argsort(order_mask.reshape(-1), kind="stable")
    anchor_rank = np.argsort(order_idx, kind="stable")

    ordered_grid = grid_pos[order_idx]
    patch_len_hw = np.array([patch_len_w, patch_len_h], dtype=np.float32)
    init_means = ordered_grid * patch_len_hw + patch_len_hw / 2 - 0.5
    nump = init_means.shape[0]

    prev_means = np.zeros_like(init_means)
    prev_means[1:] = init_means[: nump - 1]
    next_means = np.zeros_like(init_means)
    next_means[: nump - 1] = init_means[1:]
    if nump >= 2:
        prev_means[0] = init_means[0] - (init_means[1] - init_means[0])
        next_means[-1] = init_means[-1] + (init_means[-1] - init_means[-2])
    else:
        prev_means[0] = init_means[0] - 1.0
        next_means[-1] = init_means[-1] + 1.0
    return (
        num_patch_w,
        patch_len_hw,
        anchor_rank.astype(np.int64),
        prev_means,
        next_means,
    )


_DEVICE_TABLES: Dict[tuple, tuple] = {}


def _device_anchor_tables(h: int, w: int, k: int, device: torch.device):
    key = (h, w, k, str(device))
    if key not in _DEVICE_TABLES:
        num_patch_w, patch_len_hw, anchor_rank, prev_m, next_m = (
            _anchor_tables(h, w, k)
        )
        _DEVICE_TABLES[key] = (
            num_patch_w,
            torch.as_tensor(patch_len_hw, device=device),
            torch.as_tensor(anchor_rank, device=device),
            torch.as_tensor(prev_m, device=device),
            torch.as_tensor(next_m, device=device),
        )
    return _DEVICE_TABLES[key]


def space_filling_cluster(pos: torch.Tensor, m: int, h: int, w: int,
                          batch_max: Optional[Callable] = None):
    """Balanced clustering along the scanline curve (reorder mode).

    ``n`` tokens are split into ``k = ceil(n/m)`` contiguous-in-curve-order
    clusters of exactly ``m`` slots; when ``m`` does not divide ``n`` the
    trailing slots of the last cluster are padding, flagged by
    ``cluster_mask`` (1 = valid). The JAX function's defaults
    (``no_reorder=False, sf_type='', use_anchor=True``) are the only route
    the AFF model takes, and the only one ported. The sort key scales by
    the max of the distance ratio over the whole batch; ``batch_max``, when
    given, takes that max (a 0-d tensor) of this process's rows to the
    global batch's (the model passes the data ranks' all-reduce).

    Returns:
        ``(pos_sorted (b,n,2), cluster_mean_pos (b,k,2), member_idx (b,k,m),
        cluster_mask (b,k,m) int32 or None, pos_ranking (b,n,1))``
    """
    with span("geom.sfc"):
        pos = pos.detach().float()
        b, n, d = pos.shape
        k = int(math.ceil(n / m))
        num_patch_w, patch_len_hw, anchor_rank, prev_means, next_means = (
            _device_anchor_tables(h, w, k, pos.device)
        )

        cell = torch.floor(pos / patch_len_hw)
        cell_idx = (cell[..., 0] + cell[..., 1] * num_patch_w).long()
        # b x n, curve rank of the token's anchor
        assign = anchor_rank[cell_idx]
        dist_prev = ((pos - prev_means[assign]) ** 2).sum(-1)
        dist_next = ((pos - next_means[assign]) ** 2).sum(-1)
        dist_ratio = dist_prev / (dist_next + 1e-5)
        # the max runs over the WHOLE batch, not per image (sfc.py:348)
        ratio_max = dist_ratio.max()
        if batch_max is not None:
            ratio_max = batch_max(ratio_max)
        key = assign.float() * (ratio_max + 1) + dist_ratio
        pos_ranking = torch.argsort(key, dim=1, stable=True)  # b x n

        pos_sorted = torch.gather(pos, 1,
                                  pos_ranking[..., None].expand(b, n, d))
        if k * m == n:
            cluster_mask = None
            cluster_mean_pos = pos_sorted.reshape(b, k, m, d).mean(2)
        else:
            pad = k * m - n
            pos_pad = torch.cat([pos_sorted, pos.new_zeros((b, pad, d))],
                                dim=1)
            mask_flat = torch.cat(
                [
                    torch.ones((b, n), dtype=torch.int32,
                               device=pos.device),
                    torch.zeros((b, pad), dtype=torch.int32,
                                device=pos.device),
                ],
                dim=1,
            )
            cluster_mask = mask_flat.reshape(b, k, m)
            cluster_mean_pos = (pos_pad.reshape(b, k, m, d).sum(2)
                                / cluster_mask.sum(2, keepdim=True).float())

        member_idx = torch.arange(k * m, device=pos.device)
        member_idx = torch.where(member_idx < n, member_idx, 0)
        member_idx = member_idx[None].expand(b, k * m).reshape(b, k, m)
        return (pos_sorted, cluster_mean_pos, member_idx, cluster_mask,
                pos_ranking[..., None])


@functools.lru_cache(maxsize=None)
def grid_cluster(h: int, w: int, m: int):
    """Clustering of the full regular ``h x w`` grid, as host constants.

    Returns per-image numpy arrays ``(pos_sorted (n,2), cluster_mean_pos
    (k,2), member_idx (k,m), cluster_mask (k,m) or None, reorder (n,))``
    where ``reorder[r]`` is the original index of the token at curve rank
    ``r``. Computed once on the host with the same float32 arithmetic as
    :func:`space_filling_cluster`.
    """
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pos = np.stack([xs, ys], axis=2).reshape(1, -1, 2).astype(np.float32)
    pos_sorted, mean_pos, member_idx, mask, ranking = space_filling_cluster(
        torch.from_numpy(pos), m, h, w
    )
    return (
        pos_sorted[0].numpy(),
        mean_pos[0].numpy(),
        member_idx[0].numpy(),
        None if mask is None else mask[0].numpy(),
        ranking[0, :, 0].numpy(),
    )


@functools.lru_cache(maxsize=None)
def grid_nearest_clusters(h: int, w: int, m: int, nnc: int) -> np.ndarray:
    """``nnc`` nearest cluster ids per grid token, (n, nnc) int32 host
    constants: ascending distance, lowest index first, distances via the
    exact |q|^2+|d|^2-2qd expansion (JAX package ``sfc.py:449-468``)."""
    pos, mean_pos, _, _, _ = grid_cluster(h, w, m)
    q = pos.astype(np.float32)
    d = mean_pos.astype(np.float32)
    d2 = (
        (q**2).sum(-1)[:, None]
        + (d**2).sum(-1)[None, :]
        - 2.0 * (q @ d.T)
    ).astype(np.float32)
    order = np.argsort(d2, axis=1, kind="stable")[:, :nnc]
    return order.astype(np.int32)


_GRID_TENSORS: Dict[tuple, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]] = {}


def grid_tensors(h: int, w: int, m: int, nnc: int, device: torch.device):
    """``(pos (n,2) f32, reorder (n,) int64, ncc (n,nnc) int32)`` of the
    on-grid stage, moved to ``device`` once per ``(h, w, m, nnc, device)``."""
    key = (h, w, m, nnc, str(device))
    if key not in _GRID_TENSORS:
        g_pos, _, _, _, g_reorder = grid_cluster(h, w, m)
        g_ncc = grid_nearest_clusters(h, w, m, nnc)
        _GRID_TENSORS[key] = (
            torch.as_tensor(g_pos, dtype=torch.float32, device=device),
            torch.as_tensor(g_reorder, dtype=torch.int64, device=device),
            torch.as_tensor(g_ncc, dtype=torch.int32, device=device),
        )
    return _GRID_TENSORS[key]
