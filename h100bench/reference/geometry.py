"""Token geometry of the plain reference: gathers, the space-filling-curve
clustering, the exact kNN and the on-grid constants.

A frozen copy of the plain paths of the measured package's
``ops/cluster_gather.py``, ``ops/sfc.py`` and ``ops/knn.py``, in plain
PyTorch and NumPy. Positions are integer or half-integer coordinates, so
every distance here is exact in float32; the reference never enables TF32.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, i] = values[b, idx[b, i]]``."""
    batch = torch.arange(values.shape[0], device=values.device)[:, None]
    return values[batch, idx.long()]


def cluster_token_index(ncc: torch.Tensor, cs: int) -> torch.Tensor:
    """(b, n_out, nnc * cs) token rows of each output's clusters; rows of
    the padded last cluster point at ``>= n``."""
    b, n_out, nnc = ncc.shape
    slot = torch.arange(cs, device=ncc.device)
    return (ncc.long()[..., None] * cs + slot).reshape(b, n_out, nnc * cs)


def gather_clusters(values: torch.Tensor, ncc: torch.Tensor,
                    cs: int) -> torch.Tensor:
    """(b, h, n, c) cluster-ordered rows -> (b, h, n_out, nnc * cs, c); the
    padded slots of the last cluster read zeros."""
    b, h, n, c = values.shape
    k = -(-n // cs)
    if k * cs != n:
        values = torch.cat([values, values.new_zeros((b, h, k * cs - n, c))],
                           dim=2)
    idx = cluster_token_index(ncc, cs)
    n_out, m = idx.shape[1], idx.shape[2]
    batch = torch.arange(b, device=values.device)[:, None]
    out = values.transpose(1, 2)[batch, idx.reshape(b, n_out * m)]
    return out.reshape(b, n_out, m, h, c).permute(0, 3, 1, 2, 4)


@functools.lru_cache(maxsize=None)
def _anchor_tables(h: int, w: int, k: int):
    """Anchor grid of ``k`` cells over an ``h x w`` canvas, in boustrophedon
    order: ``(num_patch_w, patch_len_hw, anchor_rank, prev_means,
    next_means)``."""
    patch_len = (h * w / k) ** 0.5
    num_patch_h = int(round(h / patch_len))
    num_patch_w = int(round(w / patch_len))
    patch_len_h, patch_len_w = h / num_patch_h, w / num_patch_w
    ys, xs = np.meshgrid(np.arange(num_patch_h), np.arange(num_patch_w),
                         indexing="ij")
    grid_pos = np.stack([xs, ys], axis=2).reshape(-1, 2).astype(np.float32)
    ys_i, xs_i = ys.astype(np.int64), xs.astype(np.int64)
    sign = np.where(ys_i % 2 == 1, -1, 1)
    order_mask = sign * xs_i + ys_i * w + np.where(ys_i % 2 == 1, w - 1, 0)
    order_idx = np.argsort(order_mask.reshape(-1), kind="stable")
    anchor_rank = np.argsort(order_idx, kind="stable")
    patch_len_hw = np.array([patch_len_w, patch_len_h], dtype=np.float32)
    means = grid_pos[order_idx] * patch_len_hw + patch_len_hw / 2 - 0.5
    nump = means.shape[0]
    prev_means = np.zeros_like(means)
    next_means = np.zeros_like(means)
    prev_means[1:] = means[:-1]
    next_means[:-1] = means[1:]
    if nump >= 2:
        prev_means[0] = means[0] - (means[1] - means[0])
        next_means[-1] = means[-1] + (means[-1] - means[-2])
    else:
        prev_means[0] = means[0] - 1.0
        next_means[-1] = means[-1] + 1.0
    return (num_patch_w, patch_len_hw, anchor_rank.astype(np.int64),
            prev_means, next_means)


def space_filling_cluster(pos: torch.Tensor, m: int, h: int, w: int):
    """Balanced clustering of (b, n, 2) positions along the curve into
    ``ceil(n / m)`` clusters of ``m`` slots. The sort key scales by the
    distance ratio's max over the whole batch. Returns ``(pos_sorted,
    cluster_mean_pos, reorder (b, n))``."""
    pos = pos.detach().float()
    b, n, d = pos.shape
    k = int(math.ceil(n / m))
    num_patch_w, plen, rank, prev_m, next_m = _anchor_tables(h, w, k)
    dev = pos.device
    plen = torch.as_tensor(plen, device=dev)
    rank = torch.as_tensor(rank, device=dev)
    prev_m = torch.as_tensor(prev_m, device=dev)
    next_m = torch.as_tensor(next_m, device=dev)
    cell = torch.floor(pos / plen)
    assign = rank[(cell[..., 0] + cell[..., 1] * num_patch_w).long()]
    dist_prev = ((pos - prev_m[assign]) ** 2).sum(-1)
    dist_next = ((pos - next_m[assign]) ** 2).sum(-1)
    ratio = dist_prev / (dist_next + 1e-5)
    key = assign.float() * (ratio.max() + 1) + ratio
    reorder = torch.argsort(key, dim=1, stable=True)
    pos_sorted = torch.gather(pos, 1, reorder[..., None].expand(b, n, d))
    if k * m == n:
        mean = pos_sorted.reshape(b, k, m, d).mean(2)
    else:
        padded = torch.cat([pos_sorted, pos.new_zeros((b, k * m - n, d))], 1)
        count = torch.clamp(n - torch.arange(k, device=dev) * m, max=m)
        mean = padded.reshape(b, k, m, d).sum(2) / count[:, None].float()
    return pos_sorted, mean, reorder


def _dist_sq(query: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    query, database = query.detach().float(), database.detach().float()
    cross = torch.bmm(query, database.transpose(1, 2))
    return ((query ** 2).sum(-1)[:, :, None]
            + (database ** 2).sum(-1)[:, None, :] - 2.0 * cross)


def knn(query: torch.Tensor, database: torch.Tensor, k: int) -> torch.Tensor:
    """(b, nq, k) int32 indices of the nearest database points, ascending
    distance, the lower index first on ties."""
    order = torch.sort(_dist_sq(query, database), dim=-1, stable=True)[1]
    return order[..., :k].to(torch.int32)


def nearest_other_distance(pos: torch.Tensor) -> torch.Tensor:
    """(b, n) distance from each point to its nearest other point."""
    d2 = _dist_sq(pos, pos)
    eye = torch.eye(pos.shape[1], dtype=torch.bool, device=pos.device)
    return torch.sqrt(d2.masked_fill(eye, float("inf")).amin(-1)
                      .clamp_min(0.0))


@functools.lru_cache(maxsize=None)
def grid_constants(h: int, w: int, m: int, nnc: int):
    """The on-grid stage's clustering and kNN as host arrays: ``(pos (n, 2),
    reorder (n,), ncc (n, nnc))``."""
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    pos = np.stack([xs, ys], axis=2).reshape(1, -1, 2).astype(np.float32)
    pos_s, mean, reorder = space_filling_cluster(torch.from_numpy(pos), m,
                                                 h, w)
    q = pos_s[0].numpy()
    d = mean[0].numpy()
    d2 = ((q ** 2).sum(-1)[:, None] + (d ** 2).sum(-1)[None, :]
          - 2.0 * (q @ d.T)).astype(np.float32)
    ncc = np.argsort(d2, axis=1, kind="stable")[:, :nnc].astype(np.int32)
    return q, reorder[0].numpy(), ncc
