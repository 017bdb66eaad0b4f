"""Exact k-nearest-neighbour search (counterpart of the JAX package's
``ops/knn.py``).

Positions are small integer-valued coordinates (or means of a few of them),
so the ``|q|^2 + |d|^2 - 2 q.d`` expansion is exact in full float32. TF32
would cut the cross term to about three decimal digits and reorder
neighbours, so this package never enables it.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span

__all__ = ["knn", "nearest_other_distance"]


def _dist_sq(query: torch.Tensor, database: torch.Tensor) -> torch.Tensor:
    query = query.detach().float()
    database = database.detach().float()
    q_sq = (query**2).sum(-1)
    d_sq = (database**2).sum(-1)
    cross = torch.bmm(query, database.transpose(1, 2))
    return q_sq[:, :, None] + d_sq[:, None, :] - 2.0 * cross


def knn(query: torch.Tensor, database: torch.Tensor, k: int,
        return_dist: bool = False):
    """Indices (and optionally distances) of the k nearest database points.

    Args:
        query: ``(b, nq, c)`` positions searching for neighbours.
        database: ``(b, nd, c)`` candidate positions.
        k: number of neighbours.
        return_dist: also return Euclidean distances.

    Returns:
        ``nn_idx (b, nq, k)`` int32, and if ``return_dist`` also
        ``nn_dist (b, nq, k)`` float32. Neighbours are ordered by increasing
        distance, the lower index first on ties: a stable ascending sort
        gives the same order as the JAX package's k argmin sweeps
        (``knn.py:21-40``).
    """
    with span("geom.knn"):
        dist_sq = _dist_sq(query, database)
        top, nn_idx = torch.sort(dist_sq, dim=-1, stable=True)
        nn_idx = nn_idx[..., :k].to(torch.int32)
        if return_dist:
            return nn_idx, torch.sqrt(top[..., :k].clamp_min(0.0))
        return nn_idx


def nearest_other_distance(pos: torch.Tensor) -> torch.Tensor:
    """Distance from each point to its nearest *other* point, (b, n)."""
    dist_sq = _dist_sq(pos, pos)
    n = pos.shape[1]
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    dist_sq = dist_sq.masked_fill(eye, float("inf"))
    return torch.sqrt(dist_sq.amin(-1).clamp_min(0.0))
