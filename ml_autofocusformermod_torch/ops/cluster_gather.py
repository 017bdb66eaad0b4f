"""Cluster-granularity neighborhood gathers (counterpart of the JAX
package's ``ops/cluster_gather.py``).

After the space-filling reorder, cluster ``j`` occupies rows
``[j*cs, (j+1)*cs)`` and a token's neighborhood is its ``nnc`` nearest
clusters expanded. The JAX package gathers whole clusters with a one-hot
matmul (it rides the TPU's MXU); on the GPU an index gather is the natural
form, with the same result.
"""

from __future__ import annotations

import torch

__all__ = ["gather_rows", "gather_clusters", "cluster_token_index"]


def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[b, i] = values[b, idx[b, i]]``.

    values: (b, n, ...); idx: (b, m) int. Returns (b, m, ...).
    """
    batch = torch.arange(values.shape[0], device=values.device)[:, None]
    return values[batch, idx.long()]


def cluster_token_index(nearest_cluster: torch.Tensor, cluster_size: int):
    """(b, n_out, nnc*cs) token rows of each output's nnc nearest clusters.

    Rows of the padded last cluster point at ``>= n`` (the caller masks or
    zero-reads them).
    """
    b, n_out, nnc = nearest_cluster.shape
    slot = torch.arange(cluster_size, device=nearest_cluster.device)
    idx = nearest_cluster.long()[..., None] * cluster_size + slot
    return idx.reshape(b, n_out, nnc * cluster_size)


def gather_clusters(
    values: torch.Tensor, nearest_cluster: torch.Tensor, cluster_size: int
) -> torch.Tensor:
    """Gather each output's ``nnc`` nearest clusters.

    Args:
        values: ``(b, h, n, c)`` cluster-ordered rows.
        nearest_cluster: ``(b, n_out, nnc)`` int cluster indices.
        cluster_size: ``cs``.

    Returns:
        ``(b, h, n_out, nnc*cs, c)``. When ``cs`` does not divide ``n`` the
        trailing padded slots of the last cluster read zeros, as in the JAX
        package's ``gather_clusters_onehot`` (``cluster_gather.py:47-60``).
    """
    b, h, n, c = values.shape
    k = -(-n // cluster_size)
    if k * cluster_size != n:
        pad = values.new_zeros((b, h, k * cluster_size - n, c))
        values = torch.cat([values, pad], dim=2)
    idx = cluster_token_index(nearest_cluster, cluster_size)  # b n_out m
    n_out, m = idx.shape[1], idx.shape[2]
    batch = torch.arange(b, device=values.device)[:, None]
    out = values.transpose(1, 2)[batch, idx.reshape(b, n_out * m)]  # b e h c
    return out.reshape(b, n_out, m, h, c).permute(0, 3, 1, 2, 4)
