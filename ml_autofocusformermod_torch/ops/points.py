"""Dense-canvas scatter of off-grid tokens (counterpart of the JAX
package's ``ops/points.py``, reference ``point_utils.py:10-24``).

Kept in the public API for downstream segmentation consumers.
"""

from __future__ import annotations

import torch

__all__ = ["points2img"]


def points2img(pos: torch.Tensor, pixel: torch.Tensor, h: int,
               w: int) -> torch.Tensor:
    """Scatter tokens onto an ``h x w`` canvas; blank spots are 0.

    Args:
        pos: ``(b, n, 2)`` integer-valued (x, y) positions, valid canvas
            indices.
        pixel: ``(b, n, c)`` token features.

    Returns:
        ``(b, c, h, w)`` in ``pixel``'s dtype. If several tokens map to one
        cell the result takes one of them (unspecified which, as torch's
        ``scatter`` and XLA's scatter leave it).
    """
    b, n, c = pixel.shape
    idx = (pos[:, :, 1] * w + pos[:, :, 0]).long()  # b x n
    img = pixel.new_zeros((b, h * w, c))
    img.scatter_(1, idx[..., None].expand(b, n, c), pixel)
    return img.transpose(1, 2).reshape(b, c, h, w)
