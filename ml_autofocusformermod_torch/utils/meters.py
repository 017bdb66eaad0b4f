"""Running-average meters (timm ``AverageMeter``; a copy of the JAX
package's ``utils/meters.py``)."""

from __future__ import annotations

__all__ = ["AverageMeter"]


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self) -> float:
        return self.sum / max(self.count, 1)
