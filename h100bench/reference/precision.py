"""The arithmetic of the reference's products.

``Precision("float32")`` is the reference: every product in float32, with
TF32 off (the caller sets ``torch.backends.*.allow_tf32 = False``).
``Precision("fp8")`` is the correctness control: the same graph with the
operands of every product rounded to float8 e4m3 on a per-tensor scale
(the step below the configuration's bfloat16 compute), accumulated in
float32. The rounding passes the gradient straight through, so the
backward's products take the rounded operands, as an fp8 step would.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


class Precision:
    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"precision {name!r}: use 'float32' or 'fp8'")
        self.name = name

    def q(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` in float32, rounded to e4m3 under the control."""
        t = t.float()
        if self.name == "float32":
            return t
        d = t.detach()
        scale = d.abs().amax().clamp_min(1e-30) / E4M3_MAX
        return t + ((d / scale).to(torch.float8_e4m3fn).float() * scale - d)

    def linear(self, x, weight, bias):
        return F.linear(self.q(x), self.q(weight), bias.float())

    def conv2d(self, x, weight, bias, **kwargs):
        return F.conv2d(self.q(x), self.q(weight), bias.float(), **kwargs)

    def einsum(self, eq: str, a, b):
        return torch.einsum(eq, self.q(a), self.q(b))

    def matmul(self, a, b):
        return torch.matmul(self.q(a), self.q(b))
