"""``ops/points.py::points2img`` against the JAX package's, on the CPU:
tokens at unique positions land on the same canvas, exactly in fp32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_autofocusformermod_torch.ops.points import points2img
from ml_autofocusformermod_tpu.ops.points import points2img as jax_points2img


@pytest.mark.parametrize("b,n,c,h,w", [(2, 30, 5, 7, 9), (1, 63, 3, 9, 7)])
def test_points2img_matches_jax(b, n, c, h, w):
    rng = np.random.default_rng(n)
    cells = np.stack([rng.permutation(h * w)[:n] for _ in range(b)])
    pos = np.stack([cells % w, cells // w], axis=-1).astype(np.float32)
    pixel = rng.standard_normal((b, n, c)).astype(np.float32)
    want = np.asarray(jax_points2img(jnp.asarray(pos), jnp.asarray(pixel),
                                     h, w))
    got = points2img(torch.from_numpy(pos), torch.from_numpy(pixel), h, w)
    assert got.shape == (b, c, h, w) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert int((got != 0).any(1).sum()) == b * n  # blank spots stay 0
