"""The port's slice end to end: a narrow AFF with the structure of AFF-Mini
at 112^2 against the JAX model on the same weights.

Settings: embed (16, 32, 48, 64), depths (1, 1, 1, 1), heads (2, 2, 4, 4),
cs 8, nbhd (48, 48, 48, 49), b 2, fp32. Tokens per stage 784 -> 196 -> 49
-> 12: three local stages (padded last clusters at 196 and 49) and a global
stage 4. The JAX model is built directly with ``use_pallas=True,
merge_mode="pallas"`` (Pallas in interpret mode); the weights reach the
port through ``state_dict_from_flax``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_autofocusformermod_tpu.ckpt.pth_import import _torch_key
from ml_autofocusformermod_tpu.models.aff import AutoFocusFormer as JaxAFF
from ml_autofocusformermod_torch.ckpt.from_jax import state_dict_from_flax
from ml_autofocusformermod_torch.models.aff import AutoFocusFormer

torch.set_num_threads(1)
ATOL, RTOL = 1e-5, 1e-4  # fp32 envelope of tests/test_pallas_kernel.py:453

CFG = dict(
    num_classes=10, embed_dim=(16, 32, 48, 64), cluster_size=8,
    nbhd_size=(48, 48, 48, 49), depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4),
    mlp_ratio=2.0, img_size=112,
)


@pytest.fixture(scope="module")
def jax_model_and_vars():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 112, 112, 3)).astype(np.float32)
    model = JaxAFF(use_pallas=True, merge_mode="pallas", drop_path_rate=0.0,
                   dtype=jnp.float32, **CFG)
    # random weights on the variable tree's shapes (eval_shape traces the
    # init without compiling it): every leaf differs from its default, so
    # each layout transform of state_dict_from_flax is exercised
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(x[:1]))

    def draw(path, leaf):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    return model, variables, x


def _flax_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def test_state_dict_keys_match_reference_names(jax_model_and_vars):
    _, variables, _ = jax_model_and_vars
    expected = {
        _torch_key(p) for coll in ("params", "batch_stats")
        for p in _flax_paths(variables[coll])
    }
    port = AutoFocusFormer(**CFG)
    keys = set(port.state_dict())
    # torch BatchNorm's step counter has no flax counterpart (pth_import
    # skips it on import)
    assert {k for k in keys if not k.endswith("num_batches_tracked")} == expected
    assert "layers.0.blocks.0.attn.q.weight" in keys
    assert "layers.0.downsample.weight_net.0.weight" in keys


def test_aff_112_logits_match_jax(jax_model_and_vars):
    model, variables, x = jax_model_and_vars
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(model.apply(variables, jnp.asarray(x), training=False))

    port = AutoFocusFormer(**CFG).eval()
    port.load_state_dict(state_dict_from_flax(variables))
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert out.shape == (2, 10) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
