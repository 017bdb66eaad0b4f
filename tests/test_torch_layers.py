"""The port's layers against the JAX package's flax modules, on the same
weights (moved with ``state_dict_from_flax``) and the same numpy inputs:
PatchEmbed (NHWC in JAX, NCHW in the port), LayerNormFp32,
ClusterTransformerBlock (local fused attention with and without LayerScale,
and global attention), and ClusterMerging at stride 2 and at an adaptive
stride. The JAX attention and merge run their Pallas kernels in interpret
mode.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_autofocusformermod_tpu.models import layers as jl
from ml_autofocusformermod_tpu.ops.knn import knn as jax_knn
from ml_autofocusformermod_tpu.ops.sfc import (
    grid_cluster, grid_nearest_clusters, space_filling_cluster,
)
from ml_autofocusformermod_torch.ckpt.from_jax import state_dict_from_flax
from ml_autofocusformermod_torch.models import layers as tl

torch.set_num_threads(1)
ATOL, RTOL = 1e-5, 1e-4  # fp32 envelope of tests/test_pallas_kernel.py:453


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_patch_embed_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 32, 3)).astype(np.float32)
    mod = jl.PatchEmbed(embed_dim=16)
    variables = _np_tree(mod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    # non-trivial running stats, so the BN mapping is exercised
    bs = variables["batch_stats"]["bn"]
    bs["mean"] = rng.standard_normal(bs["mean"].shape).astype(np.float32)
    bs["var"] = rng.uniform(0.5, 1.5, bs["var"].shape).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        r_pos, r_feat, rh, rw = mod.apply(variables, jnp.asarray(x))

    port = tl.PatchEmbed(embed_dim=16).eval()  # JAX: training=False
    port.load_state_dict(state_dict_from_flax(variables))
    t_pos, t_feat, th, tw = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert (th, tw) == (rh, rw) == (8, 8)
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(r_pos))
    np.testing.assert_allclose(t_feat.detach().numpy(), np.asarray(r_feat),
                               atol=ATOL, rtol=RTOL)


def test_layer_norm_fp32_matches_jax():
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((3, 5, 24)) * 3 + 1).astype(np.float32)
    mod = jl.LayerNormFp32(epsilon=1e-5)
    variables = {"params": {
        "scale": rng.standard_normal(24).astype(np.float32),
        "bias": rng.standard_normal(24).astype(np.float32),
    }}
    ref = mod.apply(variables, jnp.asarray(x))
    port = tl.LayerNormFp32(24)
    port.load_state_dict(state_dict_from_flax(variables))
    out = port(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=ATOL, rtol=RTOL)
    # bf16 in, bf16 out; statistics in f32
    assert port(torch.from_numpy(x).bfloat16()).dtype == torch.bfloat16


def _grid_stage(b, hw, cs, nnc):
    """Stage-1 geometry on an hw x hw grid: (pos, ncc)."""
    n = hw * hw
    pos = np.broadcast_to(grid_cluster(hw, hw, cs)[0][None], (b, n, 2))
    ncc = np.broadcast_to(grid_nearest_clusters(hw, hw, cs, nnc)[None],
                          (b, n, nnc))
    return np.ascontiguousarray(pos), np.ascontiguousarray(ncc)


def _clustered_stage(rng, b, hw, cs, nnc):
    """Positions of a later stage (the stride-2 lattice of an hw x hw canvas,
    shuffled per image), clustered and kNN'd by the JAX package."""
    ys, xs = np.meshgrid(np.arange(0, hw, 2), np.arange(0, hw, 2),
                         indexing="ij")
    lattice = np.stack([xs, ys], -1).reshape(-1, 2).astype(np.float32)
    pos = np.stack([lattice[rng.permutation(len(lattice))] for _ in range(b)])
    p_sorted, mean, _, _, _ = space_filling_cluster(jnp.asarray(pos), cs, hw, hw)
    ncc = jax_knn(p_sorted, mean, nnc)
    return np.array(p_sorted), np.array(ncc)  # writable copies


@pytest.mark.parametrize("stride", [2, 4])  # 4: adaptive grid prior
def test_cluster_merging_matches_jax(stride):
    rng = np.random.default_rng(2 + stride)
    b, hw, cs, nnc, dim, out_dim = 2, 14, 8, 6, 16, 24
    if stride == 2:
        pos, ncc = _grid_stage(b, hw, cs, nnc)
    else:
        pos, ncc = _clustered_stage(rng, b, hw, cs, nnc)
    n = pos.shape[1]
    member_idx = (ncc[..., None] * cs + np.arange(cs)).reshape(b, n, nnc * cs)
    cluster_mask = (member_idx < n).astype(np.int32)
    assert n % cs and not cluster_mask.all()  # a padded last cluster
    feat = rng.standard_normal((b, n, dim)).astype(np.float32)
    learned_prob = rng.uniform(0.05, 0.95, (b, n, 1)).astype(np.float32)
    reserve_num = math.ceil(hw / (stride * 2)) ** 2
    R = 27

    mod = jl.ClusterMerging(dim=dim, out_dim=out_dim, rel_pos_width=R,
                            merge_mode="pallas")
    jargs = (jnp.asarray(pos), jnp.asarray(feat), jnp.asarray(member_idx),
             jnp.asarray(cluster_mask), jnp.asarray(learned_prob), stride,
             reserve_num)
    jkw = dict(nearest_cluster=jnp.asarray(ncc), cluster_size=cs)
    variables = _np_tree(mod.init(jax.random.PRNGKey(0), *jargs, **jkw))
    with jax.default_matmul_precision("highest"):
        r_pos, r_feat = mod.apply(variables, *jargs, **jkw)

    port = tl.ClusterMerging(dim, out_dim, rel_pos_width=R)
    port.load_state_dict(state_dict_from_flax(variables))
    t_pos, t_feat = port(
        torch.from_numpy(pos), torch.from_numpy(feat),
        torch.from_numpy(cluster_mask), torch.from_numpy(learned_prob),
        stride, reserve_num, torch.from_numpy(ncc), cs,
    )
    np.testing.assert_array_equal(t_pos.numpy(), np.asarray(r_pos))
    np.testing.assert_allclose(t_feat.detach().numpy(), np.asarray(r_feat),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("layer_scale,global_attn", [
    (0.0, False), (1e-5, False), (0.0, True),
])
def test_transformer_block_matches_jax(layer_scale, global_attn):
    """One block at 3 heads (c_ = 16) over n = 52 tokens (padded last
    cluster): the fused local path, the same with LayerScale (AFF-Small and
    -Tiny presets), and the dense global path of stage 4."""
    rng = np.random.default_rng(7)
    b, n, dim, heads, cs, nnc, R = 2, 52, 48, 3, 8, 3, 27
    k = -(-n // cs)
    ncc = np.argsort(rng.uniform(size=(b, n, k)), -1)[:, :, :nnc].astype(np.int32)
    pos = rng.integers(0, 28, size=(b, n, 2)).astype(np.float32)
    feat = rng.standard_normal((b, n, dim)).astype(np.float32)
    member_idx = (ncc[..., None] * cs + np.arange(cs)).reshape(b, n, nnc * cs)
    cluster_mask = (member_idx < n).astype(np.int32)
    pe_feat = None
    if global_attn:
        rel = (pos[:, None, :, :] + R) - pos[:, :, None, :]
        pe_feat = np.asarray(jl.rel_pos_features(jnp.asarray(rel), R))

    mod = jl.ClusterTransformerBlock(dim=dim, num_heads=heads,
                                     layer_scale=layer_scale, use_pallas=True,
                                     rel_pos_width=R)
    jargs = ((jnp.asarray(feat), None, None, True, jnp.asarray(pe_feat))
             if global_attn else
             (jnp.asarray(feat), jnp.asarray(member_idx),
              jnp.asarray(cluster_mask), False, None))
    jkw = {} if global_attn else dict(
        nearest_cluster=jnp.asarray(ncc), cluster_size=cs,
        pos=jnp.asarray(pos))
    shapes = jax.eval_shape(
        lambda: mod.init(jax.random.PRNGKey(0), *jargs, **jkw))

    def draw(path, leaf):
        base = 1.0 if path[-1].key == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    with jax.default_matmul_precision("highest"):
        ref = np.asarray(mod.apply(variables, *jargs, **jkw))

    port = tl.ClusterTransformerBlock(dim, heads, 2.0, layer_scale, R)
    port.load_state_dict(state_dict_from_flax(variables))
    with torch.no_grad():
        out = port(torch.from_numpy(feat), global_attn,
                   None if pe_feat is None else torch.tensor(pe_feat),
                   None if global_attn else torch.from_numpy(ncc), cs,
                   torch.from_numpy(pos))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL, rtol=RTOL)
