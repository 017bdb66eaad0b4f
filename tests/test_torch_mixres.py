"""The port's MixRes modules against the JAX package's on the CPU.

* every ``mixres_common`` function and module (both norms of the conv
  blocks and of the overlap patch embedding) on the same numpy inputs and
  weights;
* ``MixResViT`` as a first layer and as a later layer;
* ``MixResNeighbour`` at scale 2 over ``keep_old_scale`` x
  ``add_image_data_to_all``, local (the fused attention, a padded last
  cluster, positions shared by two scales) and global.

Weights reach the port through ``state_dict_from_flax``; b = 2, fp32,
atol 1e-5 / rtol 1e-4. The levels' JAX reference is computed by
``torch_maskfiner_reference.py`` in a process of its own (XLA at
optimisation level 0, see there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_autofocusformermod_tpu.models import mixres_common as jmc
from ml_autofocusformermod_tpu.models.mixres_vit import MixResViT as JaxViT
from ml_autofocusformermod_torch.ckpt.from_jax import state_dict_from_flax
from ml_autofocusformermod_torch.models import layers as port_layers
from ml_autofocusformermod_torch.models import mixres_common as pmc
from ml_autofocusformermod_torch.models.mixres_neighbour import MixResNeighbour
from ml_autofocusformermod_torch.models.mixres_vit import MixResViT
from ml_autofocusformermod_torch.ops.cluster_attention import tile_metadata
from torch_maskfiner_reference import (LEVEL_C, LEVEL_D, LEVEL_LAYOUT,
                                       LEVELS, draw_weights, run_reference,
                                       unflatten)

torch.set_num_threads(1)
ATOL, RTOL = 1e-5, 1e-4
B = 2


def close(port, ref, exact=False):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    if exact:
        np.testing.assert_array_equal(port, np.asarray(ref))
    else:
        np.testing.assert_allclose(port, np.asarray(ref), atol=ATOL,
                                   rtol=RTOL)


def flax_weights(module, *args, seed=0, **kwargs):
    shapes = jax.eval_shape(lambda: module.init(
        jax.random.PRNGKey(0), *args, **kwargs))
    return draw_weights(np.random.default_rng(seed), shapes)


def load(port, variables):
    port.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables)))
    return port.eval()


# ------------------------------------------------------ mixres_common ----

def _sine():
    pos = np.random.default_rng(1).integers(0, 56, (B, 30, 2)).astype(
        np.float32)
    close(pmc.sine_position_embedding(torch.from_numpy(pos), 32),
          jmc.sine_position_embedding(jnp.asarray(pos), 32))


def _grid():
    for args in [(224, 224, 32, 4, 0), (64, 48, 8, 4, 2)]:
        close(pmc.scale_grid_positions(*args),
              jmc.scale_grid_positions(*args), exact=True)


def _extract():
    rng = np.random.default_rng(2)
    pos = np.concatenate([rng.integers(0, 3, (B, 20, 1)),
                          rng.integers(0, 16, (B, 20, 2))], 2)
    pos = pos.astype(np.float32)
    pos[:, :7, 0] = 1  # 7 or more of scale 1 per image; take 7
    feat = rng.standard_normal((B, 20, 5)).astype(np.float32)
    extra = rng.standard_normal((B, 20)).astype(np.float32)
    port = pmc.extract_scale(*map(torch.from_numpy, (feat, pos)), 1, 7,
                             extra=torch.from_numpy(extra))
    ref = jmc.extract_scale(*map(jnp.asarray, (feat, pos)), 1, 7,
                            extra=jnp.asarray(extra))
    for p, r in zip(port, ref):
        close(p, r, exact=True)


def _patches():
    rng = np.random.default_rng(3)
    im = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    pos = (rng.integers(0, 4, (B, 9, 2)) * 2).astype(np.float32)
    close(pmc.gather_image_patches(torch.from_numpy(im),
                                   torch.from_numpy(pos), 8, 4),
          jmc.gather_image_patches(jnp.asarray(im), jnp.asarray(pos), 8, 4),
          exact=True)


def _module(flax_mod, port_mod, shape, nchw=False):
    x = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    variables = flax_weights(flax_mod, jnp.asarray(x))
    ref = flax_mod.apply(variables, jnp.asarray(x))
    xt = torch.from_numpy(x)
    with torch.no_grad():
        if nchw:  # the port's conv block is NCHW, flax's NHWC
            out = load(port_mod, variables)(xt.permute(0, 3, 1, 2))
            out = out.permute(0, 2, 3, 1)
        else:
            out = load(port_mod, variables)(xt)
    close(out, ref)


COMMON = {
    "sine_position_embedding": _sine,
    "scale_grid_positions": _grid,
    "extract_scale": _extract,
    "gather_image_patches": _patches,
    "MLPBlock": lambda: _module(jmc.MLPBlock(12), pmc.MLPBlock(8, 12),
                                (B, 5, 8)),
    "MLPDeepNorm": lambda: _module(jmc.MLPDeepNorm(16, 12),
                                   pmc.MLPDeepNorm(8, 16, 12), (B, 5, 8)),
    "MLP": lambda: _module(jmc.MLP(16, 10, 3), pmc.MLP(8, 16, 10, 3),
                           (B, 8)),
    "DownSampleConvBlock_batch": lambda: _module(
        jmc.DownSampleConvBlock(8, norm="batch"),
        pmc.DownSampleConvBlock(3, 8, "batch"), (B, 16, 16, 3), nchw=True),
    "DownSampleConvBlock_group": lambda: _module(
        jmc.DownSampleConvBlock(8, norm="group"),
        pmc.DownSampleConvBlock(3, 8, "group"), (B, 16, 16, 3), nchw=True),
    "OverlapPatchEmbedding_batch": lambda: _module(
        jmc.OverlapPatchEmbedding(8, 16, norm="batch"),
        pmc.OverlapPatchEmbedding(8, 16, "batch"), (B, 32, 32, 3)),
    "OverlapPatchEmbedding_group": lambda: _module(
        jmc.OverlapPatchEmbedding(8, 16, norm="group"),
        pmc.OverlapPatchEmbedding(8, 16, "group"), (B, 32, 32, 3)),
}


@pytest.mark.parametrize("name", sorted(COMMON))
def test_mixres_common_matches_jax(name):
    COMMON[name]()


# ---------------------------------------------------------- MixResViT ----

@pytest.mark.parametrize("first_layer", [True, False])
def test_mixres_vit_matches_jax(first_layer):
    rng = np.random.default_rng(6)
    im = rng.standard_normal((B, 64, 64, 3)).astype(np.float32)
    kw = dict(patch_sizes=(32,), n_layers=2, d_model=32, n_heads=2,
              mlp_ratio=2.0, min_patch_size=4, layer_scale=1e-5,
              first_layer=first_layer, channels=3 if first_layer else 24)
    if first_layer:
        feat = pos = None
    else:  # the 2 x 2 tokens of scale 0, in a shuffled order
        feat = rng.standard_normal((B, 4, 24)).astype(np.float32)
        pos = np.array([(0, x, y) for y in (0, 8) for x in (0, 8)],
                       np.float32)[rng.permutation(4)]
        pos = np.broadcast_to(pos, (B, 4, 3)).copy()
    jax_vit = JaxViT(**kw)
    jargs = (jnp.asarray(im), 0, None if feat is None else jnp.asarray(feat),
             None if pos is None else jnp.asarray(pos), None, {0: 4})
    variables = flax_weights(jax_vit, *jargs)
    ref, _ = jax.jit(lambda v: jax_vit.apply(v, *jargs))(variables)
    port = load(MixResViT(**kw), variables)
    with torch.no_grad():
        outs, layout = port(torch.from_numpy(im), 0,
                            None if feat is None else torch.from_numpy(feat),
                            None if pos is None else torch.from_numpy(pos),
                            None, {0: 4})
    assert layout == {0: 4}
    close(outs["res5"], ref["res5"])
    for k in ("res5_pos", "res5_scale"):
        close(outs[k], ref[k], exact=True)
    assert outs["res5_spatial_shape"] == (2, 2)


# ---------------------------------------------------- MixResNeighbour ----

@pytest.fixture(scope="module")
def level_refs(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("mixres"), list(LEVELS))


@pytest.mark.parametrize("case", list(LEVELS))
def test_mixres_neighbour_matches_jax(case, level_refs, monkeypatch):
    keep, img_all, nbhd = LEVELS[case]
    port = MixResNeighbour(
        patch_sizes=(32, 16, 8), n_layers=2, d_model=LEVEL_D, n_heads=2,
        channels=LEVEL_C, mlp_ratio=2.0, n_scales=4, cluster_size=8,
        nbhd_size=nbhd, min_patch_size=4, upscale_ratio=0.75,
        keep_old_scale=keep, scale=2, add_image_data_to_all=img_all,
        layer_scale=1e-5, drop_path_rate=(0.0, 0.0))
    load(port, {"params": unflatten(level_refs, f"{case}/params")})

    fused_calls = []
    real_fused = port_layers.fused_cluster_attention
    monkeypatch.setattr(port_layers, "fused_cluster_attention",
                        lambda *a, **k: fused_calls.append(1)
                        or real_fused(*a, **k))
    global_calls = []
    for mod in port.modules():
        if isinstance(mod, port_layers.ClusterAttention):
            mod.register_forward_pre_hook(
                lambda m, args: global_calls.append(args[1]))
    meta_calls = tile_metadata.calls

    inp = {k: torch.from_numpy(level_refs[f"{case}/in/{k}"])
           for k in ("im", "features", "features_pos", "mask")}
    with torch.no_grad():
        outs, layout = port(inp["im"], 2, inp["features"],
                            inp["features_pos"], inp["mask"],
                            dict(LEVEL_LAYOUT))
    want_layout = {int(k.rsplit("/", 1)[1]): int(v)
                   for k, v in level_refs.items()
                   if k.startswith(f"{case}/layout/")}
    assert layout == want_layout
    refs = {k.rsplit("/", 1)[1]: v for k, v in level_refs.items()
            if k.startswith(f"{case}/out/")}
    assert set(refs) == {k for k in outs if not k.endswith("shape")}
    for k, ref in refs.items():
        close(outs[k], ref, exact=not k[-1].isdigit())

    if nbhd == 96:  # the global branch: dense attention, no kernel
        assert global_calls == [True, True] and not fused_calls
        assert tile_metadata.calls == meta_calls
    else:  # the local branch: the fused kernel, one tile metadata
        assert global_calls == [False, False] and len(fused_calls) == 2
        assert tile_metadata.calls == meta_calls + 1
