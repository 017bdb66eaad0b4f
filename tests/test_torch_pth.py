"""Reference ``.pth`` import: the port's ``ckpt/pth_import.py`` against the
JAX package's, on the CPU, on files written here (``torch.save`` of
``{'model': state_dict_from_flax(variables)}``, BatchNorm step counters
included, one key dropped and one foreign key added):

* tiny AFF (56^2): the same missing and unexpected keys (JAX's flax paths
  mapped through ``torch_key``) and, after the import, the same logits at
  fp32 (the JAX forward jitted, its Pallas kernels in interpret mode);
* tiny Oracle-Teacher and Up-Down: the same keys, and every imported value;
* a bare state dict and the trainer's wrapper both load, a shape mismatch
  raises in both packages, a URL raises in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_autofocusformermod_torch.ckpt.from_jax import (
    state_dict_from_flax, torch_key,
)
from ml_autofocusformermod_torch.ckpt.pth_import import (
    import_reference_state_dict, load_pth_state_dict, load_reference_weights,
)
from ml_autofocusformermod_torch.models.aff import AutoFocusFormer
from ml_autofocusformermod_torch.models.build import build_model
from ml_autofocusformermod_tpu.ckpt import pth_import as jax_pth
from ml_autofocusformermod_tpu.models.aff import AutoFocusFormer as JaxAFF
from ml_autofocusformermod_tpu.models.build import build_model as jax_build
from test_maskfiner import tiny_mr
from test_torch_maskfiner import port_tiny_mr

torch.set_num_threads(1)
ATOL, RTOL = 1e-5, 1e-4  # tests/test_torch_model.py's fp32 envelope
AFF = dict(num_classes=10, embed_dim=(16, 32, 48, 64), depths=(1, 1, 1, 1),
           num_heads=(2, 2, 4, 4), img_size=56, drop_path_rate=0.0)
DROPPED = "layers.1.blocks.0.norm1.bias"
EXTRA = "head_extra.weight"


def _draw(rng, shapes):
    def draw(path, leaf):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _flax_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flax_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _write_pth(path, variables, dropped, wrap=True):
    """The reference-format file of ``variables``: step counters in, the
    key ``dropped`` out, one foreign key in; returns the state dict."""
    sd = state_dict_from_flax(variables)
    assert any(k.endswith("num_batches_tracked") for k in sd) or \
        "batch_stats" not in variables
    del sd[dropped]
    sd[EXTRA] = torch.ones(3, 4)
    torch.save({"model": sd, "epoch": 299} if wrap else sd, path)
    return sd


def _jax_import(target, path):
    new, missing, unexpected = jax_pth.import_torch_state_dict(
        target, jax_pth.load_pth_state_dict(str(path)))
    return new, sorted(torch_key(tuple(m.split("/"))) for m in missing), \
        sorted(unexpected)


@pytest.fixture(scope="module")
def aff(tmp_path_factory):
    jmodel = JaxAFF(use_pallas=True, merge_mode="pallas", **AFF)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 56, 56, 3)))
    rng = np.random.default_rng(3)
    init = _draw(rng, shapes)   # both packages' weights before the import
    ref = _draw(rng, shapes)    # the reference checkpoint's
    path = tmp_path_factory.mktemp("pth") / "aff.pth"
    _write_pth(path, ref, DROPPED)
    return jmodel, init, path


def test_aff_import_matches_jax_keys_and_logits(aff):
    jmodel, init, path = aff
    new, missing, unexpected = _jax_import(init, path)
    x = np.random.default_rng(4).standard_normal((2, 56, 56, 3)).astype(
        np.float32)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(
            lambda v, x: jmodel.apply(v, x, training=False))(new, x))

    kw = {k: v for k, v in AFF.items() if k != "drop_path_rate"}
    port = AutoFocusFormer(**kw).eval()
    port.load_state_dict(state_dict_from_flax(init))
    got_missing, got_unexpected = load_reference_weights(str(path), port)
    assert got_missing == missing == [DROPPED]
    assert sorted(got_unexpected) == unexpected == [EXTRA]
    with torch.no_grad():
        out = port(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    np.testing.assert_allclose(out.numpy(), want, atol=ATOL, rtol=RTOL)
    assert out.argmax(-1).tolist() == want.argmax(-1).tolist()


@pytest.mark.parametrize("preset", ["maskfiner_oracle_teacher.yaml",
                                    "maskfiner_up_down_mini.yaml"])
def test_maskfiner_import_matches_jax_keys(tmp_path, preset):
    """Tiny OT / UD: the same missing and unexpected keys as JAX, and every
    value the file holds for a key of the model lands in the port."""
    jmodel = jax_build(tiny_mr(preset))
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 64, 64, 3)),
        training=False))
    rng = np.random.default_rng(6)
    init, ref = _draw(rng, shapes), _draw(rng, shapes)
    keys = [torch_key(p) for coll in ref for p in _flax_paths(ref[coll])]
    dropped = keys[len(keys) // 2]
    sd = _write_pth(tmp_path / "mf.pth", ref, dropped)
    new, missing, unexpected = _jax_import(init, tmp_path / "mf.pth")

    port = build_model(port_tiny_mr(preset), "cpu")
    port.load_state_dict(state_dict_from_flax(init))
    got_missing, got_unexpected = load_reference_weights(
        str(tmp_path / "mf.pth"), port)
    assert got_missing == missing == [dropped]
    assert sorted(got_unexpected) == unexpected == [EXTRA]
    have = port.state_dict()
    for k, v in sd.items():
        if k in have:
            assert torch.equal(have[k], v), k
    # the dropped key kept the model's own value, as in JAX
    assert torch.equal(have[dropped],
                       state_dict_from_flax(init)[dropped])


def test_bare_state_dict_and_wrapper_both_load(aff, tmp_path):
    _, init, _ = aff
    sd = state_dict_from_flax(init)
    torch.save(sd, tmp_path / "bare.pth")
    torch.save({"model": sd, "optimizer": {}, "epoch": 3},
               tmp_path / "wrapped.pth")
    for name in ("bare.pth", "wrapped.pth"):
        loaded = load_pth_state_dict(str(tmp_path / name))
        assert loaded.keys() == sd.keys()
        assert all(torch.equal(loaded[k], sd[k]) for k in sd)
        ref = jax_pth.load_pth_state_dict(str(tmp_path / name))
        assert sorted(ref) == sorted(loaded)
    kw = {k: v for k, v in AFF.items() if k != "drop_path_rate"}
    port = AutoFocusFormer(**kw)
    assert load_reference_weights(str(tmp_path / "bare.pth"), port) == ([],
                                                                        [])
    # values are cast to the model's dtype
    half = {k: v.half() if v.is_floating_point() else v
            for k, v in sd.items()}
    assert import_reference_state_dict(port, half) == ([], [])
    assert port.head.weight.dtype == torch.float32
    assert torch.equal(port.head.weight, sd["head.weight"].half().float())


def test_shape_mismatch_raises_in_both(aff, tmp_path):
    """A 1000-class head does not load into a 10-class model."""
    _, init, _ = aff
    sd = state_dict_from_flax(init)
    sd["head.weight"] = torch.zeros(1000, 64)
    sd["head.bias"] = torch.zeros(1000)
    torch.save({"model": sd}, tmp_path / "in1k.pth")
    with pytest.raises(ValueError, match="shape mismatch for head"):
        jax_pth.import_torch_state_dict(
            init, jax_pth.load_pth_state_dict(str(tmp_path / "in1k.pth")))
    kw = {k: v for k, v in AFF.items() if k != "drop_path_rate"}
    with pytest.raises(ValueError, match="shape mismatch for head"):
        load_reference_weights(str(tmp_path / "in1k.pth"),
                               AutoFocusFormer(**kw))


def test_url_raises_in_the_port():
    with pytest.raises(ValueError, match="URL"):
        load_pth_state_dict("https://example.org/aff_mini.pth")
