"""The port's MaskFiner models against the JAX package's on the CPU.

* the tiny Oracle-Teacher and Up-Down models of
  ``tests/test_maskfiner.py::tiny_mr`` (64^2, depth 1, narrow widths),
  b = 2, fp32: logits within atol 1e-5 / rtol 1e-4 on the same weights
  (through ``state_dict_from_flax``, strict) and the JAX forward's own
  upsampling masks, replayed into the port; the Up-Down ``AUX_LOSS`` list;
  the fused attention and the global branch both ran;
* ``align_to_order`` against JAX and against ``find_pos_org_order``, and
  the other mask oracles;
* ``main --eval --device cpu`` on a tiny MaskFiner config;
* on a GPU only: UD-Mini at full width, the CUDA kernels against the CPU
  plain versions.

The JAX reference runs in a process of its own
(``torch_maskfiner_reference.py``: XLA at optimisation level 0, see there).
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_autofocusformermod_tpu.ckpt.pth_import import _torch_key
from ml_autofocusformermod_tpu.models import maskfiner_ud as jud
from ml_autofocusformermod_torch import main as port_main
from ml_autofocusformermod_torch.ckpt.from_jax import state_dict_from_flax
from ml_autofocusformermod_torch.config import load_config
from ml_autofocusformermod_torch.models import layers as port_layers
from ml_autofocusformermod_torch.models import maskfiner_ot, maskfiner_ud
from ml_autofocusformermod_torch.models.build import build_model
from ml_autofocusformermod_torch.ops.cluster_attention import tile_metadata
from test_maskfiner import tiny_mr
from torch_maskfiner_reference import MODELS, run_reference, unflatten

torch.set_num_threads(1)
ATOL, RTOL = 1e-5, 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CFG = os.path.join(ROOT, "ml_autofocusformermod_torch", "configs")


def port_tiny_mr(preset, **opts):
    """The port's config of ``tiny_mr(preset, **opts)``."""
    ref = tiny_mr(preset, **opts)
    mr = ref.MODEL.MR
    pairs = [("MODEL.NUM_CLASSES", ref.MODEL.NUM_CLASSES),
             ("DATA.IMG_SIZE", ref.DATA.IMG_SIZE),
             ("TPU.COMPUTE_DTYPE", ref.TPU.COMPUTE_DTYPE)]
    pairs += [(f"MODEL.MR.{k}", list(mr[k]))
              for k in ("EMBED_DIM", "DEPTHS", "NUM_HEADS", "MLP_RATIO")]
    pairs += list(opts.items())
    flat = [str(x) for kv in pairs for x in kv]
    return load_config(os.path.join(PORT_CFG, preset), opts=flat)


@pytest.fixture(scope="module")
def model_refs(tmp_path_factory):
    return run_reference(tmp_path_factory.mktemp("maskfiner"), ["ot", "ud"],
                         ["ud_aux"])


def flax_paths(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flax_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


@pytest.mark.parametrize("case", list(MODELS))
def test_maskfiner_logits_match_jax(case, model_refs, monkeypatch):
    preset, opts = MODELS[case]
    port = build_model(port_tiny_mr(preset, **opts), "cpu")
    params = unflatten(model_refs, f"{case}/params")
    sd = state_dict_from_flax({"params": params})
    # strict both ways: every flax leaf is one port key, every port key
    # one flax leaf, and the names are the reference's
    assert len(sd) == len(list(flax_paths(params)))
    assert set(sd) == set(port.state_dict())
    assert set(sd) == {_torch_key(p) for p in flax_paths(params)}
    port.load_state_dict(sd, strict=True)

    masks = []

    def replay(model, j, b, n, device):
        m = torch.from_numpy(model_refs[f"{case}/mask/{j}"])
        assert tuple(m.shape) == (b, n)
        masks.append(j)
        return m.to(device)

    monkeypatch.setattr(maskfiner_ot, "random_upsampling_mask", replay)
    monkeypatch.setattr(maskfiner_ud, "random_upsampling_mask", replay)
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

    x = torch.from_numpy(model_refs[f"{case}/in/x"]).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = port(x.contiguous())
    assert masks == [0, 1, 2]
    # 64^2, depth 1: a level of at most 48 tokens attends globally. OT:
    # 16, 44 tokens global, 108 local; UD: 16 (twice) global, 52 (twice)
    # and 160 local
    n_local, n_global = (1, 2) if case == "ot" else (3, 2)
    assert len(fused_calls) == n_local == global_calls.count(False)
    assert global_calls.count(True) == n_global
    assert tile_metadata.calls == meta_calls + n_local
    if case == "ud_aux":
        assert isinstance(out, list) and len(out) == 4
        for i, o in enumerate(out):
            np.testing.assert_allclose(
                o.numpy(), model_refs[f"{case}/out/logits_{i}"],
                atol=ATOL, rtol=RTOL)
    else:
        assert out.shape == (2, 10)
        np.testing.assert_allclose(out.numpy(),
                                   model_refs[f"{case}/out/logits"],
                                   atol=ATOL, rtol=RTOL)


def test_state_dict_from_flax_refuses_colliding_keys():
    params = {"layers_0": {"kernel": np.zeros((2, 3), np.float32)},
              "layers": {"0": {"kernel": np.zeros((2, 3), np.float32)}}}
    with pytest.raises(ValueError, match="layers.0.weight"):
        state_dict_from_flax({"params": params})


def test_align_to_order_matches_jax_and_the_cdist_oracle():
    rng = np.random.default_rng(3)
    for n, half_units in [(17, False), (64, False), (33, True)]:
        b = 3
        flat = np.stack([rng.choice(4096, size=n, replace=False)
                         for _ in range(b)])
        shuffled = np.stack([flat // 64, flat % 64], -1).astype(np.float32)
        if half_units:
            shuffled = shuffled / 2.0
        perm = np.stack([rng.permutation(n) for _ in range(b)])
        org = np.take_along_axis(shuffled, perm[..., None], axis=1)
        fast = maskfiner_ud.align_to_order(torch.from_numpy(org),
                                           torch.from_numpy(shuffled))
        oracle = maskfiner_ud.find_pos_org_order(torch.from_numpy(org),
                                                 torch.from_numpy(shuffled))
        ref = jud.align_to_order(jnp.asarray(org), jnp.asarray(shuffled))
        np.testing.assert_array_equal(fast.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(fast.numpy(), oracle.numpy())
        np.testing.assert_array_equal(fast.numpy(), perm)


def test_upsampling_mask_oracles_match_jax():
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(2, 17, 8)).astype(np.float32)
    np.testing.assert_allclose(
        maskfiner_ud.max_norm_upsampling_mask(torch.from_numpy(feats)),
        jud.max_norm_upsampling_mask(jnp.asarray(feats)), rtol=1e-6)
    im = rng.normal(size=(2, 16, 16, 3)).astype(np.float32)
    np.testing.assert_allclose(
        maskfiner_ud.compute_color_dist(torch.from_numpy(im)),
        jud.compute_color_dist(jnp.asarray(im)), rtol=1e-5, atol=1e-5)
    pos = rng.integers(0, 7, (2, 5, 2)).astype(np.float32)
    np.testing.assert_allclose(
        maskfiner_ud.color_change_upsampling_mask(
            torch.from_numpy(im), torch.from_numpy(pos), 4, 2),
        jud.color_change_upsampling_mask(jnp.asarray(im), jnp.asarray(pos),
                                         4, 2), rtol=1e-5, atol=1e-4)


def test_masks_are_seeded_and_fixed_in_eval():
    cfg = port_tiny_mr("maskfiner_up_down_mini.yaml")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 3, 64, 64)).astype(np.float32))
    a, b = build_model(cfg, "cpu"), build_model(cfg, "cpu")
    with torch.no_grad():
        out_a = a(x)
        np.testing.assert_array_equal(out_a.numpy(), a(x).numpy())
        np.testing.assert_array_equal(out_a.numpy(), b(x).numpy())
    assert sorted(k[0] for k in a.upsampling_masks) == [0, 1, 2]


def test_main_eval_maskfiner_on_cpu(tmp_path, capsys):
    cfg = port_tiny_mr("maskfiner_up_down_mini.yaml")
    mr = cfg.MODEL.MR
    result = port_main.main([
        "--cfg", os.path.join(PORT_CFG, "maskfiner_up_down_mini.yaml"),
        "--eval", "--device", "cpu", "--batch-size", "8",
        "--data-path", str(tmp_path / "no_dataset"),
        "--opts", "MODEL.NUM_CLASSES", "10", "DATA.IMG_SIZE", "64",
        "TPU.COMPUTE_DTYPE", "float32",
        "MODEL.MR.EMBED_DIM", str(list(mr.EMBED_DIM)),
        "MODEL.MR.DEPTHS", str(list(mr.DEPTHS)),
        "MODEL.MR.NUM_HEADS", str(list(mr.NUM_HEADS)),
    ])
    printed = capsys.readouterr().out
    assert "Accuracy of the network on 64 images" in printed
    assert result["throughput_img_s"] > 0
    assert 0.0 <= result["acc1"] <= result["acc5"] <= 100.0
    assert math.isfinite(result["loss"]) and 1.0 < result["loss"] < 5.0


@pytest.mark.parametrize("preset", ["maskfiner_oracle_teacher.yaml",
                                    "maskfiner_up_down_mini.yaml"])
def test_build_maskfiner_refuses_cuda_without_gpu(preset):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: CUDA is a valid device here")
    with pytest.raises(RuntimeError, match="cuda"):
        build_model(load_config(os.path.join(PORT_CFG, preset)))


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a GPU")
def test_ud_mini_gpu_matches_cpu():
    """UD-Mini 224 at full width, fp32, b = 2: the GPU forward (CUDA
    kernels, TF32 off) against the CPU forward (plain versions)."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        fused_cluster_attention)

    cfg = load_config(os.path.join(PORT_CFG, "maskfiner_up_down_mini.yaml"),
                      opts=["TPU.COMPUTE_DTYPE", "float32"])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 224, 224)).astype(np.float32))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            fused_cluster_attention.launches = 0
            out = build_model(cfg, "cuda", seed=0)(x.cuda()).float().cpu()
            launches = fused_cluster_attention.launches
            ref = build_model(cfg, "cpu", seed=0)(x).float()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    assert launches == 16
    assert (out.argmax(-1) == ref.argmax(-1)).all()
    assert (out - ref).abs().max().item() <= 1e-3
