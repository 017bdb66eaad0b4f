"""MaskFiner Up-Down across processes (CPU, gloo ranks in subprocesses:
``torch_parallel_worker``).

* the tiny UD of ``tests/test_maskfiner.py::tiny_mr`` (BatchNorm in every
  first layer's patch embedding, EMA on, DropPath 0.1, random upsampling
  masks, mixup and cutmix on) at data 2, data 2 + ZeRO-1 and model 2, two
  steps each, against the port's one-process steps of the global batch
  (whose JAX parity ``test_torch_maskfiner_train.py`` holds): loss and grad
  norm within 1e-5 relative; parameters, moments and EMA within rtol 1e-5
  / atol 1e-7;
* the same at model 2 with Dropout and the attention kernels' dropout on:
  a layer split over the model axis drops its block of the one-process
  mask; the two ranks' Dropout masks differ and put together are the
  one-process mask;
* the same at data 2 with the attention kernels' dropout on: each data
  rank's kernels hash the global image index (its dropout seed offset to
  its first image), so the ranks drop what one process drops (at data 2 x
  model 2: ``test_torch_parallel_seq.py``);
* the tensor-parallel plan of tiny UD and OT against JAX's per-leaf specs:
  the leaves that differ are exactly the named classes;
* the sine position embedding of each rank's rows of the callers' grid
  against JAX ``mixres_common``'s on the global batch, 1e-6.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ml_autofocusformermod_torch.ckpt import io as ckpt_io
from ml_autofocusformermod_torch.ckpt.from_jax import torch_key
from ml_autofocusformermod_torch.config import load_config
from ml_autofocusformermod_torch.models.build import build_model
from ml_autofocusformermod_torch.models.layers import Dropout
from ml_autofocusformermod_torch.models.mixres_common import (
    grid_positions, sine_position_embedding)
from ml_autofocusformermod_torch.parallel import tp as port_tp
from ml_autofocusformermod_torch.train import trainer
from ml_autofocusformermod_tpu.models import mixres_common as jax_mixres
from ml_autofocusformermod_tpu.models.build import build_model as jax_build
from ml_autofocusformermod_tpu.parallel import tp as jax_tp
from test_maskfiner import tiny_mr
from torch_parallel_worker import launch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG_DIR = os.path.join(ROOT, "ml_autofocusformermod_torch", "configs")
UD_CFG = os.path.join(CFG_DIR, "maskfiner_up_down_mini.yaml")
GLOBAL_BATCH = 4
# name: (data, model, zero1)
LAYOUTS = {"dp": (2, 1, False), "zero": (2, 1, True), "tp": (1, 2, False),
           "tp_drop": (1, 2, False), "dp_attn_drop": (2, 1, False)}


def _opts(preset, data=1, **extra):
    n = 7 if "up_down" in preset else 4
    tiny = {"MODEL.NUM_CLASSES": 10, "DATA.IMG_SIZE": 64,
            "TPU.COMPUTE_DTYPE": "float32",
            "MODEL.MR.EMBED_DIM": ([32, 24, 16, 8] + [16, 24, 32])[:n],
            "MODEL.MR.DEPTHS": [1] * n, "MODEL.MR.NUM_HEADS": [2] * n,
            "MODEL.MR.MLP_RATIO": [2.0] * n,
            "DATA.BATCH_SIZE": GLOBAL_BATCH // data, **extra}
    flat = []
    for k, v in tiny.items():
        flat += [k, json.dumps(v)]
    return flat


MIX = {"TRAIN.USE_EMA": True, "AUG.MIXUP": 0.8, "AUG.CUTMIX": 1.0,
       "MODEL.MR.DROP_PATH_RATE": 0.1}
# Dropout on every level; the attention kernels' dropout on the levels
# whose head width is a multiple of 8, as JAX requires
DROP = {**MIX, "MODEL.MR.EMBED_DIM": [32, 24, 16, 16, 16, 24, 32],
        "MODEL.MR.DROP_RATE": [0.2] * 7,
        "MODEL.MR.ATTN_DROP_RATE": [0.0, 0.0, 0.2, 0.2, 0.2, 0.0, 0.0]}
# the attention kernels' dropout alone: under data parallelism Dropout
# draws from a stream per data rank, the kernels' hash from the global one
ATTN_DROP = {k: v for k, v in DROP.items() if k != "MODEL.MR.DROP_RATE"}
# the Dropout mask case: this rank's block (2, 3, 4) of a (2, 6, 4)
# activation split along dim 1
MASK = {"shape": [2, 3, 4], "dim": 1, "seed": 5}


def _variant(name):
    return {"tp_drop": DROP, "dp_attn_drop": ATTN_DROP}.get(name, MIX)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("parallel_ud"))
    rng = np.random.default_rng(3)
    batches = [(torch.from_numpy(rng.standard_normal(
        (GLOBAL_BATCH, 3, 64, 64)).astype(np.float32)),
        torch.arange(GLOBAL_BATCH) % 10) for _ in range(2)]
    torch.save(batches, os.path.join(tmp, "batches.pt"))

    one = {}
    for variant in (MIX, DROP, ATTN_DROP):
        cfg = load_config(UD_CFG, opts=_opts(UD_CFG, **variant))
        model = build_model(cfg, "cpu")
        state, schedule = trainer.create_train_state(cfg, model, 10)
        step = trainer.make_train_step(cfg, state, schedule)
        ref = one[id(variant)] = {"metrics": []}
        for x, y in batches:
            m = step(x, y)
            ref["metrics"].append({"loss": m["loss"].item(),
                                   "grad_norm": m["grad_norm"].item()})
        ref["full"] = ckpt_io._payload(state, 0, 0.0)["state"]

    cases = [{"name": name, "cfg": UD_CFG,
              "opts": _opts(UD_CFG, data, **_variant(name)), "data": data,
              "model": model_size, "zero1": zero1,
              "batches": os.path.join(tmp, "batches.pt")}
             for name, (data, model_size, zero1) in LAYOUTS.items()]
    cases.append({"name": "mask", "kind": "dropout", **MASK})
    return {"one": {name: one[id(_variant(name))] for name in LAYOUTS},
            "ranks": launch(os.path.join(tmp, "two"), 2, cases)}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_ud_two_steps_match_one_process(runs, name):
    one = runs["one"][name]
    for r in runs["ranks"]:
        got = r[name]
        for m, ref in zip(got["metrics"], one["metrics"]):
            assert m["finite"]
            assert m["loss"] == pytest.approx(ref["loss"], rel=1e-5)
            assert m["grad_norm"] == pytest.approx(ref["grad_norm"],
                                                   rel=1e-5)
    full = runs["ranks"][0][name]["full"]
    bad = []
    for part in ("model", "ema"):
        bad += [f"{part} {k}" for k, t in one["full"][part].items()
                if not np.allclose(full[part][k].double().numpy(),
                                   t.double().numpy(), rtol=1e-5, atol=1e-7)]
    for moment in ("mu", "nu"):
        bad += [f"{moment} {k}"
                for k, t in one["full"]["optimizer"][moment].items()
                if not np.allclose(full["optimizer"][moment][k].numpy(),
                                   t.numpy(), rtol=1e-5, atol=1e-7)]
    assert bad == []
    if name.startswith("tp"):  # MixResViT's qkv by heads
        blocks = runs["ranks"][0][name]["blocks"]["model"]
        k = "backbones.0.layers.blocks.0.attn.qkv.weight"
        assert blocks[k].shape[0] * 2 == one["full"]["model"][k].shape[0]


def _differ(preset, tp):
    """The torch keys whose tensor-parallel dim differs from JAX's."""
    cfg = tiny_mr(os.path.basename(preset))
    jmodel = jax_build(cfg)
    key = jax.random.PRNGKey(0)
    params = jax.eval_shape(
        lambda x: jmodel.init({"params": key, "upsample": key}, x,
                              training=False),
        jnp.zeros((1, 64, 64, 3)))["params"]
    model = build_model(load_config(preset, opts=_opts(preset)), "cpu")
    plan = port_tp.plan(model, tp)
    heads = {name: mod.num_heads if hasattr(mod, "num_heads") else mod.heads
             for name, mod, _ in port_tp._layers(model)
             if hasattr(mod, "num_heads") or hasattr(mod, "heads")}
    out = {}

    def walk(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, path + (k,))
            else:
                yield path + (k,), v

    for path, leaf in walk(params):
        k = torch_key(path)
        spec = tuple(jax_tp.spec_for_path("params/" + "/".join(path),
                                          leaf.shape, tp))
        order = port_tp.jax_dim_order(k, len(leaf.shape))
        ref = order[spec.index("model")] if "model" in spec else None
        mine = plan[k][0] if k in plan else None
        if mine != ref:
            layer = k.rsplit(".attn.", 1)[0] + ".attn" if ".attn." in k \
                else None
            out[k] = (mine, ref, heads.get(layer))
    return out


@pytest.mark.parametrize("preset", ["maskfiner_up_down_mini.yaml",
                                    "maskfiner_oracle_teacher.yaml"])
@pytest.mark.parametrize("tp", [2, 4])
def test_maskfiner_plan_matches_jax_specs(preset, tp):
    """Where the port's tensor-parallel dim differs from JAX's, the leaf is
    one of two named classes: (a) MixResViT's depthwise conv
    (``mlp.dwconv.dwconv``), which JAX's rule ``mlp/dwconv/kernel$`` does
    not reach under its nested flax path, so JAX replicates it and the
    port shards it with fc1; (b) a leaf of an attention layer whose two
    heads do not divide by ``tp``, which the port keeps whole where JAX
    shards the leaves whose dims divide."""
    differ = _differ(os.path.join(CFG_DIR, preset), tp)
    dwconv = {k for k in differ if ".mlp.dwconv.dwconv." in k}
    assert dwconv and all(differ[k][:2] == (0, None) for k in dwconv)
    rest = {k: v for k, v in differ.items() if k not in dwconv}
    for k, (mine, ref, heads) in rest.items():
        assert mine is None and ref is not None and heads % tp, k
    assert bool(rest) == (tp == 4)


def test_sine_embedding_takes_the_global_max():
    """The callers embed the same grid for every image, so the max of each
    data rank's rows is the global batch's: the embeddings of two ranks'
    halves of the batch, each alone, equal JAX's on the global batch
    (1e-6)."""
    grid = grid_positions(64, 48, 8, 4, 1, torch.device("cpu"))
    pos = grid[None].expand(GLOBAL_BATCH, *grid.shape)[:, :, 1:]
    ref = np.asarray(jax_mixres.sine_position_embedding(
        jnp.asarray(pos.numpy()), 16))
    half = GLOBAL_BATCH // 2
    got = torch.cat([sine_position_embedding(pos[:half], 16),
                     sine_position_embedding(pos[half:], 16)]).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


def test_split_dropout_draws_the_one_process_mask(runs):
    """At model 2 each rank's Dropout drops its own block: the two ranks'
    masks differ, and put together along the split dim they are the mask
    one process draws for the whole activation from the same seed."""
    masks = [r["mask"]["keep"] for r in runs["ranks"]]
    assert masks[0].shape == tuple(MASK["shape"])
    assert not torch.equal(masks[0], masks[1])
    shape = list(MASK["shape"])
    shape[MASK["dim"]] *= 2
    drop = Dropout(0.5).train()
    drop.generator = torch.Generator().manual_seed(MASK["seed"])
    one = drop(torch.ones(shape)) != 0
    assert torch.equal(torch.cat(masks, dim=MASK["dim"]), one)
