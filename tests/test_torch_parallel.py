"""Data and tensor parallelism with ZeRO-1 in the port, on the tiny AFF of
``tests/test_tp.py`` (BatchNorm in PatchEmbed, EMA on), against the JAX
package's mesh step and against the port's own one-process step of the
global batch (CPU, gloo ranks in subprocesses: ``torch_parallel_worker``).

* the tensor-parallel plan and the ZeRO-1 dims against JAX's
  ``tp.spec_for_path`` / ``zero.zero1_spec_for_path``, leaf by leaf;
* one step at data 2, data 2 + ZeRO-1, model 2 and data 2 x model 2 (with
  and without ZeRO-1) against JAX's step on the matching CPU mesh, from the
  same weights (``ckpt/from_jax.py::rank_state_dict_from_flax``): loss and
  grad norm within 1e-4 relative, the limit of
  ``test_torch_train.py::test_train_step_matches_jax_step``;
* two steps with mixup, cutmix and DropPath on (mixup's partner rows come
  from the mirror data rank) against the port's one-process step of the
  global batch: loss and grad norm within 1e-5 relative; parameters,
  moments and EMA within rtol 1e-5 / atol 1e-7 (the optimizer test's
  limits), but for the one parameter whose gradient is rounding noise
  (:data:`NOISE_GRADIENT_LEAVES`), held to AdamW's step bound;
* ZeRO-1 halves each rank's moments and EMA; tensor parallelism halves the
  q shard;
* checkpoints move between four ranks (ZeRO-1 + TP) and one process.
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
from ml_autofocusformermod_torch.parallel import tp as port_tp
from ml_autofocusformermod_torch.parallel import zero as port_zero
from ml_autofocusformermod_torch.train import trainer
from ml_autofocusformermod_tpu.config import load_config as jax_load_config
from ml_autofocusformermod_tpu.models.aff import AutoFocusFormer as JaxAFF
from ml_autofocusformermod_tpu.parallel import mesh as jax_mesh
from ml_autofocusformermod_tpu.parallel import tp as jax_tp
from ml_autofocusformermod_tpu.parallel import zero as jax_zero
from ml_autofocusformermod_tpu.train import trainer as jax_trainer
from torch_parallel_worker import launch

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CFG = os.path.join(ROOT, "ml_autofocusformermod_torch", "configs",
                        "aff_mini.yaml")
JAX_CFG = os.path.join(ROOT, "ml_autofocusformermod_tpu", "configs",
                       "aff_mini.yaml")
TINY = {  # tests/test_tp.py::_tiny_cfg
    "MODEL.NUM_CLASSES": 10, "MODEL.AFF.EMBED_DIM": [16, 32, 48, 64],
    "MODEL.AFF.DEPTHS": [1, 1, 1, 1], "MODEL.AFF.NUM_HEADS": [2, 2, 4, 4],
    "DATA.IMG_SIZE": 56, "TPU.COMPUTE_DTYPE": "float32",
    "TRAIN.USE_EMA": True, "AUG.MIXUP": 0.0, "AUG.CUTMIX": 0.0,
    "MODEL.DROP_PATH_RATE": 0.0,
}
MIX = {"AUG.MIXUP": 0.8, "AUG.CUTMIX": 1.0, "MODEL.DROP_PATH_RATE": 0.1}
# a clip below the tiny AFF's gradient norms (about 2.9): every step clips
CLIP = {"TRAIN.CLIP_GRAD": 1.0}
GLOBAL_BATCH = 8
# name: (data, model, zero1)
LAYOUTS = {"dp": (2, 1, False), "zero": (2, 1, True), "tp": (1, 2, False),
           "tp22": (2, 2, False), "tp22_zero": (2, 2, True)}


def _opts(data, **extra):
    flat = []
    for k, v in {**TINY, "DATA.BATCH_SIZE": GLOBAL_BATCH // data,
                 **extra}.items():
        flat += [k, json.dumps(v) if not isinstance(v, str) else v]
    return flat


def _jax_model():
    return JaxAFF(num_classes=10, embed_dim=(16, 32, 48, 64),
                  depths=(1, 1, 1, 1), num_heads=(2, 2, 4, 4), img_size=56,
                  drop_path_rate=0.0)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


# ------------------------------------------------------------ the plans ----

def _port_dims(model, tp, data):
    """{torch key: (tp dim, zero dim)} of the port's layout."""
    specs = port_tp.plan(model, tp)
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    zero = port_zero.zero1_plan(shapes, specs, data)
    return {k: (specs[k][0] if k in specs else None, zero.get(k))
            for k in shapes}


def _jax_dims(params, tp, data):
    """{torch key: (tp dim, zero dim)} of JAX's specs, as torch dims."""
    out = {}
    for path, leaf in _flat(params):
        key = torch_key(path)
        flax = "/".join(path)
        order = port_tp.jax_dim_order(key, len(leaf.shape))

        def dim(spec, axis):
            spec = tuple(spec)
            return order[spec.index(axis)] if axis in spec else None

        tp_dim = dim(jax_tp.spec_for_path("params/" + flax, leaf.shape, tp),
                     "model")
        zero_specs = [jax_zero.zero1_spec_for_path(
            f"{prefix}/{flax}", leaf.shape, data, tp)
            for prefix in ("opt_state/0/mu", "opt_state/0/nu", "ema_params")]
        zero_dims = {dim(s, "data") for s in zero_specs}
        assert len(zero_dims) == 1, (key, zero_specs)
        out[key] = (tp_dim, zero_dims.pop())
    return out


def _aff_params():
    return jax.eval_shape(_jax_model().init, jax.random.PRNGKey(0),
                          jnp.zeros((1, 56, 56, 3)))["params"]


# the tiny AFF's per-layer replications at model size 4: stages 0 and 1
# have two heads, so their attention stays whole in the port, where JAX
# shards the leaves whose dims divide by 4 (all but pos_embed)
AFF_TP4_REPLICATED = sorted(
    f"layers.{s}.blocks.0.attn.{leaf}" for s in (0, 1)
    for leaf in ("q.weight", "q.bias", "kv.weight", "kv.bias", "blank_k",
                 "blank_v", "proj.weight"))


@pytest.mark.parametrize("tp,data", [(1, 2), (2, 2), (2, 4), (4, 2),
                                     (4, 4)])
def test_plan_matches_jax_specs(tp, data):
    """Every leaf's tensor-parallel dim and ZeRO-1 dim (of its moments and
    EMA) equals JAX's, as torch dims, except the leaves of the layers the
    port keeps whole (:data:`AFF_TP4_REPLICATED`, and the ZeRO-1 dims of
    their moments, which then take the first free dim)."""
    model = build_model(load_config(PORT_CFG, opts=_opts(1)), "cpu")
    port = _port_dims(model, tp, data)
    ref = _jax_dims(_aff_params(), tp, data)
    assert set(port) == set(ref)
    differ = sorted(k for k in port if port[k] != ref[k])
    assert differ == (AFF_TP4_REPLICATED if tp == 4 else [])
    for k in differ:
        assert port[k][0] is None and ref[k][0] is not None, k
    assert any(port[k][1] is not None for k in port)


def test_indivisible_leaves_stay_replicated():
    """JAX ``test_tp.py:103-108``: a dim that does not divide falls back to
    replication, per leaf and per layer."""
    assert port_tp.spec_for_key("x.attn.q.weight", (18, 16), 4) is None
    assert jax_tp.spec_for_path("x/attn/q/kernel", (16, 18), tp=4) == \
        jax.sharding.PartitionSpec()
    assert port_tp.spec_for_key("x.attn.q.weight", (16, 16), 4) == (0, 1)
    assert port_tp.spec_for_key("x.attn.qkv.weight", (48, 16), 4) == (0, 3)
    assert port_tp.spec_for_key("x.attn.qkv.weight", (36, 12), 8) is None
    assert port_zero.zero1_dim("a.bias", (6,), None, 4) is None
    assert port_zero.zero1_dim("a.weight", (32, 16), None, 4) == 1
    assert port_zero.zero1_dim("x.attn.q.weight", (32, 16), (0, 1), 4) == 1


# ----------------------------------------------------------- the steps ----

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX mesh steps, the port's one-process steps and the rank runs
    (two ranks, then four), computed once for the module."""
    tmp = str(tmp_path_factory.mktemp("parallel"))
    rng = np.random.default_rng(1)
    jmodel = _jax_model()
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 56, 56, 3)))
    variables = jax.tree_util.tree_map_with_path(
        lambda path, leaf: (
            rng.uniform(0.5, 1.5, leaf.shape) if path[-1].key == "var"
            else (path[-1].key == "scale") + 0.1 * rng.standard_normal(
                leaf.shape)).astype(np.float32), shapes)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    torch.save(variables, os.path.join(tmp, "variables.pt"))
    batches = [(rng.standard_normal((GLOBAL_BATCH, 3, 56, 56)).astype(
        np.float32), np.arange(GLOBAL_BATCH) % 10) for _ in range(2)]
    torch.save([(torch.from_numpy(x), torch.from_numpy(y))
                for x, y in batches], os.path.join(tmp, "batches.pt"))
    torch.save([(torch.from_numpy(x), torch.from_numpy(y))
                for x, y in batches[1:]], os.path.join(tmp, "batch2.pt"))

    # JAX: one step on each layout's CPU mesh (mixup off, as JAX's own
    # mesh tests have it)
    jax_cfg = jax_load_config(JAX_CFG, opts=_opts(1, **{
        "DATA.BATCH_SIZE": GLOBAL_BATCH}))
    image = np.ascontiguousarray(batches[0][0].transpose(0, 2, 3, 1))
    jax_ref = {}
    for name in ("dp", "zero", "tp", "tp22_zero"):
        data, model, zero1 = LAYOUTS[name]
        state, tx, schedule = jax_trainer.create_train_state(
            jax_cfg, jmodel, None, None, n_steps_per_epoch=10,
            variables=variables)
        mesh = jax_mesh.make_mesh(data=data, model=model,
                                  devices=jax.devices()[:data * model])
        state = (jax_zero if zero1 else jax_tp).shard_tree(mesh, state)
        step = jax.jit(jax_trainer.make_train_step(jax_cfg, jmodel, tx,
                                                   schedule))
        batch = jax_mesh.shard_batch(mesh, {"image": image,
                                            "label": batches[0][1]})
        with mesh, jax.default_matmul_precision("highest"):
            _, m = step(state, batch, jax.random.PRNGKey(42))
        jax_ref[name] = (float(m["loss"]), float(m["grad_norm"]))
    jax_ref["tp22"] = jax_ref["tp22_zero"]

    # the port's one-process steps of the global batch, mixup on; the
    # checkpoint after the first one; again with every step clipped
    def one_process(**extra):
        cfg = load_config(PORT_CFG, opts=_opts(1, **MIX, **extra))
        model = build_model(cfg, "cpu")
        state, schedule = trainer.create_train_state(cfg, model, 10)
        step = trainer.make_train_step(cfg, state, schedule)
        one = {"metrics": []}
        for i, (x, y) in enumerate(batches):
            m = step(torch.from_numpy(x), torch.from_numpy(y))
            one["metrics"].append({"loss": m["loss"].item(),
                                   "grad_norm": m["grad_norm"].item()})
            if i == 0 and not extra:
                ckpt_io.save_checkpoint(os.path.join(tmp, "one"), 0, state,
                                        0.0)
        one["full"] = ckpt_io._payload(state, 0, 0.0)["state"]
        return one

    one, one_clip = one_process(), one_process(**CLIP)

    def case(name, mix, data, model, zero1, **extra):
        return {"name": name, "cfg": PORT_CFG,
                "opts": _opts(data, **(MIX if mix else {})), "data": data,
                "model": model, "zero1": zero1, **extra}

    two, four = [], []
    for name, (data, model, zero1) in LAYOUTS.items():
        cases = two if data * model == 2 else four
        cases.append(case(name + "/jax", False, data, model, zero1,
                          variables=os.path.join(tmp, "variables.pt"),
                          batches=os.path.join(tmp, "batches.pt")))
        if name != "tp22":
            cases.append(case(name + "/mix", True, data, model, zero1,
                              batches=os.path.join(tmp, "batches.pt")))
    four[-1]["save"] = os.path.join(tmp, "ranks")
    clip = case("clip/mix", True, 2, 1, True,
                batches=os.path.join(tmp, "batches.pt"))
    clip["opts"] = _opts(2, **MIX, **CLIP)
    two.append(clip)
    two.append(case("resume", True, 2, 1, True,
                    resume=os.path.join(tmp, "one", "ckpt_epoch_0.pt"),
                    batches=os.path.join(tmp, "batch2.pt")))
    ranks = {2: launch(os.path.join(tmp, "two"), 2, two),
             4: launch(os.path.join(tmp, "four"), 4, four)}
    return {"jax": jax_ref, "one": one, "one_clip": one_clip,
            "ranks": ranks, "tmp": tmp}


def _lrs(runs):
    """The learning rates of the two steps (every run's are the same)."""
    return [m["lr"] for m in _ranks(runs, "dp/mix")[0]["metrics"]]


def _ranks(runs, name):
    data, model, _ = LAYOUTS.get(name.split("/")[0], (2, 1, True))
    return [r[name] for r in runs["ranks"][data * model]]


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_step_matches_jax_mesh_step(runs, name):
    """Loss and grad norm of the first step on every rank equal JAX's step
    on the matching mesh (rel 1e-4)."""
    loss, norm = runs["jax"][name]
    for r in _ranks(runs, name + "/jax"):
        m = r["metrics"][0]
        assert m["finite"]
        assert m["loss"] == pytest.approx(loss, rel=1e-4)
        assert m["grad_norm"] == pytest.approx(norm, rel=1e-4)


def _state_mismatches(full, ref):
    """The names of the tensors of the gathered state ``full`` that differ
    from ``ref`` beyond rtol 1e-5 / atol 1e-7."""
    pairs = [(f"{part} {k}", full[part][k], t)
             for part in ("model", "ema") for k, t in ref[part].items()]
    pairs += [(f"{m} {k}", full["optimizer"][m][k], t)
              for m in ("mu", "nu") for k, t in ref["optimizer"][m].items()]
    return [name for name, a, b in pairs
            if not np.allclose(a.double().numpy(), b.double().numpy(),
                               rtol=1e-5, atol=1e-7)]


# PatchEmbed's first conv feeds a batch-statistics BatchNorm, which takes
# the mean out: the gradient of its bias is zero in exact arithmetic, so in
# both runs it is rounding noise of the summation order, and AdamW's
# normalised update moves it by up to the learning rate in either
# direction. It is held to that bound instead.
NOISE_GRADIENT_LEAVES = ("model patch_embed.proj1.bias",)


def _assert_state_close(full, ref, what, lrs=()):
    assert full["step"] == ref["step"]
    bad = _state_mismatches(full, ref)
    assert [n for n in bad if n not in NOISE_GRADIENT_LEAVES] == [], what
    for name in bad:
        k = name.split(" ", 1)[1]
        diff = (full["model"][k] - ref["model"][k]).abs().max().item()
        assert diff <= 2 * sum(lrs) * 1.001, (what, name, diff, lrs)


@pytest.mark.parametrize("name", ["dp", "zero", "tp", "tp22_zero", "clip"])
def test_two_steps_match_one_process(runs, name):
    """Two steps with mixup, cutmix and DropPath on equal the one-process
    steps of the global batch: loss and grad norm (rel 1e-5) on every rank,
    and the gathered parameters, moments and EMA. ``clip``: data 2 with
    ZeRO-1 at a clip below every step's gradient norm, so AdamW updates
    the cut leaves' blocks from clipped gradients."""
    one = runs["one_clip" if name == "clip" else "one"]
    if name == "clip":
        assert min(m["grad_norm"] for m in one["metrics"]) > \
            CLIP["TRAIN.CLIP_GRAD"]
    ranks = _ranks(runs, name + "/mix")
    for r in ranks:
        for m, ref in zip(r["metrics"], one["metrics"]):
            assert m["loss"] == pytest.approx(ref["loss"], rel=1e-5)
            assert m["grad_norm"] == pytest.approx(ref["grad_norm"],
                                                   rel=1e-5)
    _assert_state_close(ranks[0]["full"], one["full"], name,
                        [m["lr"] for m in ranks[0]["metrics"]])


def test_zero1_cuts_moments_and_ema(runs):
    """Under ZeRO-1 each of two data ranks holds about half of the moments'
    and the EMA's elements; without it, all of them."""
    def numel(r, part):
        tree = (r["blocks"]["optimizer"]["mu"] if part == "mu"
                else r["blocks"]["ema"])
        return sum(t.numel() for t in tree.values())

    full = _ranks(runs, "dp/mix")[0]
    for r in _ranks(runs, "zero/mix"):
        for part in ("mu", "ema"):
            share = numel(r, part) / numel(full, part)
            assert 0.45 < share < 0.55, (part, share)
    assert numel(_ranks(runs, "tp/mix")[0], "mu") < numel(full, "mu")


def test_tp_holds_half_the_heads(runs):
    """At model size 2 each rank's q projection is half-width (JAX
    ``test_tp.py:128-152``), its pos_embed holds half the heads, and the
    EMA and moments of q are cut the same way."""
    full = _ranks(runs, "dp/mix")[0]["blocks"]
    for r in _ranks(runs, "tp/mix"):
        blocks = r["blocks"]
        for k in ("layers.0.blocks.0.attn.q.weight",
                  "layers.3.blocks.0.attn.pos_embed.weight"):
            assert blocks["model"][k].shape[0] * 2 == \
                full["model"][k].shape[0]
            assert blocks["ema"][k].shape == blocks["model"][k].shape
            assert blocks["optimizer"]["mu"][k].shape == \
                blocks["model"][k].shape
        assert r["layout"]["tp"]["layers.0.blocks.0.attn.proj.weight"] == \
            (1, 1)


def test_ranks_checkpoint_loads_in_one_process(runs):
    """The four-rank ZeRO-1 + TP checkpoint loads into one process, and
    each rank's blocks of it equal what the rank held, bit for bit."""
    cfg = load_config(PORT_CFG, opts=_opts(1, **MIX))
    state, _ = trainer.create_train_state(cfg, build_model(cfg, "cpu"), 10)
    path = os.path.join(runs["tmp"], "ranks", "ckpt_epoch_0.pt")
    ckpt_io.load_checkpoint(path, state)
    loaded = ckpt_io._payload(state, 0, 0.0)["state"]
    assert loaded["step"] == 2
    _assert_state_close(loaded, runs["one"]["full"], "one-process load",
                        _lrs(runs))
    for r in _ranks(runs, "tp22_zero/mix"):
        layout = port_zero.Layout(_FakeMesh(**r["coords"]),
                                  r["layout"]["tp"], r["layout"]["zero"])
        blocks = r["blocks"]
        local = ckpt_io.local_tensor
        for k, t in blocks["model"].items():
            assert torch.equal(local(k, loaded["model"][k], layout, False),
                               t), k
        for k, t in blocks["ema"].items():
            assert torch.equal(local(k, loaded["ema"][k], layout, True), t), k
        for moment in ("mu", "nu"):
            for k, t in blocks["optimizer"][moment].items():
                assert torch.equal(local(k, loaded["optimizer"][moment][k],
                                         layout, True), t), k


class _FakeMesh:
    """The coordinates of a rank of the four-rank (2 x 2) mesh."""

    data = model = 2
    seq = 1

    def __init__(self, data_rank, model_rank):
        self.data_rank, self.model_rank = data_rank, model_rank


def test_one_process_checkpoint_resumes_on_two_ranks(runs):
    """The one-process checkpoint after step 1 resumes on two ZeRO-1 data
    ranks; their step 2 equals the one-process step 2."""
    ranks = _ranks(runs, "resume")
    ref = runs["one"]["metrics"][1]
    for r in ranks:
        assert r["metrics"][0]["loss"] == pytest.approx(ref["loss"],
                                                        rel=1e-5)
        assert r["metrics"][0]["grad_norm"] == pytest.approx(
            ref["grad_norm"], rel=1e-5)
    _assert_state_close(ranks[0]["full"], runs["one"]["full"], "resume",
                        _lrs(runs))


def test_layout_installs_its_mesh():
    """``make_layout`` installs its mesh, which the model's batch-wide
    reductions read; a train step refuses to run when the installed mesh
    is not its layout's, or when a mesh of data ranks is installed without
    a layout."""
    from ml_autofocusformermod_torch.parallel import mesh as port_mesh

    mesh = port_mesh.make_mesh(1, 1)
    try:
        layout = port_zero.make_layout(torch.nn.Linear(2, 2), mesh, False)
        assert port_mesh.current() is mesh
        trainer.check_mesh(layout)
        port_mesh.set_mesh(None)
        with pytest.raises(RuntimeError, match="make_layout"):
            trainer.check_mesh(layout)
        trainer.check_mesh(None)
        port_mesh.set_mesh(port_mesh.Mesh(2, 1, 1, 0, 0, 0))
        with pytest.raises(RuntimeError, match="make_layout"):
            trainer.check_mesh(None)
    finally:
        port_mesh.set_mesh(None)


def test_head_offset_seed_gives_the_global_heads_masks():
    """A tensor-parallel rank's attention-dropout seed, offset to its first
    head, gives at its local head h the mask of global head ``head0 + h``
    under the original seed (the kernels' hash, ``drop_keep``)."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        drop_keep, head_offset_seed)

    img = torch.arange(3)[:, None, None, None]
    head = torch.arange(2)[None, :, None, None]
    rows = torch.arange(16)[None, None, :, None]
    cols = torch.arange(24)[None, None, None, :]
    for seed, head0 in ((12345, 2), (2**31 - 2, 5)):
        local = drop_keep(head_offset_seed(seed, head0), img, head, rows,
                          cols, 0.3)
        assert torch.equal(local, drop_keep(seed, img, head + head0, rows,
                                            cols, 0.3))
        assert not torch.equal(local, drop_keep(seed, img, head, rows,
                                                cols, 0.3))
