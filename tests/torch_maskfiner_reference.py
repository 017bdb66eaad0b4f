"""JAX reference outputs for the port's MaskFiner parity tests.

    XLA_FLAGS=--xla_backend_optimization_level=0 JAX_PLATFORMS=cpu \
        python tests/torch_maskfiner_reference.py OUT.npz CASE [CASE ...]

Runs each case under ``jax.jit`` on random weights: a JAX MixResNeighbour
level (a name of ``LEVELS``), a tiny Oracle-Teacher or Up-Down model of
``tests/test_maskfiner.py::tiny_mr`` (a name of ``MODELS``), or one
training-mode loss and gradient of such a model (a name of ``TRAIN``:
``jax.value_and_grad`` with the "upsample" and "dropout" rng streams and
mutable batch statistics, as the JAX ``train/trainer.py`` takes it; a
name of ``TRAIN_DROP`` the same with attention dropout inside the fused
kernels, of ``TRAIN_REMAT`` with ``TPU.REMAT``, of ``TRAIN_MESH`` on a
``(data, model, seq)`` mesh of virtual CPU devices, the batch sharded over
``data`` and the tokens over ``seq`` as ``tests/test_sp.py`` runs it; its
process needs ``--xla_force_host_platform_device_count``), and writes the
weights, inputs, upsampling masks and outputs to
one ``.npz`` (keys ``case/params/...``, ``case/batch_stats/...``,
``case/in/...``, ``case/mask/j``, ``case/out/...``, ``case/grad/...``,
``case/new_stats/...``, and for ``TRAIN_DROP`` ``case/seeds``).

It runs as a process of its own because of the flag: XLA's CPU backend
otherwise contracts ``a * b + c`` into one fused multiply-add, and the
space-filling-curve sort key ``assign * (max + 1) + ratio`` then rounds
differently from the same function run op by op (eager JAX, and the port on
either device), which reorders tokens whose keys nearly tie. Optimisation
level 0 keeps every product and sum rounded on its own.

The models draw their masks from JAX's fixed-key fallback at eval and from
the "upsample" stream in training (``maskfiner_ot._upsample_rng``); this
script records each mask as the jitted forward made it, so the tests can
replay it into the port.
"""

import contextlib
import os
import sys

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_maskfiner import tiny_mr  # noqa: E402

from ml_autofocusformermod_tpu.models import (  # noqa: E402
    maskfiner_ot, maskfiner_ud,
)
from ml_autofocusformermod_tpu.models.build import build_model  # noqa: E402
from ml_autofocusformermod_tpu.models.mixres_neighbour import (  # noqa: E402
    MixResNeighbour,
)
from ml_autofocusformermod_tpu.ops import clusten_pallas  # noqa: E402

B = 2
IMG = 64
# whole-model cases: name -> (preset, config overrides)
MODELS = {
    "ot": ("maskfiner_oracle_teacher.yaml", {}),
    "ud": ("maskfiner_up_down_mini.yaml", {}),
    "ud_aux": ("maskfiner_up_down_mini.yaml", {"MODEL.MR.AUX_LOSS": True}),
}
# training cases: name -> (preset, config overrides, upscale ratios or
# None for the configured ones). Drop rates are 0 (OT's preset drops 0.2
# at level 1): JAX's dropout stream is not reproduced. "ud_train_r1" is
# the curriculum's first epoch: every token splits.
TRAIN = {
    "ot_train": ("maskfiner_oracle_teacher.yaml",
                 {"MODEL.MR.DROP_RATE": [0.0] * 4}, None),
    "ud_train": ("maskfiner_up_down_mini.yaml", {}, None),
    "ud_aux_train": ("maskfiner_up_down_mini.yaml",
                     {"MODEL.MR.AUX_LOSS": True}, None),
    "ud_train_r1": ("maskfiner_up_down_mini.yaml", {},
                    [0.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0]),
}
# training cases with attention dropout on the local levels (2-4 of the
# tiny Up-Down; its global levels would drop with flax's Dropout, whose
# stream the port does not reproduce), c_ = 8 at every one of them (JAX's
# fused dropout needs c_ % 8 == 0). Their JAX levels take the Pallas route
# (built as on a TPU, run in interpret mode here), whose kernels drop with
# the coordinate hash; the seed of each call is recorded in call order.
TRAIN_DROP = {
    "ud_train_attn_drop": ("maskfiner_up_down_mini.yaml", {
        "MODEL.MR.EMBED_DIM": [32, 24, 16, 16, 16, 24, 32],
        "MODEL.MR.ATTN_DROP_RATE": [0.0, 0.0, 0.25, 0.25, 0.25, 0.0, 0.0],
    }, None),
}
# training cases with the blocks recomputed in the backward (TPU.REMAT),
# at ratio 1.0 (every token splits), drop rates 0
TRAIN_REMAT = {
    f"ud_train_remat_{mode}": ("maskfiner_up_down_mini.yaml",
                               {"TPU.REMAT": mode},
                               [0.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
    for mode in ("blocks", "dots")
}
# training cases on a mesh: name -> (data, model, seq) of tiny Up-Down
TRAIN_MESH = {"ud_train_s2": (1, 1, 2), "ud_train_d2s2": (2, 1, 2),
              "ud_train_m2s2": (1, 2, 2)}
LABELS = np.array([3, 7])
# a first-layer level in training mode: its patch embedding's BatchNorm
# normalises with the batch statistics and updates its running ones; the
# loss is a fixed random projection of its output. Patches of 8 on 64^2:
# 64 tokens, clustered (nbhd 32).
FIRST_TRAIN = "first_level_train"
SMOOTHING = 0.1
# level cases: name -> (keep_old_scale, add_image_data_to_all, nbhd_size).
# A scale-2 level (patches 32/16/8 on a 64^2 image, min patch 4) that
# splits 9 of 12 scale-1 tokens into 36: 52 tokens with keep_old_scale, 43
# without, so nbhd 32 clusters them (4 nearest of 7 or 6 clusters, the last
# one padded) and nbhd 96 attends globally
LEVELS = {
    "keep_img1": (True, False, 32), "keep_imgall": (True, True, 32),
    "drop_img1": (False, False, 32), "drop_imgall": (False, True, 32),
    "keep_img1_global": (True, False, 96),
}
LEVEL_C, LEVEL_D = 24, 16
LEVEL_LAYOUT = {0: 4, 1: 12}

# the masks each jitted forward draws, as (tag, value), recorded by the two
# wrappers below
_captured = []
_orig_rng, _orig_normal = maskfiner_ot._upsample_rng, jax.random.normal


def _recording_rng(module, tag):
    _captured.append([tag, None])
    return _orig_rng(module, tag)


# the dropout seeds of the fused attention calls of one traced forward
_seeds = []
_orig_fca = clusten_pallas.fused_cluster_attention


def _recording_fca(*args, drop_seed=None, **kw):
    if drop_seed is not None:
        _seeds.append(drop_seed)
    return _orig_fca(*args, drop_seed=drop_seed, **kw)


def _build_pallas_route(cfg, ratios):
    """``build_model`` as on a TPU: the MixRes levels take the fused
    Pallas route (``maskfiner_{ot,ud}.py`` pick it by the backend)."""
    real = jax.default_backend
    jax.default_backend = lambda: "tpu"
    try:
        return build_model(cfg, upscale_ratios=ratios)
    finally:
        jax.default_backend = real


def _recording_normal(key, shape=(), dtype=jnp.float32):
    v = _orig_normal(key, shape, dtype)
    if _captured and _captured[-1][1] is None:
        _captured[-1][1] = v
    return v


def draw_weights(rng, shapes):
    """Random values on a variable tree's shapes (each leaf away from its
    default, so every layout transform of the import is exercised)."""
    def draw(path, leaf):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.standard_normal(leaf.shape)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def flat(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            flat(f"{prefix}/{k}", v, out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)


def level_inputs(rng):
    """4 scale-0 tokens (32^2 patches) and 12 scale-1 tokens (16^2) of a
    64^2 image, in min-patch units, shuffled per image; four scale-1
    tokens sit on scale-0 positions."""
    s0 = [(0, x, y) for y in (0, 8) for x in (0, 8)]
    s1 = [(1, x, y) for y in (0, 4, 8) for x in (0, 4, 8, 12)]
    pos = np.array(s0 + s1, np.float32)
    pos = np.stack([pos[rng.permutation(len(pos))] for _ in range(B)])
    return dict(
        im=rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32),
        features=rng.standard_normal((B, 16, LEVEL_C)).astype(np.float32),
        features_pos=pos,
        mask=rng.standard_normal((B, 12)).astype(np.float32),
    )


def run_level(out, name):
    keep, img_all, nbhd = LEVELS[name]
    rng = np.random.default_rng(11)
    inp = level_inputs(rng)
    level = MixResNeighbour(
        patch_sizes=(32, 16, 8), n_layers=2, d_model=LEVEL_D, n_heads=2,
        channels=LEVEL_C, mlp_ratio=2.0, n_scales=4, cluster_size=8,
        nbhd_size=nbhd, min_patch_size=4, upscale_ratio=0.75,
        keep_old_scale=keep, scale=2, add_image_data_to_all=img_all,
        layer_scale=1e-5, drop_path_rate=(0.0, 0.0))
    args = [jnp.asarray(inp[k])
            for k in ("im", "features", "features_pos", "mask")]

    def apply(v, im, f, fp, m):
        outs, layout = level.apply(v, im, 2, f, fp, m, LEVEL_LAYOUT)
        return {k: v for k, v in outs.items()
                if not isinstance(v, tuple)}, layout

    shapes = jax.eval_shape(lambda: level.init(
        jax.random.PRNGKey(0), args[0], 2, *args[1:], LEVEL_LAYOUT))
    variables = draw_weights(rng, shapes)
    outs, layout = jax.jit(apply)(variables, *args)
    flat(f"{name}/params", variables["params"], out)
    for k, v in inp.items():
        out[f"{name}/in/{k}"] = v
    for k, v in outs.items():
        out[f"{name}/out/{k}"] = np.asarray(v)
    for s, cnt in layout.items():
        out[f"{name}/layout/{s}"] = np.asarray(cnt)


def run_model(out, name):
    preset, opts = MODELS[name]
    rng = np.random.default_rng(5)
    model = build_model(tiny_mr(preset, **opts))
    x = rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x), training=False))
    variables = draw_weights(rng, shapes)

    def forward(v, x):
        del _captured[:]
        logits = model.apply(v, x, training=False)
        return logits, {int(t): m for t, m in _captured}

    logits, masks = jax.jit(forward)(variables, jnp.asarray(x))
    flat(f"{name}/params", variables["params"], out)
    out[f"{name}/in/x"] = x
    for j, m in masks.items():
        out[f"{name}/mask/{j}"] = np.asarray(m)
    if isinstance(logits, (list, tuple)):
        for i, lg in enumerate(logits):
            out[f"{name}/out/logits_{i}"] = np.asarray(lg)
    else:
        out[f"{name}/out/logits"] = np.asarray(logits)


def run_train(out, name):
    from ml_autofocusformermod_tpu.train.losses import (
        smooth_one_hot, soft_target_cross_entropy,
    )

    drop = name in TRAIN_DROP
    layout = TRAIN_MESH.get(name)
    preset, opts, ratios = ({**TRAIN, **TRAIN_REMAT, **TRAIN_DROP}[name]
                            if layout is None
                            else ("maskfiner_up_down_mini.yaml", {}, None))
    rng = np.random.default_rng(6)
    if drop:
        model = _build_pallas_route(tiny_mr(preset, **opts), ratios)
    else:
        model = build_model(tiny_mr(preset, **opts), upscale_ratios=ratios)
    x = rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.asarray(x), training=False))
    variables = draw_weights(rng, shapes)
    target = smooth_one_hot(jnp.asarray(LABELS), 10, SMOOTHING)
    stats0 = variables.get("batch_stats", {})  # none without a BatchNorm

    def loss_fn(params, x):
        del _captured[:]
        del _seeds[:]
        outputs, upd = model.apply(
            {"params": params, "batch_stats": stats0}, x,
            training=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(1),
                  "upsample": jax.random.PRNGKey(2)})
        if isinstance(outputs, (list, tuple)):
            losses = [soft_target_cross_entropy(o, target) for o in outputs]
            loss = sum(losses) / len(losses)
        else:
            loss = soft_target_cross_entropy(outputs, target)
        masks = {int(t): m for t, m in _captured}
        seeds = jnp.concatenate(_seeds) if _seeds else jnp.zeros(0, jnp.int32)
        return loss, (upd.get("batch_stats", {}), masks, seeds)

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    params, xin = variables["params"], jnp.asarray(x)
    mesh = contextlib.nullcontext()
    if layout is not None:
        from ml_autofocusformermod_tpu.parallel import mesh as pmesh
        from ml_autofocusformermod_tpu.parallel import tp

        data, model_size, seq = layout
        mesh = pmesh.make_mesh(data, model_size, seq,
                               devices=jax.devices()[:data * model_size * seq])
        params = tp.shard_tree(mesh, {"params": params})["params"]
        xin = pmesh.shard_batch(mesh, {"x": x})["x"]
    with mesh, jax.default_matmul_precision("highest"):
        (loss, (stats, masks, seeds)), grads = step(params, xin)
    flat(f"{name}/params", variables["params"], out)
    flat(f"{name}/batch_stats", stats0, out)
    flat(f"{name}/grad", grads, out)
    flat(f"{name}/new_stats", stats, out)
    out[f"{name}/in/x"] = x
    out[f"{name}/in/labels"] = LABELS
    out[f"{name}/out/loss"] = np.asarray(loss)
    for j, m in masks.items():
        out[f"{name}/mask/{j}"] = np.asarray(m)
    if drop:
        out[f"{name}/seeds"] = np.asarray(seeds)


def run_first_level_train(out, name):
    rng = np.random.default_rng(12)
    level = MixResNeighbour(
        patch_sizes=(8,), n_layers=1, d_model=LEVEL_D, n_heads=2,
        mlp_ratio=2.0, n_scales=4, cluster_size=8, nbhd_size=32,
        min_patch_size=4, upscale_ratio=0.0, scale=0, first_layer=True,
        drop_path_rate=(0.0,))
    im = rng.standard_normal((B, IMG, IMG, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: level.init(
        jax.random.PRNGKey(0), jnp.asarray(im), 0, None, None, None, {}))
    variables = draw_weights(rng, shapes)
    w = rng.standard_normal((B, 64, LEVEL_D)).astype(np.float32)

    def loss_fn(params, im):
        (outs, _), upd = level.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, im,
            0, None, None, None, {}, training=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(1)})
        return (outs["res5"] * w).sum(), upd["batch_stats"]

    step = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    with jax.default_matmul_precision("highest"):
        (loss, stats), grads = step(variables["params"], jnp.asarray(im))
    flat(f"{name}/params", variables["params"], out)
    flat(f"{name}/batch_stats", variables["batch_stats"], out)
    flat(f"{name}/grad", grads, out)
    flat(f"{name}/new_stats", stats, out)
    out[f"{name}/in/im"] = im
    out[f"{name}/in/w"] = w
    out[f"{name}/out/loss"] = np.asarray(loss)


def main():
    maskfiner_ot._upsample_rng = _recording_rng
    maskfiner_ud._upsample_rng = _recording_rng
    jax.random.normal = _recording_normal
    clusten_pallas.fused_cluster_attention = _recording_fca
    path, cases = sys.argv[1], sys.argv[2:]
    out = {}
    for case in cases:
        run = (run_model if case in MODELS else
               run_train if case in {**TRAIN, **TRAIN_REMAT, **TRAIN_DROP,
                                     **TRAIN_MESH}
               else
               run_first_level_train if case == FIRST_TRAIN else run_level)
        run(out, case)
    np.savez(path, **out)


if __name__ == "__main__":
    main()


# ---- helpers for the tests (run in the test process) ----

def run_reference(tmp_dir, *groups, devices: int = 1):
    """Run this script on each group of cases, all groups at once, each in
    a process of its own with XLA at optimisation level 0 (and ``devices``
    virtual CPU devices); returns the merged arrays."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    flags = "--xla_backend_optimization_level=0"
    if devices > 1:
        flags += f" --xla_force_host_platform_device_count={devices}"
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags,
               PYTHONPATH=os.pathsep.join(
                   [root] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    procs = []
    for i, cases in enumerate(groups):
        path = os.path.join(str(tmp_dir), f"ref{i}.npz")
        procs.append((path, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), path, *cases],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    out = {}
    for path, proc in procs:
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"JAX reference failed:\n{log}")
        with np.load(path) as data:
            out.update({k: data[k] for k in data.files})
    return out


def unflatten(arrays, prefix):
    """The nested ``{name: ...}`` tree of the arrays under ``prefix/``."""
    tree = {}
    for key, v in arrays.items():
        if not key.startswith(prefix + "/"):
            continue
        node = tree
        parts = key[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree
