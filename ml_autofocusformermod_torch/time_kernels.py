"""Times of the hand-written kernels at the AFF-Mini 224 b128 shapes, and
the timers and inputs that ``chip_smoke.py`` uses for its kernel_time
lines.

    python3 -m ml_autofocusformermod_torch.time_kernels [--merge]
        [--layer-norm] [--cfg PRESET [--train]] [--dtype bfloat16|float32]
        [LABEL]

times this checkout: the attention kernels at stages 1-3 (each with its
stage's tile metadata made beforehand, as the model calls them), or with
``--merge`` the merge kernels at merges 1-3 (the backward makes its
inverse index inside, as the model calls it), or with ``--cfg`` and a
MaskFiner preset (``maskfiner_up_down_mini.yaml``, ...) the attention
forward at each token count of that model's forward, on the inputs a
forward of the model (random weights, synthetic images) gave the kernel
(with ``--train`` the attention forward and backward at each token count
of a training step, at the curriculum's first ratios, all 1.0, and at the
final ones), or with ``--layer-norm`` the LayerNorm kernels at each input
shape of a training step of the benchmark's three models (AFF-Mini and
UD-Mini at ratio 0.9 at b128, AFF-Base-384 at b16; :data:`LN_MODELS`).
Run as a file from the root
of another checkout, ``python3 <this checkout>/ml_autofocusformermod_torch/
time_kernels.py [--merge] LABEL``, it times that checkout's kernels, so
that several variants (or the parent and the change) can be timed on one
card one after another. Prints one JSON line: per shape and direction
``ms`` (:func:`time_ms`, single calls) and ``device_ms``
(:func:`device_ms`, calls queued back to back), for the merges also the
inverse index alone (where the checkout has one), and the card's
``nvidia-smi`` name and power limit.

The attention is timed in each mode the checkout has
(:func:`attention_calls`): ``fwd`` (inference), ``fwd_stats`` (training:
the saved statistics too), ``fwd_drop`` (training with attention
dropout, ``DROP_RATE``), ``bwd`` (the backward as training calls it: from
the saved statistics, or recomputing them with ``MLAFF_BWD_SAVED=0``),
``bwd_recompute`` and ``bwd_saved`` (both modes, in one run) and
``bwd_drop``; a checkout without the modes has ``fwd`` and ``bwd`` only.

The LayerNorm is timed per distinct (width, rows, layout) of a model's
forward: ``fwd`` (``ops/layer_norm.py::layer_norm``, the copy of
PatchEmbed's transposed rows included), ``bwd`` (its two backward
kernels), ``fwd_bwd`` (the forward with autograd and its backward), the
plain expression's ``plain_fwd``, ``plain_bwd`` (autograd's backward of
one forward, run again) and ``plain_fwd_bwd``, and ``bound``:
the bytes the kernels must move (x read and y written, 8 bytes of
statistics a row; x and g read and dx written) over 3.35 TB/s; then per
model the sums over a step's calls. The passes through autograd start from
empty gradients, as dx reaches the layer before in the model (no
accumulating add over x's size). A checkout without the kernels times
the plain expression only.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

# AFF-Mini 224: (label, tokens, heads, channels, attention launches per
# forward) of the local stages; (label, n, n', c) of the merges
ATTN_STAGES = [("stage1", 3136, 2, 32, 2), ("stage2", 784, 4, 128, 2),
               ("stage3", 196, 8, 256, 6)]
MERGES = [("merge1", 3136, 784, 32), ("merge2", 784, 196, 128),
          ("merge3", 196, 49, 256)]
CS, NNC, IC, R, B = 8, 6, 4, 55, 128
DROP_RATE, DROP_SEED = 0.1, 1234567  # BERT's attention_probs_dropout_prob


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median time of one call of ``fn``, by CUDA events around each call:
    a call as the model makes it, the host's time to launch it included
    when the device waits for the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def device_ms(fn, iters: int = 20, rounds: int = 5) -> float:
    """Device time of one call of ``fn`` with the launch queue kept full:
    per round the host enqueues ``iters`` calls behind a sleeping kernel,
    so the events time the kernels back to back and not the host's time
    to launch them. Median of the rounds' means."""
    import torch

    fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~25 ms: longer than the enqueueing
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    return statistics.median(means)


def clustered_stage(gen, b, n, hw, dev, cs=CS, nnc=NNC):
    """Positions of a later stage (distinct cells of an hw x hw canvas),
    clustered and kNN'd by the port: (pos (b,n,2), ncc (b,n,nnc) int32)."""
    import torch

    from ml_autofocusformermod_torch.ops.knn import knn
    from ml_autofocusformermod_torch.ops.sfc import space_filling_cluster

    cells = torch.stack([torch.randperm(hw * hw, generator=gen)[:n]
                         for _ in range(b)])
    pos = torch.stack([cells % hw, cells // hw], -1).float().to(dev)
    pos, mean, _, _, _ = space_filling_cluster(pos, cs, hw, hw)
    return pos.contiguous(), knn(pos, mean, nnc).contiguous()


def stage_geometry(gen, b, n, dev):
    """An AFF-Mini stage's positions and nearest clusters: stage 1 on the
    grid (host constants, batch-broadcast), later stages clustered."""
    from ml_autofocusformermod_torch.ops.sfc import grid_tensors

    if n == 3136:
        g_pos, _, g_ncc = grid_tensors(56, 56, CS, NNC, dev)
        return g_pos[None].expand(b, n, 2), g_ncc[None].expand(b, n, NNC)
    return clustered_stage(gen, b, n, 56, dev)


def attention_inputs(gen, b, n, h, c, dev, dtype, geometry=None):
    """The attention kernels' inputs at one stage, by name; ``geometry``:
    its ``(pos, ncc)`` (default: an AFF-Mini stage's, ``stage_geometry``)."""
    import torch

    pos, ncc = geometry or stage_geometry(gen, b, n, dev)
    c_ = c // h

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    return dict(
        q=rnd(b, n, c, scale=c_**-0.5).to(dtype),
        kv=rnd(b, n, 2 * c).to(dtype), ncc=ncc, pos=pos,
        pe_kernel=rnd(5, h, scale=0.1), pe_bias=rnd(h, scale=0.1),
        blank_k=rnd(c_, h, scale=0.5), blank_v=rnd(h, c_, scale=0.5),
    )


def merge_inputs(gen, b, n, n_, c, dev, dtype, cs=CS, nnc=NNC,
                 geometry="stage", hw=56):
    """(weights, feat, ncc) of one merge. "stage": the centres' rows of an
    AFF-Mini stage's nearest clusters (stage 1 on the grid); "clustered":
    the same on an hw x hw canvas with cluster size cs; "random": each
    row's nnc distinct clusters drawn with odds falling as (id + 1)^-2,
    so some clusters are named by many centres and some by none;
    "repeats": drawn with replacement, so rows name clusters twice."""
    import torch

    k = -(-n // cs)
    if geometry in ("stage", "clustered"):
        if geometry == "stage":
            _, ncc = stage_geometry(gen, b, n, dev)
        else:
            _, ncc = clustered_stage(gen, b, n, hw, dev, cs, nnc)
        centres = torch.stack([torch.randperm(n, generator=gen)[:n_]
                               for _ in range(b)]).to(dev)
        sel = torch.gather(ncc, 1, centres[..., None].expand(b, n_, nnc))
    elif geometry == "random":
        odds = torch.arange(1, k + 1, dtype=torch.float64) ** -2
        sel = torch.multinomial(odds.expand(b * n_, k), nnc,
                                generator=gen).reshape(b, n_, nnc)
    else:
        sel = torch.randint(0, k, (b, n_, nnc), generator=gen)
    sel = sel.to(dev, torch.int32).contiguous()
    w = torch.randn(b, n_, nnc * cs, IC, generator=gen).to(dev, dtype)
    feat = torch.randn(b, n, c, generator=gen).to(dev, dtype)
    return w, feat, sel


ATTN_ARGS = ["q", "kv", "ncc", "pos", "pe_kernel", "pe_bias", "blank_k",
             "blank_v"]


# the upsampling ratios of the curriculum's first epoch, per MaskFiner
# preset: every token splits
RATIO_ONE = {"maskfiner_up_down_mini.yaml": [0.0, 1.0, 1.0, 1.0, 0.0, 0.0, 0.0],
             "maskfiner_oracle_teacher.yaml": [0.0, 1.0, 1.0, 1.0]}
# the benchmark's training models: (label, preset, batch, upsampling ratios)
LN_MODELS = [("aff_mini", "aff_mini.yaml", 128, None),
             ("ud_mini", "maskfiner_up_down_mini.yaml", 128,
              [0.0, 0.9, 0.9, 0.9, 0.0, 0.0, 0.0]),
             ("aff_base384", "aff_base_22kto1k_384.yaml", 16, None)]
HBM_BYTES_S = 3.35e12  # H100 SXM


def captured_attention(preset, b, dtype_name, dev, seed=0, train=False,
                       ratios=None):
    """The attention kernel's inputs in a forward of the model of
    ``preset`` (a file of ``configs/``) built from ``seed`` on ``b``
    synthetic validation images: per distinct token count n, in the order
    of first call, a dict with ``label`` (``n<n>``), ``n``, ``heads``,
    ``c``, ``cs``, ``rel_width``, ``clamp``, ``per_pass`` (the calls at
    this n in one forward), ``args`` (the eight inputs by name, as the
    kernel gets them) and ``meta`` (the stage's tile metadata).

    ``train``: a training step's forward and backward instead (the
    trainer's generators, the smoothed-label loss), and each row also has
    ``g``, the output gradient the first call at that n got in the
    backward. ``ratios`` overrides the configured upsampling ratios (e.g.
    ``RATIO_ONE[preset]``, the curriculum's first epoch)."""
    import numpy as np
    import torch

    from ml_autofocusformermod_torch.config import load_config
    from ml_autofocusformermod_torch.models import layers
    from ml_autofocusformermod_torch.models.build import build_model
    from ml_autofocusformermod_torch.train.losses import (
        smooth_one_hot, soft_target_cross_entropy)
    from ml_autofocusformermod_torch.train.trainer import create_train_state

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(here, "configs", preset), opts=[
        "TPU.COMPUTE_DTYPE", dtype_name, "DATA.DATA_PATH", "no_dataset"])
    model = build_model(cfg, dev, seed=seed, upscale_ratios=ratios)
    # the first b synthetic validation images (data/imagenet.py::
    # SyntheticDataset), made here so that an older checkout's data
    # module is not needed
    size = cfg.DATA.IMG_SIZE
    images = torch.from_numpy(np.stack([
        np.random.default_rng(i).standard_normal((size, size, 3)).astype(
            np.float32) for i in range(b)]).transpose(0, 3, 1, 2).copy())
    labels = torch.arange(b) % cfg.MODEL.NUM_CLASSES
    seen = {}
    real = layers.fused_cluster_attention

    def capture(*args, meta=None, **kw):
        q, h, cs, rel_width, clamp = args[0], *args[8:12]
        n = q.shape[1]
        first = n not in seen
        if first:
            inputs = dict(zip(ATTN_ARGS, (t.detach().clone()
                                          for t in args[:8])))
            seen[n] = dict(label=f"n{n}", n=n, heads=h, c=q.shape[2],
                           cs=cs, rel_width=rel_width, clamp=clamp,
                           per_pass=0, args=inputs, meta=meta)
        seen[n]["per_pass"] += 1
        out = real(*args, meta=meta, **kw)
        if first and train:
            row = seen[n]
            out.register_hook(
                lambda g: row.__setitem__("g", g.detach().clone()))
        return out

    layers.fused_cluster_attention = capture
    try:
        if train:
            create_train_state(cfg, model, 1, seed=seed)
            model.train()
            target = smooth_one_hot(labels.to(dev), cfg.MODEL.NUM_CLASSES,
                                    cfg.MODEL.LABEL_SMOOTHING)
            outputs = model(images.to(dev))
            if not isinstance(outputs, (list, tuple)):
                outputs = [outputs]
            # the trainer's loss (trainer.py::model_loss), written out so
            # that the timer also runs on checkouts without it
            loss = sum(soft_target_cross_entropy(o, target)
                       for o in outputs) / len(outputs)
            loss.backward()
        else:
            with torch.no_grad():
                model(images.to(dev))
    finally:
        layers.fused_cluster_attention = real
    return list(seen.values())


def attention_calls(args, geo, meta, g=None):
    """Calls of the attention kernels on ``args`` (the eight inputs), as
    the model makes them, by mode name (see the module docstring); with
    ``g`` (the output gradient) the training modes and the backwards too.
    The saved statistics the backwards take are made here once."""
    from ml_autofocusformermod_torch.ops import cluster_attention as ca

    calls = {"fwd": lambda: ca.fused_cluster_attention(*args, *geo,
                                                       meta=meta)}
    if g is None:
        return calls
    if not hasattr(ca, "cluster_attention_forward"):  # before the modes
        calls["bwd"] = lambda: ca.cluster_attention_backward(
            *args, g, *geo, meta=meta)
        return calls
    fwd, bwd = ca.cluster_attention_forward, ca.cluster_attention_backward
    drop = (DROP_RATE, DROP_SEED)
    saved = fwd(*args, *geo, meta=meta, want_stats=True)
    dsaved = fwd(*args, *geo, meta=meta, drop=drop, want_stats=True)
    calls.update(
        fwd_stats=lambda: fwd(*args, *geo, meta=meta, want_stats=True),
        fwd_drop=lambda: fwd(*args, *geo, meta=meta, drop=drop,
                             want_stats=True),
        bwd_saved=lambda: bwd(*args, g, *geo, meta=meta, saved=saved),
        bwd_recompute=lambda: bwd(*args, g, *geo, meta=meta),
        bwd_drop=lambda: bwd(*args, g, *geo, meta=meta, saved=dsaved,
                             drop=drop))
    calls["bwd"] = (calls["bwd_saved"] if ca.saved_mode()
                    else calls["bwd_recompute"])
    return calls


def time_calls(out, label, calls):
    for d, fn in calls.items():
        out[f"{label}_{d}_ms"] = time_ms(fn)
        out[f"{label}_{d}_device_ms"] = device_ms(fn)


def time_maskfiner(out, preset, dev, dtype, train=False):
    dtype_name = str(dtype).split(".")[1]
    # a training step's inputs at the curriculum's first ratios and at the
    # final ones, or an eval forward's
    runs = ([RATIO_ONE[preset], None] if train else [None])
    for ratios in runs:
        for row in captured_attention(preset, B, dtype_name, dev,
                                      train=train, ratios=ratios):
            args = [row["args"][k] for k in ATTN_ARGS]
            geo = (row["heads"], row["cs"], row["rel_width"], row["clamp"])
            time_calls(out, row["label"], attention_calls(
                args, geo, row["meta"], row["g"] if train else None))


def time_attention(out, gen, dev, dtype):
    import torch

    from ml_autofocusformermod_torch.ops.cluster_attention import (
        tile_metadata)

    for label, n, h, c, _ in ATTN_STAGES:
        a = attention_inputs(gen, B, n, h, c, dev, dtype)
        args = [a[k] for k in ATTN_ARGS]
        g = torch.randn(B, n, c, generator=gen).to(dev, dtype)
        time_calls(out, label, attention_calls(
            args, (h, CS, R, 0), tile_metadata(a["ncc"]), g))


def time_merge(out, gen, dev, dtype):
    import torch

    from ml_autofocusformermod_torch.ops import cluster_merge as cm

    for label, n, n_, c in MERGES:
        w, f, ncc = merge_inputs(gen, B, n, n_, c, dev, dtype)
        g = torch.randn(B, n_, IC, c, generator=gen).to(dev, dtype)
        fns = {"fwd": lambda: cm.fused_cluster_merge(w, f, ncc, CS),
               "bwd": lambda: cm.cluster_merge_backward(w, f, ncc, CS, g)}
        if hasattr(cm, "merge_inverse_index"):
            fns["index"] = lambda: cm.merge_inverse_index(ncc, n, CS)
        for d, fn in fns.items():
            out[f"{label}_{d}_ms"] = time_ms(fn)
            out[f"{label}_{d}_device_ms"] = device_ms(fn)


def layer_norm_shapes(preset, ratios, dev, dtype_name="bfloat16"):
    """``{(c, rows per image, contiguous): calls}`` of the
    ``LayerNormFp32`` inputs in one training-mode forward of the model of
    ``preset`` on one synthetic image."""
    import collections

    import torch

    from ml_autofocusformermod_torch.config import load_config
    from ml_autofocusformermod_torch.models.build import build_model
    from ml_autofocusformermod_torch.models.layers import LayerNormFp32

    here = os.path.dirname(os.path.abspath(__file__))
    cfg = load_config(os.path.join(here, "configs", preset), opts=[
        "TPU.COMPUTE_DTYPE", dtype_name, "DATA.DATA_PATH", "no_dataset"])
    model = build_model(cfg, dev, seed=0, upscale_ratios=ratios).train()
    seen = collections.Counter()

    def hook(_, inputs):
        x = inputs[0]
        seen[(x.shape[-1], x.numel() // x.shape[-1],
              x.is_contiguous())] += 1

    for m in model.modules():
        if isinstance(m, LayerNormFp32):
            m.register_forward_pre_hook(hook)
    size = cfg.DATA.IMG_SIZE
    with torch.no_grad():
        model(torch.randn(1, 3, size, size, device=dev))
    return dict(seen)


def layer_norm_calls(c, rows, contiguous, dev, dtype, gen):
    """The timed calls of one LayerNorm input shape (see the module's
    note) and its bytes bound in ms: ``(calls, bound)``."""
    import torch

    from ml_autofocusformermod_torch.models.layers import LayerNormFp32

    if contiguous:
        x = torch.randn(rows, c, generator=gen).to(dev, dtype)
    else:  # PatchEmbed: (b, c, h*w) convolution output, transposed
        x = torch.randn(1, c, rows, generator=gen).to(dev, dtype)
        x = x.transpose(1, 2)
    g = torch.randn(x.shape, generator=gen).to(dev, dtype)
    norm = LayerNormFp32(c).to(dev)
    with torch.no_grad():
        norm.weight.copy_(torch.randn(c, generator=gen))
        norm.bias.copy_(torch.randn(c, generator=gen))
    w, b = norm.weight.detach(), norm.bias.detach()
    xl = x.detach().clone().requires_grad_(True)
    leaves = (xl, norm.weight, norm.bias)

    def fwd_bwd(f):
        def run():
            # each gradient lands in an empty .grad, as dx reaches the layer
            # before in the model: no accumulating add over x's size
            for t in leaves:
                t.grad = None
            f(xl).backward(g)
        return run

    calls = {}
    try:
        from ml_autofocusformermod_torch.ops import layer_norm as ln
    except ImportError:
        ln = None
    if ln is not None:
        # the backward gets contiguous rows, as autograd saved them
        xc, gc = x.contiguous(), g.contiguous()
        _, mean, rstd = torch.ops.mlaff.layer_norm_fwd(xc, w, b, norm.eps)

        def fwd():
            with torch.no_grad():
                ln.layer_norm(x, w, b, norm.eps)

        calls["fwd"] = fwd
        calls["bwd"] = lambda: ln.layer_norm_backward(xc, w, mean, rstd, gc)
        calls["fwd_bwd"] = fwd_bwd(norm)

    plain = getattr(norm, "expression", norm.forward)

    def plain_fwd():
        with torch.no_grad():
            plain(x)

    calls["plain_fwd"] = plain_fwd
    calls["plain_fwd_bwd"] = fwd_bwd(plain)
    plain_graph = plain(xl)

    def plain_bwd():
        for t in leaves:
            t.grad = None
        plain_graph.backward(g, retain_graph=True)

    calls["plain_bwd"] = plain_bwd
    el = rows * c * x.element_size()
    moved = {"fwd": 2 * el + 8 * rows + 8 * c,
             "bwd": 3 * el + 8 * rows + 12 * c}
    return calls, {k: 1e3 * v / HBM_BYTES_S for k, v in moved.items()}


def layer_norm_case(rows, c, dtype, dev, seed):
    """``(x, w, b, g)`` for :func:`layer_norm_gaps`: rows of x drawn from
    N(0, 1), every fourth row from N(3, 0.05^2) (E[x^2] about 3600 times
    its variance), the first two rows constant 1.25 (variance 0)."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, c, generator=gen)
    x[::4] = 3 + 0.05 * x[::4]
    x[:2] = 1.25
    w = torch.randn(c, generator=gen)
    b = torch.randn(c, generator=gen)
    g = torch.randn(rows, c, generator=gen)
    return (x.to(dev, dtype), w.to(dev), b.to(dev), g.to(dev, dtype))


def layer_norm_gaps(x, w, b, g, eps=1e-5):
    """``ops/layer_norm.py``'s wrappers on x's device, the forward through
    autograd and its backward (``layer_norm`` and ``layer_norm_backward``,
    one call each), against autograd of the plain expression
    (``layer_norm_reference``) on the same device, and the statistics
    against the expression in float64. x: rows by C, float32 or bfloat16.
    Returns each gap over its tolerance (passing at most 1), with
    ``max_abs_err`` (of y), ``dx_max_abs_err`` and the rows' largest
    condition number ``kappa_max``.

    Tolerances, and why: both sides sum in f32, in other orders, and the
    kernel fuses ``* w + b`` into one rounding, so the statistics, an f32 y
    and dx differ by a few f32 roundings (2^-24 = 6e-8, sums of up to 8192
    terms) of the sums' largest terms: 1e-5 of them. ``E[x^2] - E[x]^2``
    then loses accuracy as E[x^2] exceeds the variance: the rounding of
    E[x^2] moves var by its own size, so rstd by that over ``var + eps``.
    Every tolerance but db's is scaled per row by the condition number
    ``kappa = max(1, E[x^2] / (var + eps))`` (float64). The witness: the
    plain f32 expression sits within the same tolerance of the float64
    expression as the kernel does (``plain_vs_f64``). A bf16 y or dx may
    also round to the neighbouring bf16 value: one bf16 step (at most
    2^-7 of |value|) more. dw and db sum over the rows in another order:
    1e-5 of the column's sum of |terms| (times kappa for dw)."""
    import torch

    from ml_autofocusformermod_torch.ops.layer_norm import (
        layer_norm, layer_norm_reference,
    )

    bf = 2.0 ** -7 if x.dtype == torch.bfloat16 else 0.0
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    y = layer_norm(*leaves, eps)
    y.backward(g)
    got = {"y": y.detach(), "dx": leaves[0].grad, "dw": leaves[1].grad,
           "db": leaves[2].grad}
    _, got["mean"], got["rstd"] = torch.ops.mlaff.layer_norm_fwd(x, w, b,
                                                                 eps)
    plain = [t.clone().requires_grad_(True) for t in (x, w, b)]
    want_y, want_mean, want_rstd = layer_norm_reference(*plain, eps)
    want_y.backward(g)
    want = {"y": want_y.detach(), "mean": want_mean.detach(),
            "rstd": want_rstd.detach(), "dx": plain[0].grad,
            "dw": plain[1].grad, "db": plain[2].grad}
    x64 = x.double()
    y64, mean64, rstd64 = layer_norm_reference(x64, w.double(), b.double(),
                                               eps)
    ex2 = (x64 * x64).mean(-1)
    kappa = (ex2 / ((ex2 - mean64 * mean64).clamp_min(0) + eps)).clamp_min(1)
    k = kappa[:, None]
    xhat = (x64 - mean64[:, None]) * rstd64.abs()[:, None]
    dxhat = (g.double() * w.double()).abs().amax(-1, keepdim=True)
    row_max = x64.abs().amax(-1)

    def gap(a, ref, tol):
        """The largest |a - ref| over ``tol`` (an equal entry counts 0)."""
        d = (a.double() - ref.double()).abs()
        return torch.where(d == 0, 0.0, d / tol).max().item()

    def y_tol(ref):
        ref = ref.double()
        return 1e-5 * k * ref.abs().amax(-1, keepdim=True) + bf * ref.abs()

    out = {
        "mean": gap(got["mean"], want["mean"], 1e-5 * row_max),
        "rstd": gap(got["rstd"], want["rstd"],
                    1e-5 * kappa * want["rstd"].double().abs()),
        "y": gap(got["y"], want["y"], y_tol(want["y"])),
        # dx = r (dxhat - mean(dxhat) - xhat mean(dxhat xhat)): its terms
        "dx": gap(got["dx"], want["dx"],
                  1e-5 * k * rstd64.abs()[:, None] * dxhat
                  * (1 + xhat.abs().amax(-1, keepdim=True) ** 2)
                  + bf * want["dx"].double().abs()),
        "dw": gap(got["dw"], want["dw"],
                  1e-5 * (k * (g.double() * xhat).abs()).sum(0)),
        "db": gap(got["db"], want["db"], 1e-5 * g.double().abs().sum(0)),
    }
    for side, (mean, rstd, yy) in (
            ("kernel", (got["mean"], got["rstd"], got["y"])),
            ("plain", (want["mean"], want["rstd"], want["y"]))):
        out[f"{side}_vs_f64"] = max(
            gap(mean, mean64, 1e-5 * row_max),
            gap(rstd, rstd64, 1e-5 * kappa * rstd64.abs()),
            gap(yy, y64, y_tol(y64)))
    for k, name in (("y", "max_abs_err"), ("dx", "dx_max_abs_err")):
        out[name] = (got[k].double() - want[k].double()).abs().max().item()
    out["kappa_max"] = kappa.max().item()
    return out


def time_layer_norm(out, gen, dev, dtype):
    for label, preset, batch, ratios in LN_MODELS:
        shapes = layer_norm_shapes(preset, ratios, dev,
                                   str(dtype).split(".")[1])
        total = {}
        rows_out = []
        for (c, per_image, contiguous), n in sorted(shapes.items()):
            calls, bound = layer_norm_calls(c, per_image * batch, contiguous,
                                            dev, dtype, gen)
            row = {"c": c, "rows": per_image * batch,
                   "contiguous": contiguous, "calls": n}
            for d, fn in calls.items():
                row[f"{d}_ms"] = time_ms(fn)
                # a backward takes ~1-2 ms of host: 5 calls stay inside
                # device_ms's 25 ms of sleep, so the device waits on none
                row[f"{d}_device_ms"] = device_ms(
                    fn, iters=5 if d.endswith("fwd_bwd") else 20)
            for d, ms in bound.items():
                row[f"{d}_bound_ms"] = ms
            for k, v in row.items():
                if k.endswith("_ms"):
                    total[k] = total.get(k, 0.0) + n * v
            rows_out.append(row)
        out[label] = {"batch": batch, "calls": sum(shapes.values()),
                      "step": total, "shapes": rows_out}


def main() -> int:
    sys.path.insert(0, os.getcwd())  # the checkout to time, when run as a file
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label", nargs="?", default=".")
    ap.add_argument("--merge", action="store_true",
                    help="time the merge kernels, not the attention's")
    ap.add_argument("--layer-norm", action="store_true",
                    help="time the LayerNorm kernels at the benchmark "
                         "models' shapes")
    ap.add_argument("--cfg", default=None,
                    help="a MaskFiner preset of configs/: time the "
                         "attention at that model's shapes")
    ap.add_argument("--train", action="store_true",
                    help="with --cfg: the inputs of a training step at the "
                         "curriculum's first and final ratios, forward and "
                         "backward")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    args = ap.parse_args()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    out = {"label": args.label, "dtype": args.dtype, "b": B}
    dtype = getattr(torch, args.dtype)
    if args.layer_norm:
        time_layer_norm(out, gen, dev, dtype)
    elif args.cfg:
        out["cfg"] = args.cfg
        out["train"] = args.train
        time_maskfiner(out, os.path.basename(args.cfg), dev, dtype,
                       args.train)
    else:
        timer = time_merge if args.merge else time_attention
        timer(out, gen, dev, dtype)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
