"""Times of the hand-written kernels at the AFF-Mini 224 b128 shapes, and
the timers and inputs that ``chip_smoke.py`` uses for its kernel_time
lines.

    python3 -m ml_autofocusformermod_torch.time_kernels [--merge]
        [--cfg PRESET [--train]] [--dtype bfloat16|float32] [LABEL]

times this checkout: the attention kernels at stages 1-3 (each with its
stage's tile metadata made beforehand, as the model calls them), or with
``--merge`` the merge kernels at merges 1-3 (the backward makes its
inverse index inside, as the model calls it), or with ``--cfg`` and a
MaskFiner preset (``maskfiner_up_down_mini.yaml``, ...) the attention
forward at each token count of that model's forward, on the inputs a
forward of the model (random weights, synthetic images) gave the kernel
(with ``--train`` the attention forward and backward at each token count
of a training step, at the curriculum's first ratios, all 1.0, and at the
final ones). Run as a file from the root
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


def attention_inputs(gen, b, n, h, c, dev, dtype):
    """The attention kernels' inputs at one stage, by name."""
    import torch

    pos, ncc = stage_geometry(gen, b, n, dev)
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


def main() -> int:
    sys.path.insert(0, os.getcwd())  # the checkout to time, when run as a file
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("label", nargs="?", default=".")
    ap.add_argument("--merge", action="store_true",
                    help="time the merge kernels, not the attention's")
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
    if args.cfg:
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
