"""Smoke test of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Phases, one JSON line each:

1. device: the card (``nvidia-smi`` name and power limit), torch, CUDA and
   nvcc versions; data_env: what the host offers the data feed (Pillow's
   version, ``g++ --version``, whether ``jpeglib.h`` is found, the native
   decoder's build outcome with the compiler's stderr, ``os.cpu_count()``);
2. build: every CUDA kernel of ``ml_autofocusformermod_torch/csrc``, built
   from source with nvcc (one process per source, all at once);
3. kernel_check: the attention forward kernel against its plain PyTorch
   version at the AFF-Mini 224 stage shapes (stages 1-3), b = 8, fp32 (max
   abs <= 1e-4 * max|ref|) and bf16 (plain version in f32 on the same bf16
   inputs, max abs <= 2e-2 * max|ref|); then, at b = 128 bf16, the shapes
   of the throughput run, the same bf16 check and the kernel's time
   (``ms``: the median of 20 single calls made as the model makes them,
   CUDA events around each, so the host's launch time counts where the
   device waits for it; ``device_ms``: calls queued back to back behind a
   sleeping kernel, median of 5 rounds of 20) and the plain version's,
   beside the least time the card could take and the recorded time of
   the kernel it replaced (``prev_ms``, as recorded in PERF.md, not
   measured here); the
   attention kernel is timed as the model calls it, with the stage's tile
   metadata made beforehand, and the metadata's own time is
   ``tile_metadata_ms``; then the attention stress shapes (``STRESS``:
   n = 1921 with clamp_width 9, cs = 1 with nnc = 48, random ncc whose
   tile unions span several shared-memory chunks, AFF-Base-384's cs = 24
   with nnc = 6, heads of c_ = 556 and 1440, m = 760 with repeated
   clusters), b = 2, fp32 and bf16; at every one of these shapes also
   the forward's two training modes (``..._stats_out``, ``_stats_max``,
   ``_stats_denom``: the output and the saved softmax max and denominator;
   ``..._dropout``: attention dropout 0.1, ``DROP``, where c_ % 8 == 0,
   as the JAX package's dropout needs) against the plain version, with
   the same limits (in fp32 one mask bit that disagrees
   moves an output by about 0.1 |v|, far past 1e-4 of max|ref|), and at
   b = 128 their times (kernel_time ``cluster_attention_fwd_stats`` and
   ``_dropout``);
4. kernel_check, backward: the same for the attention backward kernel
   against its plain backward, every output (dq, dkv, d_pe_kernel,
   d_pe_bias, d_blank_k, d_blank_v), the stress shapes with the plain
   backward in f64; at every shape also the saved-stats backward (the
   forward kernel's own output and statistics; ``..._saved_<output>``)
   against the plain backward in f64, and the saved backward under
   dropout against the same with the dropout (``..._saved_dropout_...``),
   and both against the exact gradient, the plain backward recomputing in
   f64 (``..._exact_<output>``), each limit widened by the error of an
   independent f64 emulation of the delta trick on the output rounded to
   the inputs' dtype (``delta_trick_err``);
   the b = 128 times of the saved backward (the mode training runs;
   ``recompute_ms`` beside, the mode ``MLAFF_BWD_SAVED=0`` selects) and
   of the dropout backward;
   then both merge kernels, forward and backward (dw, dfeat), against
   their plain versions with the same limits, and the backward's
   inverse-index kernel against its plain version (the same lists): the
   three AFF-Mini merges at b = 8 (fp32, bf16) and b = 128 (bf16, with
   times, bound and ``prev_ms``; the backward timed as the model calls
   it, its inverse index made inside, and the index's own time also
   ``merge_index_ms``), the merge stress shapes (``MERGE_STRESS``, fp32
   and bf16, the plain backward in f64; a ``merge_lists`` line each gives
   its list lengths), the index alone where clusters outnumber one range
   of the index kernel (``INDEX_STRESS``), and
   ``merge_bwd_deterministic``: two backwards of merge 1 at b = 128 bf16
   give the same bits;
   then the attention forward at the shapes of a real UD-Mini 224 forward
   (``maskfiner_ud_mini_n193/n625/n1921``: its q, kv, positions, nearest
   clusters and tile metadata captured from the model, clamp_width 1023),
   b = 128 bf16 with the same times and bound, and b = 2 fp32, each with
   its tile unions (``stress_unions``); then both attention kernels on
   the inputs and output gradients of a UD-Mini 224 training step
   (``maskfiner_ud_mini_train_r1_*``: the curriculum's first epoch, every
   token splits, n = 245 / 1029 / 4165; ``..._final_*``: n = 193 / 625 /
   1921), b = 128 bf16 with times and bound and b = 2 fp32, every backward
   output against the plain backward in f64 (in batch chunks), with the
   backward's dk/dv scratch bytes, in every mode as above; and
   ``attention_bwd_deterministic``: two attention backwards give the
   same bytes for every output, recomputing, from the saved statistics
   and from them under dropout, at AFF-Mini stages 1-3 (b = 128 bf16,
   b = 8 fp32) and at UD-Mini's n = 4165 (b = 128 bf16, b = 2 fp32);
5. model_check: AFF-Mini 224 built through ``build_model`` and the port's
   ``aff_mini.yaml`` from a fixed seed, fp32, b = 2: the GPU forward (CUDA
   kernels, TF32 off) against the CPU forward (plain versions) on the same
   weights, logits within 1e-3 and the same argmax; 10 attention and 3
   merge launches per forward, the attention's tile metadata made once
   per stage (``tile_metadata`` calls, the grid stage's cached) and no
   merge inverse index;
6. train_check: one ``make_train_step`` step of the same model, fp32,
   b = 2, on the GPU (kernels, TF32 off) against the same step on the CPU
   (plain versions) from the same weights: loss and grad_norm within 1e-4
   relative, every parameter gradient within 1e-3 * max|ref| of its tensor
   (max|ref| floored at 1e-5 of the gradient norm, for gradients that are
   zero in exact arithmetic),
   the BatchNorm running stats within 1e-5 * max|ref| (the two devices
   reduce in another order); 10 + 10 attention and 3 + 3 merge launches
   (forward + backward; every forward with statistics, every backward
   from them) and 3 merge inverse indexes (kernel launches) per step;
   maskfiner_model_check: OT and UD-Mini 224 at full width, the same
   way (fp32, b = 2, GPU against CPU on the same weights and upsampling
   masks): logits within 1e-3 and the same argmax, every level's nearest
   clusters equal on both devices, 25 (OT) and 16 (UD-Mini) attention
   launches per forward, no other kernel, one tile metadata per local
   level (3 and 5);
   maskfiner_train_check: one train step of UD-Mini and of OT (with
   ``MODEL.MR.DROP_RATE`` zeroed, ``overrides``: the devices' Dropout
   streams differ) at full width, fp32, b = 2, as the preset configures
   it and again with attention dropout 0.1 on every level (its seeds
   from the train state's CPU generator, the same on both devices), GPU
   against CPU from the same weights and upsampling masks, at the
   curriculum's first ratios and at the final ones: the same limits as
   train_check, and 16 + 16 (UD-Mini) or 25 + 25 (OT) attention launches
   per step, every one with statistics (and dropout in the dropout run),
   no other kernel;
7. eval / throughput: the entry point ``ml_autofocusformermod_torch.main``
   with ``--eval`` over a few synthetic batches, then ``--throughput`` at
   b = 128 in bf16 (50 warmup + 30 timed forwards);
8. train: the entry point training AFF-Mini 224 in bf16 at b = 128 for one
   synthetic epoch (4 steps), one checkpoint and one validation; training
   images/s beside the card's name and power limit;
9. the MaskFiner path: ``main --eval`` on UD-Mini 224 (b = 32, bf16),
   then ``--throughput`` at b = 128 bf16 of UD-Mini and of OT, images/s
   beside the card's name and power limit; the attention forward is the
   only kernel launched (16 and 25 per forward);
10. maskfiner_train: the entry point training UD-Mini 224 (the MaskFiner
   training path) and OT 224 in bf16 at b = 128, as the preset
   configures them and again with attention dropout 0.1 on every level,
   for two synthetic epochs of 4 steps (the curriculum: ratio 1.0, then
   halfway to the final ratios), a checkpoint and a validation each; per
   epoch
   (``maskfiner_train_epoch``) the ratios, images/s after the first step,
   step times and peak memory, beside the card's name and power limit.
   Before the entry-point phases, dropout_check: the port's Dropout on
   the card (keep share, exact 1 / (1 - p) scale, the same mask from a
   reseeded generator).
11. the real-data path, in a temporary directory: imagefolder_fabricate
   writes a JPEG ImageFolder with Pillow (10 classes, 520 train and 130
   validation images at ImageNet-like sizes, a grayscale JPEG and a PNG
   per class and split); data_check holds the native decoder against
   Pillow where the library builds, a ``Loader`` with the host's worker
   count against none (equal bytes), ``prefetch_to_device`` to the card
   against the loader's batches (equal bytes), and gives decode images/s
   per worker and the items per decoder; pth_check loads a
   reference-format ``.pth`` (a key dropped, a foreign key added) through
   ``MODEL.PRETRAINED`` on the card and on the CPU (fp32 b = 2 logits
   within 1e-3, the same argmax, 1 missing and 1 unexpected key) and a
   1000-class head raises; imagefolder_train runs ``main`` on the folder
   for AFF-Mini and UD-Mini (bf16, b = 128, one epoch of 4 steps from the
   ``.pth``, validation over 128 + 2 images), then ``--eval --resume`` of
   the epoch's checkpoint, which must give the same val loss (1e-5
   relative), with img/s beside the synthetic runs', the items per
   decoder, peak memory and launches. Without Pillow the script prints
   ``{"phase": "imagefolder_train", "ran": false, "missing": [...]}``
   and runs none of this.
12. stop_processes, also when a phase fails: the loaders' worker server
   and its resource tracker are stopped and waited for, and the script
   fails if a child process of its own is still running.

The launch counters are zeroed just before each run of the entry point
and read just after; each mode of the attention kernels has a counter of
its own. The ``kernels`` line gives each kernel's launches in the
AFF-Mini training run (the dropout modes': the UD-Mini training run
with attention dropout) and, under ``launches_by_path``, in the UD-Mini
throughput run and in each MaskFiner training run too (``..._train``: as
the preset configures it; ``..._train_attn_drop``: with attention
dropout) and in the two runs on the folder
(``..._imagefolder_train``), and for the attention kernels their
times at the UD-Mini shapes (``maskfiner_ud_mini``: the forward at eval;
``maskfiner_ud_mini_train_r1`` / ``_final``: forward and backward per
training step).

Then the ``kernels`` line, the card's name and power limit, and as the last
line ``{"ok": true, "device": {...}}``. Any failure raises: the exit code
is non-zero and no result line is printed. Without a GPU, or without the
rest of the repository beside it, the script fails.
"""

from __future__ import annotations

import itertools
import json
import math
import subprocess
import sys
import time

from ml_autofocusformermod_torch.config import load_config

# the AFF-Mini shapes, the timers and the input builders, shared with the
# A/B timing tool
from ml_autofocusformermod_torch.time_kernels import (
    ATTN_ARGS, ATTN_STAGES, CS, IC, MERGES, RATIO_ONE, attention_inputs,
    captured_attention, clustered_stage, device_ms, merge_inputs, time_ms,
)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # non-tensor f32; bf16 TC
V100_AFF_MINI_IMG_S = 1337.0  # reference AFF-Mini forward, one V100
CSRC = "ml_autofocusformermod_torch/csrc/"
TPU_CLUSTEN = "ml_autofocusformermod_tpu/ops/clusten_pallas.py:"
TPU_MERGE = "ml_autofocusformermod_tpu/ops/merge_pallas.py:"
# name: (source, the TPU kernel it replaces, others it also replaces);
# the attention kernels' modes (the forward with its saved statistics, or
# with dropout; the backward under dropout) have entries of their own, the
# backward's entry is its saved-stats mode, as training runs it (the
# recompute mode, cluster_attention_bwd.cu, runs only with
# MLAFF_BWD_SAVED=0: its times stand beside as recompute_ms)
KERNELS = {
    "cluster_attention_fwd": ("cluster_attention.cu", TPU_CLUSTEN + "740",
                              [TPU_CLUSTEN + "965"]),
    "cluster_attention_fwd_stats": ("cluster_attention.cu",
                                    TPU_CLUSTEN + "3011",
                                    [TPU_CLUSTEN + "754",
                                     TPU_CLUSTEN + "1077"]),
    "cluster_attention_fwd_dropout": ("cluster_attention.cu",
                                      TPU_CLUSTEN + "708",
                                      [TPU_CLUSTEN + "940",
                                       TPU_CLUSTEN + "3156"]),
    "cluster_attention_bwd": ("cluster_attention_bwd_saved.cu",
                              TPU_CLUSTEN + "1764",
                              [TPU_CLUSTEN + "1127", TPU_CLUSTEN + "1915",
                               TPU_CLUSTEN + "1222"]),
    "cluster_attention_bwd_dropout": ("cluster_attention_bwd_saved.cu",
                                      TPU_CLUSTEN + "2230",
                                      [TPU_CLUSTEN + "3181"]),
    "cluster_merge_fwd": ("cluster_merge.cu", TPU_MERGE + "199", []),
    "cluster_merge_bwd": ("cluster_merge_bwd.cu", TPU_MERGE + "304", []),
    # the merge backward's inverse index: part of that kernel's port (the
    # TPU kernel needs no index), a launch of its own before it
    "merge_inverse_index": ("cluster_merge_bwd.cu", TPU_MERGE + "304", []),
}

# the attention kernels these replaced (one warp per (query, head)) at
# these b128 bf16 shapes, ms per call as recorded by an earlier run of this
# script on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6), not
# measured in this run
PREV_MS = {
    ("cluster_attention_fwd", "stage1"): 1.847,
    ("cluster_attention_fwd", "stage2"): 1.051,
    ("cluster_attention_fwd", "stage3"): 0.530,
    ("cluster_attention_bwd", "stage1"): 4.544,
    ("cluster_attention_bwd", "stage2"): 3.267,
    ("cluster_attention_bwd", "stage3"): 1.636,
    # the merge kernels these replaced (one thread row per centre forward,
    # one warp per (centre, slot) with f32 atomics backward), as recorded
    # by the same script on the same card (PERF.md section 6)
    ("cluster_merge_fwd", "merge1"): 0.225,
    ("cluster_merge_fwd", "merge2"): 0.199,
    ("cluster_merge_fwd", "merge3"): 0.096,
    ("cluster_merge_bwd", "merge1"): 1.946,
    ("cluster_merge_bwd", "merge2"): 0.664,
    ("cluster_merge_bwd", "merge3"): 0.241,
}
# the MaskFiner presets the script runs: name -> (file of configs/,
# attention launches and tile metadata per forward: one metadata per local
# MixResBasicLayer)
MASKFINER = {
    "maskfiner_ud_mini": ("maskfiner_up_down_mini.yaml", 16, 5),
    "maskfiner_ot": ("maskfiner_oracle_teacher.yaml", 25, 3),
}
# attention stress shapes, b = 2: (name, n, heads, c, cs, nnc, geometry,
# rel_width, clamp_width). "clustered": positions on a 56 x 56 canvas,
# clustered and kNN'd by the port; "random": each row's nnc clusters drawn
# at random, so a tile's union holds most of the image's clusters;
# "repeats": drawn with replacement, so rows list clusters more than once.
# AFF-Base-384 has cs = 24 and nnc = 6; c_ = 556 and 1440 and m = 760 are
# the widest the one-warp-per-(query, head) kernels took.
STRESS = [("n1921_clamp9", 1921, 8, 256, 8, 6, "clustered", 4, 9),
          ("cs1_nnc48", 784, 4, 128, 1, 48, "clustered", 55, 0),
          ("random_ncc", 784, 4, 128, 8, 6, "random", 55, 0),
          ("aff_base384", 2304, 8, 256, 24, 6, "clustered", 95, 0),
          ("wide_c556", 196, 2, 1112, 8, 6, "clustered", 55, 0),
          ("wide_c1440", 196, 1, 1440, 8, 6, "clustered", 55, 0),
          ("m760_repeats", 990, 2, 32, 40, 19, "repeats", 55, 0)]
# merge stress shapes: (name, n, n', c, cs, nnc, geometry, b), geometry as
# in merge_inputs. m = 760 was refused by the forward before the kernels
# were redesigned; AFF-Base-384's first merge does not fit an image's f32
# features in shared memory; AFF-Base's third merge has c = 512 and a
# padded last cluster; merge1 at b = 1 is the single-image forward.
MERGE_STRESS = [
    ("merge_m760_repeats", 990, 247, 32, 40, 19, "repeats", 2),
    ("merge_random_ncc", 784, 196, 128, 8, 6, "random", 2),
    ("merge_aff_base384", 9216, 2304, 128, 24, 6, "clustered", 2),
    ("merge_base_c512", 196, 49, 512, 8, 6, "clustered", 2),
    ("merge_b1", 3136, 784, 32, 8, 6, "stage", 1),
]
# the inverse index alone, b = 2, clusters drawn with replacement: (name,
# n, n', cs, nnc); more clusters than the index kernel's 512-cluster range
INDEX_STRESS = [("index_k525", 4200, 1050, 8, 6),
                ("index_k17500", 140000, 50, 8, 6)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float, dtype_name: str):
    """(least time in ms, what bounds it) for moving ``nbytes`` once and
    doing ``flops`` at the card's peak for the dtype."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    """Bytes of each tensor's distinct storage (a batch-broadcast tensor
    counts once)."""
    total = 0
    for t in tensors:
        shape = [1 if st == 0 else s for s, st in zip(t.shape, t.stride())]
        n = 1
        for s in shape:
            n *= s
        total += n * t.element_size()
    return total


# ------------------------------------------------------------- inputs ----

def stress_inputs(torch, gen, shape, b, dev, dtype):
    """Attention inputs of one ``STRESS`` shape and its (h, cs, R,
    clamp_width)."""
    _, n, h, c, cs, nnc, geometry, R, clamp = shape
    a = attention_inputs(gen, b, n, h, c, dev, dtype)
    if geometry == "clustered":
        a["pos"], a["ncc"] = clustered_stage(gen, b, n, 56, dev, cs,
                                             nnc)
    elif geometry == "random":
        k = -(-n // cs)
        a["ncc"] = torch.argsort(torch.rand(b, n, k, generator=gen), -1)[
            ..., :nnc].to(dev, torch.int32).contiguous()
    else:
        k = -(-n // cs)
        a["ncc"] = torch.randint(0, k, (b, n, nnc), generator=gen).to(
            dev, torch.int32)
    return a, (h, cs, R, clamp)


def attn_work(torch, args, h, cs):
    """(bytes, flops) one attention call needs: inputs read once, output
    written once; flops over the slots that hold a token."""
    from ml_autofocusformermod_torch.ops.cluster_gather import (
        cluster_token_index,
    )

    q, ncc = args["q"], args["ncc"]
    b, n, c = q.shape
    c_ = c // h
    valid = (cluster_token_index(ncc, cs) < n).sum().item()  # over b, n, m
    moved = nbytes(*args.values()) + nbytes(q)  # + the output
    flops = valid * h * (4 * c_ + 12) + b * n * h * (2 * c_ + 2 * c_)
    return moved, flops


def attn_bwd_work(torch, args, g, h, cs):
    """(bytes, flops) of one attention backward: inputs (those of the
    forward and g) read once, dq, dkv and the parameter gradients written
    once; per slot that holds a token, q.k, g.v, dq, dk and dv (each 2 c_)
    plus the geometry and the softmax terms."""
    from ml_autofocusformermod_torch.ops.cluster_gather import (
        cluster_token_index,
    )

    q, kv, ncc = args["q"], args["kv"], args["ncc"]
    b, n, c = q.shape
    c_ = c // h
    valid = (cluster_token_index(ncc, cs) < n).sum().item()
    moved = (nbytes(*args.values(), g) + nbytes(q, kv)
             + nbytes(*(args[k] for k in ("pe_kernel", "pe_bias", "blank_k",
                                          "blank_v"))))
    flops = valid * h * (10 * c_ + 24) + b * n * h * 8 * c_
    return moved, flops


def merge_bwd_work(torch, w, feat, ncc, g, cs):
    """(bytes, flops) of one merge backward: w, feat, ncc, g read once, dw
    and dfeat written once; per gathered row 2 * ic * c flops for dw and
    for dfeat each."""
    from ml_autofocusformermod_torch.ops.cluster_gather import (
        cluster_token_index,
    )

    b, n_, _, ic = w.shape
    n, c = feat.shape[1], feat.shape[2]
    valid = (cluster_token_index(ncc, cs) < n).sum().item()
    return nbytes(w, feat, ncc, g) + nbytes(w, feat), valid * ic * c * 4


def merge_work(torch, w, feat, ncc, cs):
    from ml_autofocusformermod_torch.ops.cluster_gather import (
        cluster_token_index,
    )

    b, n_, _, ic = w.shape
    n, c = feat.shape[1], feat.shape[2]
    valid = (cluster_token_index(ncc, cs) < n).sum().item()
    out_bytes = b * n_ * ic * c * w.element_size()
    return nbytes(w, feat, ncc) + out_bytes, valid * ic * c * 2


# ------------------------------------------------------------- phases ----

def phase_device(torch):
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False: "
                         "this script needs an NVIDIA GPU")
    smi = smi_name_power()
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: the kernels target sm_90a, this card "
                         f"is sm_{cap[0]}{cap[1]}")
    from ml_autofocusformermod_torch.ops import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "capability": list(cap),
          "nvcc": nvcc.strip().splitlines()[-1],
          "python": sys.version.split()[0]})
    return smi


def phase_build():
    from ml_autofocusformermod_torch.ops import _build

    t0 = time.perf_counter()
    info = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source": {k: {"seconds": v["seconds"], "cached": v["cached"],
                             "ptxas": [ln.strip() for ln in v["log"].splitlines()
                                       if "registers" in ln or "spill" in ln]}
                         for k, v in info.items()}})


def prev(kernel, row):
    """The replaced kernel's recorded time for the row's shape."""
    return {"prev_ms": PREV_MS[(kernel, row["shape"])],
            "prev_ms_from": "recorded, not this run (PERF.md section 6)"}


def check(name, dtype_name, out, ref, delta_trick_err=None):
    """``out`` within 1e-4 (fp32) or 2e-2 (bf16) of max|ref| of ``ref``,
    plus ``delta_trick_err`` where given (see :func:`check_exact`)."""
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    tol = (1e-4 if dtype_name == "float32" else 2e-2) * scale
    extra = {}
    if delta_trick_err is not None:
        tol += delta_trick_err
        extra["delta_trick_err"] = delta_trick_err
    ok = err <= tol and bool(out.float().isfinite().all())
    emit({"phase": "kernel_check", "shape": name, "dtype": dtype_name,
          "max_abs_err": err, "max_abs_ref": scale, "tol": tol, **extra,
          "ok": ok})
    if not ok:
        raise AssertionError(f"{name} {dtype_name}: max abs err {err} > {tol}")
    return err


DROP = (0.1, 1234567)  # attention dropout of the checks: BERT's rate


def check_stats(name, dtype_name, h, got, ref):
    """The forward's statistics against the plain ones: the max (lanes
    [0, h)) and the denominator (lanes [h, 2h)) each within the limits."""
    return max(check(f"{name}_stats_max", dtype_name, got[..., :h],
                     ref[..., :h]),
               check(f"{name}_stats_denom", dtype_name, got[..., h:],
                     ref[..., h:]))


def check_modes_fwd(torch, name, dtype_name, args, geo, meta=None):
    """The forward with statistics (output and statistics) and with
    dropout against the plain versions (f32 inside) on the same inputs;
    dropout where c_ % 8 == 0 (as the JAX package's, it needs that).
    Returns the kernel's (out, stats) of both (None for no dropout), for
    the backwards, and the worst error."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        cluster_attention_forward, cluster_attention_reference,
    )

    plain = [t.float() if t.is_floating_point() else t for t in args]
    saved = cluster_attention_forward(*args, *geo, meta=meta,
                                      want_stats=True)
    ref = cluster_attention_reference(*plain, *geo, want_stats=True)
    torch.cuda.synchronize()
    err = max(check(f"{name}_stats_out", dtype_name, saved[0], ref[0]),
              check_stats(name, dtype_name, geo[0], saved[1], ref[1]))
    dsaved = None
    if (args[0].shape[2] // geo[0]) % 8 == 0:
        dsaved = cluster_attention_forward(*args, *geo, meta=meta, drop=DROP,
                                           want_stats=True)
        dref = cluster_attention_reference(*plain, *geo, drop=DROP)
        torch.cuda.synchronize()
        err = max(err, check(f"{name}_dropout", dtype_name, dsaved[0], dref))
    return saved, dsaved, err


def check_modes_bwd(torch, name, dtype_name, args, g, geo, saved, dsaved,
                    meta=None):
    """The saved-stats backward on the forward kernel's own output and
    statistics (``saved``), and under dropout (``dsaved``, the forward's
    with the dropout; None: no dropout check), against the plain saved
    backward in f64 on the same inputs (in batch chunks), every output
    (``..._saved_<output>``, ``..._saved_dropout_<output>``), and against
    the exact gradient (:func:`check_exact`). Returns the worst error."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        cluster_attention_backward,
    )

    outs = ["dq", "dkv", "d_pe_kernel", "d_pe_bias", "d_blank_k",
            "d_blank_v"]
    err = 0.0
    for mode, sv, drop in (("saved", saved, None),
                           ("saved_dropout", dsaved, DROP)):
        if sv is None:
            continue
        exact = plain_backward(torch, args, g, geo, torch.float64, saved=sv,
                               drop=drop)
        got = cluster_attention_backward(*args, g, *geo, meta=meta,
                                         saved=sv, drop=drop)
        torch.cuda.synchronize()
        err = max([err] + [check(f"{name}_{mode}_{o}", dtype_name, x, y)
                           for o, x, y in zip(outs, got, exact)])
        del exact
        err = max(err, check_exact(torch, f"{name}_{mode}", dtype_name, args,
                                   g, geo, got, drop))
    return err


def check_exact(torch, name, dtype_name, args, g, geo, got, drop):
    """The saved-stats backward's outputs ``got`` against the exact
    gradient, the plain backward recomputing in f64 (lines
    ``..._exact_<output>``). The saved mode takes S = rowsum(g * out) from
    the output as stored, in q's dtype, so its gradient carries that
    rounding beside the kernel's own: each limit is the usual one plus
    ``delta_trick_err``, the error against the same exact gradient of an
    independent emulation of the delta trick, the plain saved backward in
    f64 on the plain f64 forward's output rounded to q's dtype and its
    statistics rounded to f32. A stored output rounded worse than once
    shows past it. Returns the worst error."""
    outs = ["dq", "dkv", "d_pe_kernel", "d_pe_bias", "d_blank_k",
            "d_blank_v"]
    exact = plain_backward(torch, args, g, geo, torch.float64, drop=drop)
    out, stats = plain_forward(torch, args, geo, torch.float64, drop=drop)
    emulated = plain_backward(torch, args, g, geo, torch.float64,
                              saved=(out.to(args[0].dtype), stats.float()),
                              drop=drop)
    del out, stats
    return max(check(f"{name}_exact_{o}", dtype_name, x, y,
                     delta_trick_err=(e - y).abs().max().item())
               for o, x, e, y in zip(outs, got, emulated, exact))


def emit_union(torch, name, ncc):
    """The tile unions of a stress shape: clusters per 64-query tile."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        tile_metadata,
    )

    count = tile_metadata(ncc).ucount.float()
    emit({"phase": "stress_unions", "shape": name,
          "union_clusters_max": int(count.max().item()),
          "union_clusters_mean": count.mean().item()})


def timed_row(torch, base, fn, plain, work, err, **extra):
    """A kernel_time row: the call's times, the plain version's, the
    bound of ``work`` = (bytes, flops) at bf16, the worst check error."""
    bms, by = bound_ms(work[0], work[1], "bfloat16")
    return dict(base, ms=time_ms(fn), device_ms=device_ms(fn),
                plain_ms=time_ms(plain, iters=5, warmup=1), bound_ms=bms,
                bound_by=by, bytes=work[0], flops=work[1], max_abs_err=err,
                **extra)


def phase_kernels(torch):
    """The attention forward at the AFF-Mini stages and the stress shapes,
    in its three modes: inference, with the saved statistics, and with
    dropout (rows ``attention``, ``stats``, ``dropout``)."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        cluster_attention_forward, cluster_attention_reference,
        fused_cluster_attention, tile_metadata,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    names = ["q", "kv", "ncc", "pos", "pe_kernel", "pe_bias", "blank_k",
             "blank_v"]
    R = 224 // 4 - 1
    rows = {"attention": [], "stats": [], "dropout": []}
    for label, n, h, c, per_fwd in ATTN_STAGES:
        errs, errs_m = [], []
        for dtype in (torch.float32, torch.bfloat16):
            a = attention_inputs(gen, 8, n, h, c, dev, dtype)
            out = fused_cluster_attention(*(a[k] for k in names), h, CS, R)
            ref_args = dict(a, q=a["q"].float(), kv=a["kv"].float())
            ref = cluster_attention_reference(
                *(ref_args[k] for k in names), h, CS, R)
            torch.cuda.synchronize()
            errs.append(check(f"attention_{label}",
                              str(dtype).split(".")[1], out, ref))
            errs_m.append(check_modes_fwd(
                torch, f"attention_{label}", str(dtype).split(".")[1],
                [a[k] for k in names], (h, CS, R, 0))[2])
        a = attention_inputs(gen, 128, n, h, c, dev, torch.bfloat16)
        args = [a[k] for k in names]
        # as the model calls it: the stage's tile metadata made once
        meta = tile_metadata(a["ncc"])
        out = fused_cluster_attention(*args, h, CS, R, meta=meta)
        ref = cluster_attention_reference(*args, h, CS, R)  # f32 inside
        torch.cuda.synchronize()
        errs.append(check(f"attention_{label}_b128", "bfloat16", out, ref))
        errs_m.append(check_modes_fwd(torch, f"attention_{label}_b128",
                                      "bfloat16", args, (h, CS, R, 0),
                                      meta)[2])
        ms = time_ms(lambda: fused_cluster_attention(*args, h, CS, R,
                                                     meta=meta))
        dev_ms = device_ms(lambda: fused_cluster_attention(*args, h, CS, R,
                                                           meta=meta))
        meta_ms = time_ms(lambda: tile_metadata(a["ncc"]))
        plain = time_ms(lambda: cluster_attention_reference(*args, h, CS, R),
                        iters=5, warmup=1)
        moved, flops = attn_work(torch, a, h, CS)
        bms, by = bound_ms(moved, flops, "bfloat16")
        rows["attention"].append(dict(
            shape=label, b=128, n=n, heads=h, c=c, per_pass=per_fwd,
            ms=ms, device_ms=dev_ms, plain_ms=plain, bound_ms=bms,
            bound_by=by, bytes=moved, flops=flops, max_abs_err=max(errs)))
        emit({"phase": "kernel_time", "kernel": "cluster_attention_fwd",
              **rows["attention"][-1], "tile_metadata_ms": meta_ms,
              **prev("cluster_attention_fwd", rows["attention"][-1])})
        base = dict(shape=label, b=128, n=n, heads=h, c=c, per_pass=per_fwd)
        stats_bytes = 128 * n * 2 * h * 4  # written once more
        for kernel, mode, kw in (
                ("cluster_attention_fwd_stats", "stats",
                 dict(want_stats=True)),
                ("cluster_attention_fwd_dropout", "dropout",
                 dict(want_stats=True, drop=DROP))):
            rows[mode].append(timed_row(
                torch, base,
                lambda: cluster_attention_forward(*args, h, CS, R, meta=meta,
                                                  **kw),
                lambda: cluster_attention_reference(*args, h, CS, R, **kw),
                (moved + stats_bytes, flops), max(errs_m)))
            emit({"phase": "kernel_time", "kernel": kernel,
                  **rows[mode][-1]})
    for shape in STRESS:
        for dtype in (torch.float32, torch.bfloat16):
            a, (h, cs, R, clamp) = stress_inputs(torch, gen, shape, 2, dev,
                                                 dtype)
            out = fused_cluster_attention(*(a[k] for k in names), h, cs, R,
                                          clamp)
            ref_args = dict(a, q=a["q"].float(), kv=a["kv"].float())
            ref = cluster_attention_reference(
                *(ref_args[k] for k in names), h, cs, R, clamp)
            torch.cuda.synchronize()
            check(f"attention_stress_{shape[0]}", str(dtype).split(".")[1],
                  out, ref)
            check_modes_fwd(torch, f"attention_stress_{shape[0]}",
                            str(dtype).split(".")[1],
                            [a[k] for k in names], (h, cs, R, clamp))
        emit_union(torch, shape[0], a["ncc"])
    return rows


def phase_kernels_bwd(torch):
    """The attention backward at the AFF-Mini stages and the stress
    shapes: the recompute mode against the plain backward (f32, the
    stress shapes f64), the saved-stats mode and the saved mode under
    dropout against the plain backward in f64 (rows ``attention``: the
    saved mode, as training calls it, with the recompute mode's times
    beside; ``dropout``)."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        cluster_attention_backward, cluster_attention_backward_reference,
        cluster_attention_forward, tile_metadata,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(1)
    names = ["q", "kv", "ncc", "pos", "pe_kernel", "pe_bias", "blank_k",
             "blank_v"]
    outs = ["dq", "dkv", "d_pe_kernel", "d_pe_bias", "d_blank_k", "d_blank_v"]
    R = 224 // 4 - 1
    rows = {"attention": [], "dropout": []}

    def f32(t):
        return t.float() if t.is_floating_point() else t

    def f64(t):
        return t.double() if t.is_floating_point() else t

    for label, n, h, c, per_step in ATTN_STAGES:
        errs, errs_d = [], []
        for b, dtype in ((8, torch.float32), (8, torch.bfloat16),
                         (128, torch.bfloat16)):
            a = attention_inputs(gen, b, n, h, c, dev, dtype)
            g = torch.randn(b, n, c, generator=gen).to(dev, dtype)
            args = [a[k] for k in names]
            dt = str(dtype).split(".")[1]
            got = cluster_attention_backward(*args, g, h, CS, R)
            want = cluster_attention_backward_reference(
                *(f32(t) for t in args), g.float(), h, CS, R)
            torch.cuda.synchronize()
            tag = f"attention_bwd_{label}" + ("_b128" if b == 128 else "")
            for o, x, y in zip(outs, got, want):
                errs.append(check(f"{tag}_{o}", dt, x, y))
            del got, want
            saved, dsaved, _ = check_modes_fwd(torch, tag, dt, args,
                                               (h, CS, R, 0))
            err = check_modes_bwd(torch, tag, dt, args, g, (h, CS, R, 0),
                                  saved, dsaved)
            errs.append(err)
            errs_d.append(err)
        meta = tile_metadata(a["ncc"])  # once per stage, as in the model
        saved = cluster_attention_forward(*args, h, CS, R, meta=meta,
                                          want_stats=True)
        dsaved = cluster_attention_forward(*args, h, CS, R, meta=meta,
                                           drop=DROP, want_stats=True)
        moved, flops = attn_bwd_work(torch, a, g, h, CS)
        moved += nbytes(*saved)  # the saved mode reads out and the stats
        base = dict(shape=label, b=128, n=n, heads=h, c=c, per_pass=per_step)
        recompute = lambda: cluster_attention_backward(*args, g, h, CS, R,
                                                       meta=meta)
        rows["attention"].append(timed_row(
            torch, base,
            lambda: cluster_attention_backward(*args, g, h, CS, R, meta=meta,
                                               saved=saved),
            lambda: cluster_attention_backward_reference(
                *args, g, h, CS, R, saved=saved),
            (moved, flops), max(errs), mode="saved",
            recompute_ms=time_ms(recompute),
            recompute_device_ms=device_ms(recompute),
            recompute_plain_ms=time_ms(
                lambda: cluster_attention_backward_reference(
                    *args, g, h, CS, R), iters=5, warmup=1)))
        emit({"phase": "kernel_time", "kernel": "cluster_attention_bwd",
              **rows["attention"][-1],
              **prev("cluster_attention_bwd", rows["attention"][-1])})
        rows["dropout"].append(timed_row(
            torch, base,
            lambda: cluster_attention_backward(*args, g, h, CS, R, meta=meta,
                                               saved=dsaved, drop=DROP),
            lambda: cluster_attention_backward_reference(
                *args, g, h, CS, R, saved=dsaved, drop=DROP),
            (moved, flops), max(errs_d), mode="saved"))
        emit({"phase": "kernel_time", "kernel": "cluster_attention_bwd_dropout",
              **rows["dropout"][-1]})
    for shape in STRESS:
        for dtype in (torch.float32, torch.bfloat16):
            a, (h, cs, R, clamp) = stress_inputs(torch, gen, shape, 2, dev,
                                                 dtype)
            g = torch.randn(a["q"].shape, generator=gen).to(dev, dtype)
            args = [a[k] for k in names]
            dt = str(dtype).split(".")[1]
            got = cluster_attention_backward(*args, g, h, cs, R, clamp)
            # in f64: at c_ = 556 the f32 plain version's own rounding in
            # d_pe_bias (a sum of slot terms that cancel) nears the limit
            want = cluster_attention_backward_reference(
                *(f64(t) for t in args), g.double(), h, cs, R, clamp)
            torch.cuda.synchronize()
            for o, x, y in zip(outs, got, want):
                check(f"attention_bwd_stress_{shape[0]}_{o}", dt, x, y)
            geo = (h, cs, R, clamp)
            saved, dsaved, _ = check_modes_fwd(
                torch, f"attention_bwd_stress_{shape[0]}", dt, args, geo)
            check_modes_bwd(torch, f"attention_bwd_stress_{shape[0]}", dt,
                            args, g, geo, saved, dsaved)
    return rows


def phase_merge(torch):
    """The merge kernels, both directions, and the inverse-index kernel: the
    AFF-Mini shapes (b = 8 fp32 and bf16, b = 128 bf16 with times), the
    stress shapes (b = 2, fp32 and bf16, the backward's plain version in
    f64), and the backward's bitwise reproducibility at merge 1, b = 128
    bf16."""
    from ml_autofocusformermod_torch.ops.cluster_merge import (
        cluster_merge_backward, cluster_merge_backward_reference,
        cluster_merge_reference, fused_cluster_merge, merge_inverse_index,
        merge_inverse_index_reference,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(2)
    rows = {"cluster_merge_fwd": [], "cluster_merge_bwd": [],
            "merge_inverse_index": []}

    def name(dtype):
        return str(dtype).split(".")[1]

    def check_index(tag, ncc, n, cs):
        """The index kernel against its plain version: the same lists."""
        got = merge_inverse_index(ncc, n, cs)
        want = merge_inverse_index_reference(ncc, n, cs)
        torch.cuda.synchronize()
        err = max((x.long() - y.long()).abs().max().item()
                  for x, y in zip(got, want))
        ok = all(torch.equal(x, y) for x, y in zip(got, want))
        emit({"phase": "kernel_check", "shape": f"{tag}_index",
              "dtype": "int32", "max_abs_err": err, "equal": ok, "ok": ok})
        if not ok:
            raise AssertionError(f"{tag}: merge inverse index differs")
        return got, err

    def check_both(tag, b, n, n_, c, dtype, f64=False, **geo):
        """Forward, backward and inverse index of one merge against the
        plain versions; returns (inputs, g, the worst forward, backward and
        index errors, the index)."""
        cs = geo.get("cs", CS)
        w, f, ncc = merge_inputs(gen, b, n, n_, c, dev, dtype, **geo)
        g = torch.randn(b, n_, IC, c, generator=gen).to(dev, dtype)
        ref_t = torch.float64 if f64 else torch.float32
        out = fused_cluster_merge(w, f, ncc, cs)
        ref = cluster_merge_reference(w.float(), f.float(), ncc, cs)
        got = cluster_merge_backward(w, f, ncc, cs, g)
        want = cluster_merge_backward_reference(
            w.to(ref_t), f.to(ref_t), ncc, cs, g.to(ref_t))
        torch.cuda.synchronize()
        if out.dtype != dtype or any(x.dtype != dtype for x in got):
            raise AssertionError(f"{tag}: outputs not in {dtype}")
        e_f = check(tag, name(dtype), out, ref)
        e_b = max(check(f"{tag}_bwd_{o}", name(dtype), x, y)
                  for o, x, y in zip(("dw", "dfeat"), got, want))
        index, e_i = check_index(tag, ncc, n, cs)
        return (w, f, ncc, g), (e_f, e_b, e_i), index

    def timed(kernel, row, fn, plain, **extra):
        """``row`` with the kernel's per-call time (``ms``, as the model
        calls it), its device time with calls queued (``device_ms``) and
        the plain version's; emitted as a kernel_time line."""
        row.update(ms=time_ms(fn), device_ms=device_ms(fn),
                   plain_ms=time_ms(plain, iters=5, warmup=1))
        rows[kernel].append(row)
        emit({"phase": "kernel_time", "kernel": kernel, **row, **extra})
        return row

    for label, n, n_, c in MERGES:
        errs = []
        for b, dtype in ((8, torch.float32), (8, torch.bfloat16),
                         (128, torch.bfloat16)):
            tag = label + ("_b128" if b == 128 else "")
            (w, f, ncc, g), err, _ = check_both(tag, b, n, n_, c, dtype)
            errs.append(err)
        errs_f, errs_b, errs_i = zip(*errs)
        shape = dict(shape=label, b=128, n=n, n_out=n_, c=c, per_pass=1)
        moved, flops = merge_work(torch, w, f, ncc, CS)
        bms, by = bound_ms(moved, flops, "bfloat16")
        row = dict(shape, bound_ms=bms, bound_by=by, bytes=moved,
                   flops=flops, max_abs_err=max(errs_f))
        timed("cluster_merge_fwd", row,
              lambda: fused_cluster_merge(w, f, ncc, CS),
              lambda: cluster_merge_reference(w, f, ncc, CS),
              **prev("cluster_merge_fwd", row))
        # the inverse index alone: ncc read once, the lists written once
        k = -(-n // CS)
        moved = nbytes(ncc) * 2 + 128 * (k + 1) * 4
        bms, by = bound_ms(moved, 0, "float32")
        index_row = timed(
            "merge_inverse_index",
            dict(shape, bound_ms=bms, bound_by=by, bytes=moved, flops=0,
                 max_abs_err=max(errs_i)),
            lambda: merge_inverse_index(ncc, n, CS),
            lambda: merge_inverse_index_reference(ncc, n, CS))
        # as the model calls it: the backward makes its index inside
        moved, flops = merge_bwd_work(torch, w, f, ncc, g, CS)
        bms, by = bound_ms(moved, flops, "bfloat16")
        row = dict(shape, bound_ms=bms, bound_by=by, bytes=moved,
                   flops=flops, max_abs_err=max(errs_b))
        timed("cluster_merge_bwd", row,
              lambda: cluster_merge_backward(w, f, ncc, CS, g),
              lambda: cluster_merge_backward_reference(w, f, ncc, CS, g),
              merge_index_ms=index_row["ms"],
              **prev("cluster_merge_bwd", row))
        if label == "merge1":
            a = cluster_merge_backward(w, f, ncc, CS, g)
            z = cluster_merge_backward(w, f, ncc, CS, g)
            torch.cuda.synchronize()
            same = [torch.equal(x, y) for x, y in zip(a, z)]
            emit({"phase": "merge_bwd_deterministic", "shape": label,
                  "b": 128, "dtype": "bfloat16", "dw_equal": same[0],
                  "dfeat_equal": same[1], "ok": all(same)})
            if not all(same):
                raise AssertionError("merge backward not bitwise reproducible")
    for label, n, n_, c, cs, nnc, geometry, b in MERGE_STRESS:
        for dtype in (torch.float32, torch.bfloat16):
            geo = ({} if geometry == "stage" else
                   dict(cs=cs, nnc=nnc, geometry=geometry, hw=96 if n > 3136
                        else 56))
            _, _, index = check_both(label, b, n, n_, c, dtype, f64=True,
                                     **geo)
        counts = index.offset.diff(dim=1)
        emit({"phase": "merge_lists", "shape": label, "b": b, "n": n,
              "n_out": n_, "c": c, "cs": cs, "nnc": nnc,
              "clusters_named_by_none": int((counts == 0).sum().item()),
              "list_max": int(counts.max().item()),
              "list_mean": counts.float().mean().item()})
    for label, n, n_, cs, nnc in INDEX_STRESS:
        ncc = torch.randint(0, -(-n // cs), (2, n_, nnc), generator=gen).to(
            dev, torch.int32)
        check_index(label, ncc, n, cs)
    return rows


def port_config(preset, opts):
    return load_config(preset_path(preset), opts=opts)


def preset_path(preset):
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ml_autofocusformermod_torch", "configs", preset)


def phase_model(torch):
    import numpy as np

    from ml_autofocusformermod_torch.models.build import build_model
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        fused_cluster_attention, tile_metadata,
    )
    from ml_autofocusformermod_torch.ops.cluster_merge import (
        fused_cluster_merge, merge_inverse_index,
    )

    cfg = port_config("aff_mini.yaml", ["TPU.COMPUTE_DTYPE", "float32"])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 224, 224)).astype(np.float32))
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the patch-embed conv
    try:
        gpu = build_model(cfg, "cuda", seed=0)
        with torch.no_grad():
            fused_cluster_attention.launches = 0
            fused_cluster_merge.launches = 0
            tile_metadata.calls = 0
            merge_inverse_index.calls = 0
            out = gpu(x.cuda()).float().cpu()
            torch.cuda.synchronize()
            launches = (fused_cluster_attention.launches,
                        fused_cluster_merge.launches)
            meta_calls = tile_metadata.calls
            index_calls = merge_inverse_index.calls
            ref = build_model(cfg, "cpu", seed=0)(x).float()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    err = (out - ref).abs().max().item()
    same_argmax = bool((out.argmax(-1) == ref.argmax(-1)).all())
    # stages 2 and 3 make their metadata; stage 1's is the cached grid's
    ok = (err <= 1e-3 and same_argmax and launches == (10, 3)
          and meta_calls <= 3 and index_calls == 0
          and bool(out.isfinite().all()) and out.shape == (2, 1000))
    emit({"phase": "model_check", "model": "aff_mini_224", "dtype": "float32",
          "b": 2, "max_abs_err_vs_cpu": err, "same_argmax": same_argmax,
          "launches_per_forward": {"cluster_attention_fwd": launches[0],
                                   "cluster_merge_fwd": launches[1]},
          "tile_metadata_calls": meta_calls,
          "merge_inverse_index_calls": index_calls, "ok": ok})
    if not ok:
        raise AssertionError("AFF-Mini GPU forward disagrees with the CPU "
                             "plain path or launched the wrong kernel count")


def phase_maskfiner_kernels(torch):
    """The attention forward at the shapes of a real UD-Mini 224 forward:
    its inputs captured from the model (random weights, synthetic images),
    b = 128 bf16 (check and times) and b = 2 fp32 (check)."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        cluster_attention_reference, fused_cluster_attention, tile_metadata,
    )

    dev = torch.device("cuda")
    preset = MASKFINER["maskfiner_ud_mini"][0]
    rows = []
    for b, dtype_name in ((128, "bfloat16"), (2, "float32")):
        for row in captured_attention(preset, b, dtype_name, dev):
            a = row["args"]
            args = [a[k] for k in ATTN_ARGS]
            geo = (row["heads"], row["cs"], row["rel_width"], row["clamp"])
            meta = row["meta"]
            out = fused_cluster_attention(*args, *geo, meta=meta)
            ref = cluster_attention_reference(*args, *geo)  # f32 inside
            torch.cuda.synchronize()
            label = f"maskfiner_ud_mini_{row['label']}_b{b}"
            err = check(label, dtype_name, out, ref)
            count = meta.ucount.float()
            emit({"phase": "stress_unions", "shape": label,
                  "union_clusters_max": int(count.max().item()),
                  "union_clusters_mean": count.mean().item()})
            if b != 128:
                continue
            ms = time_ms(lambda: fused_cluster_attention(*args, *geo,
                                                         meta=meta))
            dev_ms = device_ms(lambda: fused_cluster_attention(
                *args, *geo, meta=meta))
            meta_ms = time_ms(lambda: tile_metadata(a["ncc"]))
            plain = time_ms(lambda: cluster_attention_reference(*args, *geo),
                            iters=5, warmup=1)
            moved, flops = attn_work(torch, a, row["heads"], row["cs"])
            bms, by = bound_ms(moved, flops, "bfloat16")
            rows.append(dict(
                model="maskfiner_ud_mini", shape=row["label"], b=b,
                n=row["n"], heads=row["heads"], c=row["c"],
                clamp_width=row["clamp"], per_pass=row["per_pass"], ms=ms,
                device_ms=dev_ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                bytes=moved, flops=flops, max_abs_err=err))
            emit({"phase": "kernel_time", "kernel": "cluster_attention_fwd",
                  **rows[-1], "tile_metadata_ms": meta_ms})
    return rows


def phase_maskfiner_model(torch):
    """OT and UD-Mini 224 at full width, fp32, b = 2, built through
    ``build_model`` from a fixed seed: the GPU forward (CUDA kernels, TF32
    off) against the CPU forward (plain versions), the same masks on both;
    logits, every level's nearest clusters, the launches."""
    import numpy as np

    from ml_autofocusformermod_torch.models import mixres_neighbour
    from ml_autofocusformermod_torch.models.build import build_model
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        tile_metadata,
    )

    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 3, 224, 224)).astype(np.float32))
    real_knn = mixres_neighbour.knn
    for name, (preset, attn_per_fwd, meta_per_fwd) in MASKFINER.items():
        cfg = port_config(preset, ["TPU.COMPUTE_DTYPE", "float32"])
        nccs = {"cuda": [], "cpu": []}

        def forward(device):
            def recording_knn(*args, **kw):
                out = real_knn(*args, **kw)
                nccs[device].append(out.cpu())
                return out

            mixres_neighbour.knn = recording_knn
            try:
                with torch.no_grad():
                    return build_model(cfg, device, seed=0)(
                        x.to(device)).float().cpu()
            finally:
                mixres_neighbour.knn = real_knn

        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False  # the patch-embed convs
        try:
            zero_counters()
            tile_metadata.calls = 0
            out = forward("cuda")
            torch.cuda.synchronize()
            launches = read_counters()
            meta_calls = tile_metadata.calls
            ref = forward("cpu")
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        err = (out - ref).abs().max().item()
        same_argmax = bool((out.argmax(-1) == ref.argmax(-1)).all())
        same_ncc = (len(nccs["cuda"]) == len(nccs["cpu"]) == meta_per_fwd
                    and all(torch.equal(g, c) for g, c in
                            zip(nccs["cuda"], nccs["cpu"])))
        want = dict.fromkeys(counters(), 0)
        want["cluster_attention_fwd"] = attn_per_fwd
        ok = (err <= 1e-3 and same_argmax and same_ncc and launches == want
              and meta_calls == meta_per_fwd
              and bool(out.isfinite().all()) and out.shape == (2, 1000))
        emit({"phase": "maskfiner_model_check", "model": name,
              "dtype": "float32", "b": 2, "max_abs_err_vs_cpu": err,
              "same_argmax": same_argmax, "same_ncc": same_ncc,
              "ncc_shapes": [list(t.shape) for t in nccs["cuda"]],
              "launches_per_forward": launches,
              "tile_metadata_calls": meta_calls, "ok": ok})
        if not ok:
            raise AssertionError(f"{name} GPU forward disagrees with the CPU "
                                 "plain path or launched the wrong kernels")


def plain_forward(torch, args, geo, dtype, chunk=8, drop=None):
    """The plain forward's (out, stats) in ``dtype`` over batch chunks of
    ``chunk`` images, as :func:`plain_backward` goes."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        cluster_attention_reference,
    )

    parts = []
    for s0 in range(0, args[0].shape[0], chunk):
        sl = [(t[s0:s0 + chunk] if i < 4 else t) for i, t in enumerate(args)]
        parts.append(cluster_attention_reference(
            *(t.to(dtype) if t.is_floating_point() else t for t in sl),
            *geo, drop=drop, want_stats=True, img0=s0))
    return tuple(torch.cat([p[i] for p in parts]) for i in range(2))


def plain_backward(torch, args, g, geo, dtype, chunk=8, saved=None,
                   drop=None):
    """The plain backward in ``dtype`` over batch chunks of ``chunk``
    images (its gathered (b, h, n, m, c_) tensors of a whole b = 128 batch
    would not fit the card in f64): dq and dkv per image, the parameter
    gradients summed over the chunks. ``saved``: the forward's (out,
    stats); ``drop``: (rate, seed), whose masks hash the image's index in
    the whole batch, so each chunk takes its images' masks apart."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        cluster_attention_backward_reference,
    )

    def cast(t):
        return t.to(dtype) if t.is_floating_point() else t

    b = args[0].shape[0]
    parts = []
    for s0 in range(0, b, chunk):
        sl = [cast(t[s0:s0 + chunk] if i < 4 else t)
              for i, t in enumerate(args)]
        kw = {}
        if saved is not None:
            kw["saved"] = tuple(cast(t[s0:s0 + chunk]) for t in saved)
        if drop is not None:
            kw["drop"] = drop
            kw["img0"] = s0
        parts.append(cluster_attention_backward_reference(
            *sl, cast(g[s0:s0 + chunk]), *geo, **kw))
    return ([torch.cat([p[i] for p in parts]) for i in range(2)]
            + [sum(p[i] for p in parts) for i in range(2, 6)])


def phase_maskfiner_train_kernels(torch):
    """The attention forward and backward at the shapes of a UD-Mini 224
    training step, their inputs and output gradients captured from the
    model (random weights, synthetic images, the trainer's loss), at the
    curriculum's first ratios (every token splits: n = 245 / 1029 / 4165)
    and at the final ones (n = 193 / 625 / 1921): b = 128 bf16 (check and
    times) and b = 2 fp32 (check), every backward output against the
    plain backward in f64; each kernel in every mode (the forward with
    statistics and with dropout, the backward recomputing, from the saved
    statistics and under dropout). Returns the b = 128 rows by kernel (the
    backward's: the saved mode, with the recompute mode's times beside)
    and the widest shape's captures (for the determinism phase)."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        TILE, cluster_attention_backward, cluster_attention_forward,
        cluster_attention_reference, fused_cluster_attention, union_rows,
    )

    dev = torch.device("cuda")
    preset = MASKFINER["maskfiner_ud_mini"][0]
    outs = ["dq", "dkv", "d_pe_kernel", "d_pe_bias", "d_blank_k",
            "d_blank_v"]
    rows = {k: [] for k in ("cluster_attention_fwd",
                            "cluster_attention_fwd_stats",
                            "cluster_attention_fwd_dropout",
                            "cluster_attention_bwd",
                            "cluster_attention_bwd_dropout")}
    widest = {}
    for tag, ratios in (("r1", RATIO_ONE[preset]), ("final", None)):
        for b, dtype_name in ((128, "bfloat16"), (2, "float32")):
            captured = captured_attention(preset, b, dtype_name, dev,
                                          train=True, ratios=ratios)
            widest_n = max(r["n"] for r in captured)
            for row in captured:
                a, g, meta = row["args"], row["g"], row["meta"]
                args = [a[k] for k in ATTN_ARGS]
                geo = (row["heads"], row["cs"], row["rel_width"],
                       row["clamp"])
                label = f"maskfiner_ud_mini_train_{tag}_{row['label']}_b{b}"
                out = fused_cluster_attention(*args, *geo, meta=meta)
                ref = cluster_attention_reference(*args, *geo)
                torch.cuda.synchronize()
                err_f = check(label, dtype_name, out, ref)
                del ref
                saved, dsaved, err_m = check_modes_fwd(
                    torch, label, dtype_name, args, geo, meta)
                got = cluster_attention_backward(*args, g, *geo, meta=meta)
                want = plain_backward(torch, args, g, geo, torch.float64)
                torch.cuda.synchronize()
                err_b = max(check(f"{label}_bwd_{o}", dtype_name, x, y)
                            for o, x, y in zip(outs, got, want))
                del got, want
                err_s = check_modes_bwd(torch, f"{label}_bwd", dtype_name,
                                        args, g, geo, saved, dsaved, meta)
                n, c = row["n"], row["c"]
                scratch = 4 * b * -(-n // TILE) * union_rows(
                    meta, row["cs"]) * 2 * c
                count = meta.ucount.float()
                emit({"phase": "stress_unions", "shape": label,
                      "union_clusters_max": int(count.max().item()),
                      "union_clusters_mean": count.mean().item(),
                      "bwd_scratch_bytes": scratch})
                if tag == "r1" and n == widest_n:
                    widest[dtype_name] = (args, g, geo, meta)
                if b != 128:
                    continue
                base = dict(model="maskfiner_ud_mini_train", ratios=tag,
                            shape=row["label"], b=b, n=n,
                            heads=row["heads"], c=c,
                            clamp_width=row["clamp"],
                            per_pass=row["per_pass"])

                def chunked(fn, step=32):
                    """fn(args of a batch chunk, first image) over the
                    batch in chunks, as plain_backward goes"""
                    return lambda: [fn([t[s0:s0 + step] if i < 4 else t
                                        for i, t in enumerate(args)], s0)
                                    for s0 in range(0, b, step)]

                fwd_w = attn_work(torch, a, row["heads"], row["cs"])
                bwd_w = attn_bwd_work(torch, a, g, row["heads"], row["cs"])
                sb = nbytes(*saved)  # the statistics written or read, out
                stats_w = (fwd_w[0] + nbytes(saved[1]), fwd_w[1])
                saved_w = (bwd_w[0] + sb, bwd_w[1])
                recompute = lambda: cluster_attention_backward(
                    *args, g, *geo, meta=meta)
                calls = (
                    ("cluster_attention_fwd",
                     lambda: fused_cluster_attention(*args, *geo, meta=meta),
                     chunked(lambda x, s0: cluster_attention_reference(
                         *x, *geo)), fwd_w, err_f, {}),
                    ("cluster_attention_fwd_stats",
                     lambda: cluster_attention_forward(
                         *args, *geo, meta=meta, want_stats=True),
                     chunked(lambda x, s0: cluster_attention_reference(
                         *x, *geo, want_stats=True)), stats_w, err_m, {}),
                    ("cluster_attention_fwd_dropout",
                     lambda: cluster_attention_forward(
                         *args, *geo, meta=meta, drop=DROP, want_stats=True),
                     chunked(lambda x, s0: cluster_attention_reference(
                         *x, *geo, drop=DROP, want_stats=True, img0=s0)),
                     stats_w, err_m, {}),
                    ("cluster_attention_bwd",
                     lambda: cluster_attention_backward(
                         *args, g, *geo, meta=meta, saved=saved),
                     lambda: plain_backward(torch, args, g, geo,
                                            torch.float32, chunk=32,
                                            saved=saved),
                     saved_w, max(err_b, err_s),
                     dict(mode="saved", recompute_ms=time_ms(recompute),
                          recompute_device_ms=device_ms(recompute),
                          bwd_scratch_bytes=scratch)),
                    ("cluster_attention_bwd_dropout",
                     lambda: cluster_attention_backward(
                         *args, g, *geo, meta=meta, saved=dsaved, drop=DROP),
                     lambda: plain_backward(torch, args, g, geo,
                                            torch.float32, chunk=32,
                                            saved=dsaved, drop=DROP),
                     saved_w, err_s, dict(mode="saved")))
                for kernel, fn, plain, work, err, extra in calls:
                    bms, by = bound_ms(work[0], work[1], "bfloat16")
                    rows[kernel].append(dict(
                        **base, ms=time_ms(fn), device_ms=device_ms(fn),
                        plain_ms=time_ms(plain, iters=3, warmup=1),
                        bound_ms=bms, bound_by=by, bytes=work[0],
                        flops=work[1], max_abs_err=err, **extra))
                    emit({"phase": "kernel_time", "kernel": kernel,
                          **rows[kernel][-1]})
    return rows, widest


def phase_attention_bwd_deterministic(torch, widest):
    """Two attention backwards on the same inputs give the same bytes for
    every output (no float atomics), in each mode (recomputing, from the
    saved statistics, and the saved mode under dropout): AFF-Mini stages
    1-3 (b = 128 bf16 and b = 8 fp32) and the widest UD-Mini training
    shape (n = 4165, captured, b = 128 bf16 and b = 2 fp32)."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        cluster_attention_backward, cluster_attention_forward, tile_metadata,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(4)
    cases = []
    for label, n, h, c, _ in ATTN_STAGES:
        for b, dtype in ((128, torch.bfloat16), (8, torch.float32)):
            a = attention_inputs(gen, b, n, h, c, dev, dtype)
            args = [a[k] for k in ATTN_ARGS]
            g = torch.randn(b, n, c, generator=gen).to(dev, dtype)
            cases.append((f"aff_mini_{label}_b{b}", args, g, (h, CS, 55, 0),
                          tile_metadata(a["ncc"])))
    for dtype_name, (args, g, geo, meta) in widest.items():
        cases.append((f"maskfiner_ud_mini_train_r1_n{args[0].shape[1]}"
                      f"_b{args[0].shape[0]}", args, g, geo, meta))
    for name, args, g, geo, meta in cases:
        for mode, drop in (("recompute", None), ("saved", None),
                           ("saved_dropout", DROP)):
            saved = (None if mode == "recompute" else
                     cluster_attention_forward(*args, *geo, meta=meta,
                                               drop=drop, want_stats=True))
            first, second = (cluster_attention_backward(
                *args, g, *geo, meta=meta, saved=saved, drop=drop)
                for _ in range(2))
            torch.cuda.synchronize()
            equal = {o: bool(torch.equal(x, y)) for o, x, y in zip(
                ["dq", "dkv", "d_pe_kernel", "d_pe_bias", "d_blank_k",
                 "d_blank_v"], first, second)}
            ok = all(equal.values())
            emit({"phase": "attention_bwd_deterministic", "shape": name,
                  "mode": mode, "dtype": str(args[0].dtype).split(".")[1],
                  "equal": equal, "ok": ok})
            if not ok:
                raise AssertionError(f"attention backward ({mode}) not "
                                     f"reproducible at {name}: {equal}")


def phase_maskfiner_train_check(torch):
    """One ``make_train_step`` step of UD-Mini and of OT 224 at full width,
    fp32, b = 2, on the GPU (kernels, TF32 off) against the same step on
    the CPU (plain versions) from the same weights and upsampling masks
    (the train state's CPU generator), at the curriculum's first ratios
    and at the final ones, each as the preset configures it and with
    attention dropout 0.1 on every level (``ATTN_DROP_RATE``; its seeds
    come from the train state's CPU generator and its masks hash them, so
    both devices drop alike): loss and grad_norm within 1e-4 relative,
    every gradient within 1e-3 of its tensor's largest entry (floored at
    1e-5 of the gradient norm), the BatchNorm statistics within 1e-5 (the
    presets have none), and the attention forward and backward launches
    per step (16 and 16 for UD-Mini, 25 and 25 for OT; each forward with
    statistics, each backward from them, both with dropout in the
    dropout run), no other kernel. OT runs with ``MODEL.MR.DROP_RATE``
    zeroed: the two devices' Dropout streams differ."""
    import numpy as np

    from ml_autofocusformermod_torch.models.build import build_model
    from ml_autofocusformermod_torch.train.trainer import (
        create_train_state, make_train_step,
    )

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 3, 224, 224)).astype(
        np.float32))
    y = torch.tensor([3, 977])
    for (name, (preset, attn, _)), attn_drop in itertools.product(
            MASKFINER.items(), (False, True)):
        overrides = {}
        if attn_drop:
            levels = len(port_config(preset, []).MODEL.MR.NAME)
            overrides["MODEL.MR.ATTN_DROP_RATE"] = [0.1] * levels
        if name == "maskfiner_ot":
            overrides["MODEL.MR.DROP_RATE"] = [0.0] * 4
        opts = ["TPU.COMPUTE_DTYPE", "float32"]
        for k, v in overrides.items():
            opts += [k, str(v)]
        cfg = port_config(preset, opts)
        for tag, ratios in (("r1", RATIO_ONE[preset]), ("final", None)):
            def one_step(device):
                model = build_model(cfg, device, seed=0,
                                    upscale_ratios=ratios)
                state, schedule = create_train_state(cfg, model, 10)
                out = make_train_step(cfg, state, schedule)(
                    x.to(device), y.to(device))
                grads = {k: p.grad.float().cpu()
                         for k, p in model.named_parameters()}
                stats = {k: b.float().cpu() for k, b in model.named_buffers()
                         if k.endswith(("running_mean", "running_var"))}
                return out, grads, stats

            tf32 = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            try:
                zero_counters()
                out, grads, stats = one_step("cuda")
                torch.cuda.synchronize()
                launches = read_counters()
                ref, ref_grads, ref_stats = one_step("cpu")
            finally:
                torch.backends.cudnn.allow_tf32 = tf32
            loss, ref_loss = out["loss"].item(), ref["loss"].item()
            gn, ref_gn = out["grad_norm"].item(), ref["grad_norm"].item()
            floor = 1e-5 * ref_gn
            worst = max(((grads[k] - t).abs().max().item()
                         / max(t.abs().max().item(), floor), k)
                        for k, t in ref_grads.items())
            stat_err = max([(stats[k] - t).abs().max().item()
                            / max(t.abs().max().item(), 1e-30)
                            for k, t in ref_stats.items()] or [0.0])
            want = dict.fromkeys(counters(), 0)
            want.update(attention_launches(0, attn, attn_drop=attn_drop))
            ok = (abs(loss - ref_loss) <= 1e-4 * abs(ref_loss)
                  and abs(gn - ref_gn) <= 1e-4 * abs(ref_gn)
                  and worst[0] <= 1e-3 and stat_err <= 1e-5
                  and launches == want and out["grads_finite"]
                  and math.isfinite(loss))
            emit({"phase": "maskfiner_train_check", "model": name,
                  "ratios": tag, "attn_drop": attn_drop,
                  "dtype": "float32", "b": 2,
                  "overrides": overrides, "loss": loss, "loss_cpu": ref_loss,
                  "grad_norm": gn, "grad_norm_cpu": ref_gn,
                  "worst_grad_rel_err": worst[0], "worst_grad": worst[1],
                  "bn_stats": len(ref_stats), "bn_stats_rel_err": stat_err,
                  "launches_per_step": launches, "ok": ok})
            if not ok:
                raise AssertionError(f"{name} ({tag}, attention dropout "
                                     f"{attn_drop}) GPU train step "
                                     "disagrees with the CPU plain path or "
                                     "launched the wrong kernels")


def counters():
    """The launch counters of the kernel wrappers, by kernel (or mode)
    name: (wrapper, counter attribute). A mode's launches are also counted
    in its kernel's."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        cluster_attention_backward, fused_cluster_attention,
    )
    from ml_autofocusformermod_torch.ops.cluster_merge import (
        cluster_merge_backward, fused_cluster_merge, merge_inverse_index,
    )

    return {"cluster_attention_fwd": (fused_cluster_attention, "launches"),
            "cluster_attention_fwd_stats": (fused_cluster_attention,
                                            "stats_launches"),
            "cluster_attention_fwd_dropout": (fused_cluster_attention,
                                              "drop_launches"),
            "cluster_attention_bwd": (cluster_attention_backward,
                                      "launches"),
            "cluster_attention_bwd_saved": (cluster_attention_backward,
                                            "saved_launches"),
            "cluster_attention_bwd_dropout": (cluster_attention_backward,
                                              "drop_launches"),
            "cluster_merge_fwd": (fused_cluster_merge, "launches"),
            "cluster_merge_bwd": (cluster_merge_backward, "launches"),
            "merge_inverse_index": (merge_inverse_index, "launches")}


def zero_counters():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counters():
    return {k: getattr(fn, attr) for k, (fn, attr) in counters().items()}


def attention_launches(fwd, steps, attn_drop=False):
    """The attention counters of ``fwd`` forwards outside training and
    ``steps`` training steps of ``attn`` calls each (pass attn-scaled
    counts): every training forward writes statistics, every backward
    takes them, and with ``attn_drop`` both drop."""
    return {"cluster_attention_fwd": fwd + steps,
            "cluster_attention_fwd_stats": steps,
            "cluster_attention_fwd_dropout": steps if attn_drop else 0,
            "cluster_attention_bwd": steps,
            "cluster_attention_bwd_saved": steps,
            "cluster_attention_bwd_dropout": steps if attn_drop else 0}


def phase_train_check(torch):
    import numpy as np

    from ml_autofocusformermod_torch.models.build import build_model
    from ml_autofocusformermod_torch.ops.cluster_merge import (
        merge_inverse_index,
    )
    from ml_autofocusformermod_torch.train.trainer import (
        create_train_state, make_train_step,
    )

    cfg = port_config("aff_mini.yaml", ["TPU.COMPUTE_DTYPE", "float32"])
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 3, 224, 224)).astype(
        np.float32))
    y = torch.tensor([3, 977])

    def one_step(device):
        model = build_model(cfg, device, seed=0)
        state, schedule = create_train_state(cfg, model, 10)
        step = make_train_step(cfg, state, schedule)
        out = step(x.to(device), y.to(device))
        grads = {k: p.grad.float().cpu() for k, p in model.named_parameters()}
        stats = {k: b.float().cpu() for k, b in model.named_buffers()
                 if k.endswith(("running_mean", "running_var"))}
        return out, grads, stats

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # the patch-embed convs
    try:
        zero_counters()
        merge_inverse_index.calls = 0
        out, grads, stats = one_step("cuda")
        torch.cuda.synchronize()
        launches = read_counters()
        index_calls = merge_inverse_index.calls
        ref, ref_grads, ref_stats = one_step("cpu")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    loss, ref_loss = out["loss"].item(), ref["loss"].item()
    gn, ref_gn = out["grad_norm"].item(), ref["grad_norm"].item()
    # a gradient that is zero in exact arithmetic (the patch-embed conv
    # bias ahead of a training-mode BatchNorm, whose batch mean removes any
    # per-channel constant) is round-off on both devices: each tensor's
    # scale is floored at 1e-5 of the global gradient norm
    floor = 1e-5 * ref["grad_norm"].item()
    worst = max(((grads[k] - g).abs().max().item()
                 / max(g.abs().max().item(), floor), k)
                for k, g in ref_grads.items())
    floored = sorted(k for k, g in ref_grads.items()
                     if g.abs().max().item() < floor)
    stat_err = max((stats[k] - t).abs().max().item()
                   / max(t.abs().max().item(), 1e-30)
                   for k, t in ref_stats.items())
    want = expect(0, 1)
    ok = (abs(loss - ref_loss) <= 1e-4 * abs(ref_loss)
          and abs(gn - ref_gn) <= 1e-4 * abs(ref_gn)
          and worst[0] <= 1e-3 and stat_err <= 1e-5
          and launches == want and index_calls == 3 and out["grads_finite"]
          and math.isfinite(loss))
    emit({"phase": "train_check", "model": "aff_mini_224", "dtype": "float32",
          "b": 2, "loss": loss, "loss_cpu": ref_loss, "grad_norm": gn,
          "grad_norm_cpu": ref_gn, "worst_grad_rel_err": worst[0],
          "worst_grad": worst[1], "grads_at_floor": floored,
          "bn_stats_rel_err": stat_err,
          "launches_per_step": launches,
          "merge_inverse_index_calls": index_calls, "ok": ok})
    if not ok:
        raise AssertionError("AFF-Mini GPU train step disagrees with the CPU "
                             "plain path or launched the wrong kernel count")


def run_main(torch, argv):
    """The entry point with the launch counters zeroed just before and read
    just after."""
    from ml_autofocusformermod_torch import main as port_main

    zero_counters()
    t0 = time.perf_counter()
    result = port_main.main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return result, seconds, read_counters()


def expect(fwd_passes, train_steps=0):
    """Launches of the kernels for ``fwd_passes`` forwards outside
    training and ``train_steps`` train steps of AFF-Mini."""
    f = fwd_passes + train_steps
    return {**attention_launches(10 * fwd_passes, 10 * train_steps),
            "cluster_merge_fwd": 3 * f, "cluster_merge_bwd": 3 * train_steps,
            "merge_inverse_index": 3 * train_steps}


# the numbers of a ``main --eval`` result
EVAL_KEYS = ("throughput_img_s", "acc1", "acc5", "loss")


def phase_entry(torch, smi):
    import os

    cfg = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "ml_autofocusformermod_torch", "configs",
                       "aff_mini.yaml")
    common = ["--cfg", cfg, "--device", "cuda", "--data-path", "no_dataset"]
    result, secs, launches = run_main(
        torch, common + ["--eval", "--batch-size", "32"])
    forwards = 50 + 30 + 4  # throughput protocol + 128 synthetic images / 32
    ok = (launches == expect(forwards)
          and all(math.isfinite(result[k]) for k in EVAL_KEYS))
    emit({"phase": "eval", "batch": 32, "dtype": "bfloat16", **result,
          "seconds": secs, "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError(f"--eval run: launches {launches}")

    result, secs, launches = run_main(
        torch, common + ["--throughput", "--batch-size", "128"])
    ok = launches == expect(50 + 30) and result["throughput_img_s"] > 0
    emit({"phase": "throughput", "model": "aff_mini_224", "batch": 128,
          "dtype": "bfloat16", "img_per_s": result["throughput_img_s"],
          "v100_reference_img_per_s": V100_AFF_MINI_IMG_S, "card": smi,
          "seconds": secs, "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError(f"--throughput run: launches {launches}")
    return launches


def phase_maskfiner_entry(torch, smi):
    """``main --eval`` on UD-Mini 224 (b = 32, bf16) over the synthetic
    set, then ``--throughput`` at b = 128 bf16 of UD-Mini (the MaskFiner
    main path) and of OT. Returns the UD-Mini throughput run's launches."""
    ud, ud_attn, _ = MASKFINER["maskfiner_ud_mini"]
    common = ["--device", "cuda", "--data-path", "no_dataset"]

    def expect_mf(attn_per_fwd, forwards):
        want = dict.fromkeys(counters(), 0)
        want["cluster_attention_fwd"] = attn_per_fwd * forwards
        return want

    result, secs, launches = run_main(
        torch, ["--cfg", preset_path(ud), "--eval", "--batch-size", "32"]
        + common)
    ok = (launches == expect_mf(ud_attn, 50 + 30 + 4)
          and all(math.isfinite(result[k]) for k in EVAL_KEYS))
    emit({"phase": "eval", "model": "maskfiner_ud_mini", "batch": 32,
          "dtype": "bfloat16", **result, "seconds": secs,
          "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError(f"UD-Mini --eval run: launches {launches}")
    path_launches = {}
    for name in ("maskfiner_ud_mini", "maskfiner_ot"):
        preset, attn, _ = MASKFINER[name]
        result, secs, launches = run_main(
            torch, ["--cfg", preset_path(preset), "--throughput",
                    "--batch-size", "128"] + common)
        ok = (launches == expect_mf(attn, 50 + 30)
              and result["throughput_img_s"] > 0)
        emit({"phase": "throughput", "model": name, "batch": 128,
              "dtype": "bfloat16", "img_per_s": result["throughput_img_s"],
              "card": smi, "seconds": secs, "launches": launches, "ok": ok})
        if not ok:
            raise AssertionError(f"{name} --throughput run: launches "
                                 f"{launches}")
        path_launches[name] = launches
    return path_launches["maskfiner_ud_mini"]


def phase_train(torch, smi):
    """``main`` training AFF-Mini 224 bf16 b128 for one synthetic epoch."""
    import os
    import shutil
    import tempfile

    cfg = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "ml_autofocusformermod_torch", "configs",
                       "aff_mini.yaml")
    out = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        result, secs, launches = run_main(torch, [
            "--cfg", cfg, "--device", "cuda", "--data-path", "no_dataset",
            "--batch-size", "128", "--epochs", "1", "--output", out])
        train = result["train"]
        ckpt = os.path.exists(train["checkpoint"])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    steps = train["steps"]
    # throughput protocol, the train steps, 512 validation images / 128
    ok = (launches == expect(50 + 30 + 4, steps) and steps == 4
          and train["skipped_steps"] == 0 and ckpt
          and all(math.isfinite(v) for v in (train["train_loss"],
                                             train["last_grad_norm"],
                                             train["val_loss"])))
    emit({"phase": "train", "model": "aff_mini_224", "batch": 128,
          "dtype": "bfloat16", "steps": steps,
          "img_per_s": train["train_img_s"],
          "img_per_s_after_first": train["train_img_s_after_first"],
          "step_seconds": train["step_seconds"],
          "train_loss": train["train_loss"],
          "last_grad_norm": train["last_grad_norm"],
          "val_loss": train["val_loss"], "checkpoint_written": ckpt,
          "card": smi, "seconds": secs, "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError(f"training run: launches {launches}, {train}")
    return launches, train["train_img_s_after_first"]


def phase_dropout(torch):
    """The port's Dropout on the card (OT's preset drops 0.2 at level 1):
    its keep share within 5 standard deviations of 1 - p, every kept
    element scaled by exactly 1 / (1 - p), and the same mask again from a
    reseeded generator, bf16 and fp32."""
    from ml_autofocusformermod_torch.models.layers import Dropout

    n, p = 1 << 22, 0.2
    for dtype in (torch.float32, torch.bfloat16):
        drop = Dropout(p).train()
        drop.generator = torch.Generator(device="cuda").manual_seed(7)
        x = torch.ones(n, device="cuda", dtype=dtype)
        y = drop(x)
        kept = y != 0
        share = kept.float().mean().item()
        scale_ok = bool((y[kept] == 1.0 / (1.0 - p)).all())
        drop.generator.manual_seed(7)
        again = bool(torch.equal(drop(x), y))
        ok = (abs(share - (1 - p)) <= 5 * (p * (1 - p) / n) ** 0.5
              and scale_ok and again and y.dtype == dtype)
        emit({"phase": "dropout_check", "dtype": str(dtype).split(".")[1],
              "p": p, "n": n, "keep_share": share, "scale_exact": scale_ok,
              "replays_from_seed": again, "ok": ok})
        if not ok:
            raise AssertionError("Dropout on the card: wrong share, scale "
                                 "or stream")


def phase_maskfiner_train(torch, smi):
    """``main`` training UD-Mini 224 (the slice's main path) and OT 224 at
    full width, bf16, b = 128, each as the preset configures it and again
    with attention dropout 0.1 on every level (``--opts
    MODEL.MR.ATTN_DROP_RATE``), for two synthetic epochs of 4 steps: the
    curriculum trains epoch 0 at ratio 1.0 and epoch 1 halfway to the
    final ratios (UD-Mini 0.9; OT 0.9 / 0.8 / 0.8). Per epoch the ratios,
    images/s after the first step, step ms and peak memory. Returns the
    launches of each run by name (``<model>_train`` for the preset's,
    ``<model>_train_attn_drop``)."""
    import os
    import shutil
    import tempfile

    from ml_autofocusformermod_torch.train import curriculum

    by_run, img_s = {}, {}
    for (name, (preset, attn, _)), dropping in itertools.product(
            MASKFINER.items(), (False, True)):
        mr = port_config(preset, []).MODEL.MR
        final = mr.UPSCALE_RATIO
        attn_drop = [0.1] * len(mr.NAME) if dropping else mr.ATTN_DROP_RATE
        opts = (["--opts", "MODEL.MR.ATTN_DROP_RATE", str(attn_drop)]
                if dropping else [])
        out = tempfile.mkdtemp(prefix="chip_smoke_mf_train_")
        try:
            result, secs, launches = run_main(torch, [
                "--cfg", preset_path(preset), "--device", "cuda",
                "--data-path", "no_dataset", "--batch-size", "128",
                "--epochs", "2", "--output", out, *opts])
            train = result["train"]
            ckpt = os.path.exists(train["checkpoint"])
        finally:
            shutil.rmtree(out, ignore_errors=True)
        epochs = train["epochs"]
        steps = sum(e["steps"] for e in epochs)
        # throughput protocol, the train steps, per epoch 512 validation
        # images / 128
        want = dict.fromkeys(counters(), 0)
        want.update(attention_launches(attn * (50 + 30 + 2 * 4),
                                       attn * steps, attn_drop=dropping))
        ratios = [e["ratios"] for e in epochs]
        ok = (launches == want and steps == 8 and ckpt
              and all(e["skipped_steps"] == 0 for e in epochs)
              and ratios == [curriculum.epoch_upsample_ratios(final, 2, e)
                             for e in (0, 1)]
              and ratios[0] != ratios[1]
              and all(math.isfinite(v) for v in (train["train_loss"],
                                                 train["last_grad_norm"],
                                                 train["val_loss"])))
        for e in epochs:
            emit({"phase": "maskfiner_train_epoch", "model": name,
                  "attn_drop": dropping, "batch": 128, "dtype": "bfloat16",
                  **e, "card": smi})
        emit({"phase": "maskfiner_train", "model": name, "batch": 128,
              "dtype": "bfloat16", "attn_drop_rate": list(attn_drop),
              "steps": steps,
              "img_per_s_after_first": [e["img_s_after_first"]
                                        for e in epochs],
              "step_ms_median": [1e3 * sorted(e["step_seconds"])[
                  len(e["step_seconds"]) // 2] for e in epochs],
              "ratios": ratios,
              "peak_memory_bytes": [e["peak_memory_bytes"] for e in epochs],
              "train_loss": train["train_loss"],
              "val_loss": train["val_loss"], "checkpoint_written": ckpt,
              "card": smi, "seconds": secs, "launches": launches, "ok": ok})
        if not ok:
            raise AssertionError(f"{name} training run (attention "
                                 f"dropout {dropping}): launches "
                                 f"{launches}, ratios {ratios}")
        by_run[name + "_train" + ("_attn_drop" if dropping else "")] = (
            launches)
        if not dropping:
            img_s[name] = epochs[0]["img_s_after_first"]
    return by_run, img_s


# ------------------------------------------------- the real-data path ----

def phase_data_env():
    """What the card's host offers the data feed: Pillow, g++, libjpeg's
    header, the native library's build outcome, the CPU count."""
    import os

    from ml_autofocusformermod_torch.data import native_jpeg

    try:
        import PIL

        pillow = PIL.__version__
    except ImportError:
        pillow = None
    try:
        gxx = subprocess.run(["g++", "--version"], capture_output=True,
                             text=True, timeout=60).stdout.splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        gxx = None
    # the compiler's own search for the header (the build below needs it)
    jpeglib = gxx is not None and subprocess.run(
        ["g++", "-E", "-x", "c++", "-"], input="#include <jpeglib.h>\n",
        capture_output=True, text=True, timeout=60).returncode == 0
    env = {"phase": "data_env", "pillow": pillow, "gxx": gxx,
           "jpeglib_h": jpeglib, "native_build": native_jpeg.build_info(),
           "cpu_count": os.cpu_count()}
    emit(env)
    return env


def phase_imagefolder_fabricate(root):
    """A JPEG ImageFolder of 10 classes: ``train`` 52 and ``val`` 13
    images per class at ImageNet-like sizes (500x375, 375x500, 500x333,
    320x240, and one 1024x768 per class and split), quality 90, with one
    grayscale JPEG and one PNG per class and split. Each image is its
    class's smooth colour field at its size plus sensor noise cut from one
    shared block at a random offset, with a random brightness shift."""
    import os

    import numpy as np
    from PIL import Image

    sizes = [(500, 375), (375, 500), (500, 333), (320, 240)]
    rng = np.random.default_rng(0)
    noise = rng.normal(0, 12, (768 + 64, 1024 + 64, 3)).astype(np.int16)
    fields = {}

    def photo(w, h, cls):
        if (w, h, cls) not in fields:
            y, x = np.mgrid[0:h, 0:w].astype(np.float32)
            f = 1.0 + 0.37 * cls
            fields[w, h, cls] = (np.stack(
                [np.sin(x / w * 6.3 * f + c) * np.cos(y / h * 4.1 * f - c)
                 for c in (0.0, 1.3, 2.6)], -1) * 90 + 128).astype(np.int16)
        oy, ox = rng.integers(0, 64, 2)
        img = (fields[w, h, cls] + noise[oy:oy + h, ox:ox + w]
               + int(rng.integers(-30, 30)))
        return np.clip(img, 0, 255).astype(np.uint8)

    t0 = time.perf_counter()
    total, files = 0, 0
    for split, per_class in (("train", 52), ("val", 13)):
        for cls in range(10):
            d = os.path.join(root, split, f"n{cls:08d}")
            os.makedirs(d)
            for i in range(per_class):
                w, h = (1024, 768) if i == 0 else sizes[i % len(sizes)]
                img = Image.fromarray(photo(w, h, cls))
                if i == 1:
                    img = img.convert("L")
                path = os.path.join(d, f"{split}_{cls}_{i:03d}."
                                    + ("png" if i == 2 else "JPEG"))
                if i == 2:
                    img.save(path)
                else:
                    img.save(path, quality=90)
                total += os.path.getsize(path)
                files += 1
    emit({"phase": "imagefolder_fabricate", "files": files,
          "classes": 10, "train": 520, "val": 130, "bytes": total,
          "seconds": time.perf_counter() - t0})


def phase_data_check(torch, root):
    """The data feed on the card's host, on the fabricated folder: the
    native train and eval paths against the Pillow ones (JAX's tolerance,
    ``tests/test_native_data.py:127-160``: within 0.2 in normalised units,
    RandAugment and erasing off, full-resolution decode) where the native
    library is there; a ``Loader`` with the card's worker count against
    none, batch by batch (equal bytes); ``prefetch_to_device`` to the card
    against the loader's batches (equal bytes); decode images/s per worker
    on each path, train and eval transforms."""
    import os
    import random

    from PIL import Image

    from ml_autofocusformermod_torch.data import imagenet, native_jpeg
    from ml_autofocusformermod_torch.data.prefetch import prefetch_to_device
    from ml_autofocusformermod_torch.data.transforms import (
        EvalTransform, TrainTransform,
    )

    cfg = port_config("aff_mini.yaml", ["DATA.DATA_PATH", root])
    workers = min(cfg.DATA.NUM_WORKERS, os.cpu_count() or 1)
    native = native_jpeg.available()
    agree = {"ran": False, "missing": ["native library"]}
    if native:
        plain = port_config("aff_mini.yaml", [
            "DATA.DATA_PATH", root, "AUG.AUTO_AUGMENT", "none",
            "AUG.COLOR_JITTER", "0.0", "AUG.REPROB", "0.0"])
        ds, _ = imagenet.build_dataset(plain, True)
        jpegs = [p for p, _ in ds.samples if p.endswith(".JPEG")][:24]
        worst = {"train": 0.0, "eval": 0.0}
        for i, path in enumerate(jpegs):
            with open(path, "rb") as f:
                data = f.read()
            w, h = native_jpeg.jpeg_dims(data)
            for kind, t in (("train", TrainTransform(plain)),
                            ("eval", EvalTransform(plain))):
                with Image.open(path) as img:
                    a = t(img, random.Random(i))
                rng = random.Random(i)
                box, interp, flip, _ = t.native_geometry(w, h, rng)
                arr8 = native_jpeg.decode_crop_resize(
                    data, box, (t.size, t.size), flip=flip,
                    interpolation=interp, fast_scale=False)
                b = t.finish_uint8(arr8, rng)
                worst[kind] = max(worst[kind], float(abs(a - b).max()))
        agree = {"ran": True, "files": len(jpegs), "max_abs_err": worst,
                 "ok": max(worst.values()) < 0.2}
    ds, _ = imagenet.build_dataset(cfg, True)
    serial = imagenet.Loader(ds, 128, shuffle=True, seed=cfg.SEED)
    par = imagenet.Loader(ds, 128, shuffle=True, seed=cfg.SEED,
                          num_workers=workers, pin_memory=True)
    t0 = time.perf_counter()
    want = list(serial)
    serial_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = list(par)
    par_s = time.perf_counter() - t0
    loader_equal = len(got) == len(want) == 4 and all(
        torch.equal(g[k], w[k]) for g, w in zip(got, want) for k in w)
    on_card = list(prefetch_to_device(iter(want), "cuda"))
    prefetch_equal = len(on_card) == 4 and all(
        c[k].device.type == "cuda" and torch.equal(c[k].cpu(), w[k])
        for c, w in zip(on_card, want) for k in w)
    val_ds, _ = imagenet.build_dataset(cfg, False)
    val = imagenet.Loader(val_ds, 128, shuffle=False, drop_last=False,
                          stride_shard=True)
    t0 = time.perf_counter()
    n_val = sum(len(b["label"]) for b in val)
    val_s = time.perf_counter() - t0
    rates = {f"train_{'native' if native else 'pil'}": 512 / serial_s,
             f"eval_{'native' if native else 'pil'}": n_val / val_s}
    if native:  # the Pillow path's rate beside the native one
        ds.native = val_ds.native = False
        t0 = time.perf_counter()
        list(imagenet.Loader(ds, 128, shuffle=True, seed=cfg.SEED))
        rates["train_pil"] = 512 / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        list(imagenet.Loader(val_ds, 128, shuffle=False, drop_last=False,
                             stride_shard=True))
        rates["eval_pil"] = n_val / (time.perf_counter() - t0)
    counts = {"serial": dict(serial.decode_counts),
              "workers": dict(par.decode_counts),
              "val": dict(val.decode_counts)}
    ok = (loader_equal and prefetch_equal and agree.get("ok", True)
          and n_val == 130 and counts["serial"] == counts["workers"]
          and sum(counts["serial"].values()) == 512)
    emit({"phase": "data_check", "native": native,
          "native_vs_pil": agree, "workers": workers,
          "loader_workers_equal_serial": loader_equal,
          "prefetch_cuda_equal": prefetch_equal,
          "serial_seconds": serial_s, "workers_seconds": par_s,
          "decode_img_per_s_per_worker": rates,
          "decoded_by_path": counts, "ok": ok})
    if not ok:
        raise AssertionError("data feed: the loader's workers, the prefetch "
                             "or the native path disagree")


PTH_DROPPED = "layers.1.blocks.0.norm1.bias"


def phase_pth_check(torch, tmp):
    """Reference-format ``.pth`` files (``{'model': state_dict}`` of
    seeded 10-class models, BatchNorm step counters included) for AFF-Mini
    and UD-Mini; AFF-Mini's with one key dropped and one foreign key added,
    loaded through ``MODEL.PRETRAINED`` (``main.load_reference``) into a
    model on the card and one on the CPU: fp32 b2 logits within 1e-3 with
    the same argmax, 1 missing and 1 unexpected key reported on both; a
    file with a 1000-class head raises. Returns the clean files' paths."""
    import os

    import numpy as np

    from ml_autofocusformermod_torch import main as port_main
    from ml_autofocusformermod_torch.models.build import build_model

    ten = ["MODEL.NUM_CLASSES", "10", "TPU.COMPUTE_DTYPE", "float32"]
    paths = {}
    for name, preset in (("aff_mini", "aff_mini.yaml"),
                         ("maskfiner_ud_mini", MASKFINER[
                             "maskfiner_ud_mini"][0])):
        sd = build_model(port_config(preset, ten), "cpu", seed=3).state_dict()
        paths[name] = os.path.join(tmp, f"{name}_10cls.pth")
        torch.save({"model": sd, "epoch": 299}, paths[name])
    sd = torch.load(paths["aff_mini"], weights_only=False)["model"]
    counters_in = sum(k.endswith("num_batches_tracked") for k in sd)
    del sd[PTH_DROPPED]
    sd["extra_head.weight"] = torch.ones(4, 4)
    edited = os.path.join(tmp, "aff_mini_edited.pth")
    torch.save({"model": sd}, edited)
    cfg = port_config("aff_mini.yaml", ten + ["MODEL.PRETRAINED", edited])
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 3, 224, 224)).astype(np.float32))
    out, loaded = {}, {}
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for dev in ("cuda", "cpu"):
            model = build_model(cfg, dev, seed=0)
            loaded[dev] = port_main.load_reference(cfg, model, None,
                                                   lambda msg: None)
            with torch.no_grad():
                out[dev] = model(x.to(dev)).float().cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    err = (out["cuda"] - out["cpu"]).abs().max().item()
    same_argmax = bool((out["cuda"].argmax(-1) == out["cpu"].argmax(-1)).all())
    reported = {dev: (len(v["pretrained"]["missing"]),
                      len(v["pretrained"]["unexpected"]))
                for dev, v in loaded.items()}
    sd["head.weight"] = torch.zeros(1000, 384)
    sd["head.bias"] = torch.zeros(1000)
    wrong = os.path.join(tmp, "aff_mini_in1k_head.pth")
    torch.save({"model": sd}, wrong)
    try:
        port_main.load_reference(
            port_config("aff_mini.yaml", ten + ["MODEL.PRETRAINED", wrong]),
            build_model(cfg, "cpu", seed=0), None, lambda msg: None)
        raised = None
    except ValueError as e:
        raised = str(e)
    ok = (err <= 1e-3 and same_argmax and counters_in > 0
          and reported == {"cuda": (1, 1), "cpu": (1, 1)}
          and raised is not None and "head" in raised
          and bool(out["cuda"].isfinite().all()))
    emit({"phase": "pth_check", "model": "aff_mini_224", "dtype": "float32",
          "b": 2, "num_batches_tracked_in_file": counters_in,
          "dropped": PTH_DROPPED, "missing_unexpected": reported,
          "max_abs_err_vs_cpu": err, "same_argmax": same_argmax,
          "wrong_head_raises": raised, "ok": ok})
    if not ok:
        raise AssertionError("reference .pth import: the card disagrees "
                             "with the CPU, or the key report is wrong")
    return paths


def phase_imagefolder_train(torch, smi, root, pths, synthetic):
    """``main`` training AFF-Mini 224 and UD-Mini 224 (bf16, b = 128) for
    one epoch on the fabricated folder from the ``.pth`` files of
    :func:`phase_pth_check` (``MODEL.PRETRAINED``): 4 steps of the real
    transforms (RRC, flip, RandAugment m9, random erasing) through the
    decoder, the workers and the prefetch; a validation over its 130
    images (128 + 2); then ``--eval --resume`` of the epoch's checkpoint
    reproduces the val loss to 1e-5 relative (UD-Mini at the epoch's
    ratios). Prints img/s after the first step (step time alone, and with
    the waits for data) beside the same script's synthetic-data run, the
    items per decoder, peak memory and launches. Returns the training
    runs' launches by name."""
    import os
    import shutil
    import tempfile

    by_run = {}
    for name, preset in (("aff_mini", "aff_mini.yaml"),
                         ("maskfiner_ud_mini",
                          MASKFINER["maskfiner_ud_mini"][0])):
        out = tempfile.mkdtemp(prefix="chip_smoke_folder_")
        try:
            result, secs, launches = run_main(torch, [
                "--cfg", preset_path(preset), "--device", "cuda",
                "--data-path", root, "--batch-size", "128", "--epochs", "1",
                "--output", out, "--opts", "MODEL.PRETRAINED", pths[name]])
            train = result["train"]
            epoch = train["epochs"][0]
            opts = []
            if epoch["ratios"] is not None:  # evaluate at the epoch's ratios
                opts = ["--opts", "MODEL.MR.UPSCALE_RATIO",
                        str(epoch["ratios"])]
            again, eval_secs, eval_launches = run_main(torch, [
                "--cfg", preset_path(preset), "--device", "cuda",
                "--data-path", root, "--batch-size", "128", "--eval",
                "--resume", train["checkpoint"], *opts])
        finally:
            shutil.rmtree(out, ignore_errors=True)
        # the throughput protocol, 4 train steps, 2 validation batches
        if name == "aff_mini":
            want, want_eval = expect(80 + 2, 4), expect(80 + 2)
        else:
            attn = MASKFINER[name][1]
            want = dict.fromkeys(counters(), 0)
            want_eval = dict(want)
            want.update(attention_launches(attn * 82, attn * 4))
            want_eval.update(attention_launches(attn * 82, 0))
        pre = result["weights"]["pretrained"]
        reproduced = (abs(again["loss"] - train["val_loss"])
                      <= 1e-5 * abs(train["val_loss"]))
        decoded = result["decoded"]
        ok = (launches == want and eval_launches == want_eval
              and train["steps"] == 4 and train["skipped_steps"] == 0
              and result["num_classes"] == 10
              and pre["missing"] == [] and pre["unexpected"] == []
              and train["val_count"] == 130 and again["val_count"] == 130
              and reproduced
              and sum(decoded["train"].values()) == 512
              and sum(decoded["val"].values()) == 128 + 130
              and all(math.isfinite(v) for v in (
                  train["train_loss"], train["val_loss"], again["loss"])))
        emit({"phase": "imagefolder_train", "ran": True, "model": name,
              "batch": 128, "dtype": "bfloat16", "steps": train["steps"],
              "ratios": epoch["ratios"],
              "img_per_s_after_first": train["train_img_s_after_first"],
              "wall_img_per_s_after_first":
                  train["train_wall_img_s_after_first"],
              "synthetic_img_per_s_after_first": synthetic[name],
              "step_seconds": epoch["step_seconds"],
              "data_wait_seconds": epoch["data_wait_seconds"],
              "decoded_by_path": decoded,
              "peak_memory_bytes": epoch["peak_memory_bytes"],
              "val_images": train["val_count"], "val_acc1": train["acc1"],
              "val_loss": train["val_loss"],
              "eval_resume_val_loss": again["loss"],
              "eval_resume_reproduces": reproduced,
              "pretrained": {k: pre[k] for k in ("missing", "unexpected")},
              # the run's launches less the evaluation's 82 forwards
              "launches_per_step": {k: (launches[k] - eval_launches[k]) / 4
                                    for k in launches},
              "card": smi, "seconds": secs, "eval_seconds": eval_secs,
              "launches": launches, "eval_launches": eval_launches,
              "ok": ok})
        if not ok:
            raise AssertionError(f"{name} on the ImageFolder: launches "
                                 f"{launches} / {eval_launches}, {train}")
        by_run[f"{name}_imagefolder_train"] = launches
    return by_run


def phase_real_data(torch, smi, env, synthetic):
    """The real-data path: the folder, the data checks, the ``.pth``
    import and the two training runs, in a temporary directory removed
    after. Without Pillow (which writes the folder) it reports what is
    missing and runs none of it. Returns the training runs' launches."""
    import shutil
    import tempfile

    if env["pillow"] is None:
        emit({"phase": "imagefolder_train", "ran": False,
              "missing": ["Pillow"], "native_build": env["native_build"]})
        return {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_imagefolder_")
    try:
        root = tmp + "/imagenet"
        phase_imagefolder_fabricate(root)
        phase_data_check(torch, root)
        pths = phase_pth_check(torch, tmp)
        return phase_imagefolder_train(torch, smi, root, pths, synthetic)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def child_processes() -> list:
    """(pid, command line) of the processes whose parent is this one."""
    import os

    me, out = os.getpid(), []
    for d in os.listdir("/proc"):
        try:
            with open(f"/proc/{d}/stat") as f:
                # the fields after the command name, which may hold spaces
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
            if ppid == me:
                with open(f"/proc/{d}/cmdline", "rb") as f:
                    out.append((int(d), f.read().replace(b"\0", b" ")
                                .decode(errors="replace").strip()))
        except (OSError, ValueError, IndexError):
            continue  # not a process, or it has just exited
    return out


def stop_processes() -> None:
    """Stop every process the run started that would outlive it: the
    loaders' worker server and its resource tracker (their worker processes
    end with the loader passes, all closed by now). Fails if a child
    process of this one is still there after."""
    import gc

    gc.collect()  # closes any loader pass whose iterator was dropped
    imagenet = sys.modules.get("ml_autofocusformermod_torch.data.imagenet")
    if imagenet is not None:
        imagenet.stop_worker_server()
    left = child_processes()
    emit({"phase": "stop_processes", "left": left, "ok": not left})
    if left:
        raise AssertionError(f"processes still running: {left}")


def kernels_line(rows, launches, mf_rows, mf_launches, mft_rows,
                 mft_launches):
    """One entry per CUDA kernel: launches in the training run of the entry
    point (the AFF path, which runs them all), the worst check error, and
    per AFF-Mini b128 bf16 pass (a forward for the forward kernels, a
    backward for the backward kernels) the sum of the per-call times over
    the pass's launches; then the same for the MaskFiner paths: UD-Mini
    b128 bf16 ``--throughput`` (the attention forward only) under
    ``maskfiner_ud_mini``, and UD-Mini b128 bf16 training (the attention
    forward and backward, per training step at the curriculum's first and
    at the final ratios) under ``maskfiner_ud_mini_train``. The dropout
    modes run on the MaskFiner training path with attention dropout only:
    their ``launches`` are the UD-Mini training run's with it
    (``launches_from``). A kernel of the path that the run did not launch
    fails the script."""
    def total(rs, key):
        return sum(r[key] * r["per_pass"] for r in rs)

    def bound_by(rs):
        return ("bytes" if all(r["bound_by"] == "bytes" for r in rs)
                else "operations")

    def block(rs, n_launches):
        return {"launches": n_launches, "ms": total(rs, "ms"),
                "device_ms": total(rs, "device_ms"),
                "plain_ms": total(rs, "plain_ms"),
                "bound_ms": total(rs, "bound_ms"), "bound_by": bound_by(rs),
                "library_ms": None, "per_shape": rs}

    out = []
    for name, (src, replaces, also) in KERNELS.items():
        rs = rows[name]
        mf = mf_rows if name == "cluster_attention_fwd" else []
        mft = mft_rows.get(name, [])
        mf_path = name.endswith("_dropout")
        ud_run = "maskfiner_ud_mini_train" + ("_attn_drop" if mf_path
                                              else "")
        n_launches = (mft_launches[ud_run][name] if mf_path
                      else launches[name])
        if n_launches == 0:
            raise AssertionError(f"{name} was not launched on its path")
        entry = {
            "name": name, "route": "cuda", "source": CSRC + src,
            "replaces": replaces, "also_replaces": also,
            "launches": n_launches,
            "launches_from": ud_run if mf_path else "aff_mini_train",
            "max_abs_err": max(r["max_abs_err"] for r in rs + mf + mft),
            "ms": total(rs, "ms"), "device_ms": total(rs, "device_ms"),
            "plain_ms": total(rs, "plain_ms"),
            "bound_ms": total(rs, "bound_ms"), "bound_by": bound_by(rs),
            "library_ms": None,  # no single PyTorch call computes it
            "per_shape": rs,
            "launches_by_path": {"aff_mini_train": launches[name],
                                 "maskfiner_ud_mini_throughput":
                                     mf_launches[name],
                                 **{run: mft_launches[run][name]
                                    for run in mft_launches}},
        }
        if name == "cluster_attention_bwd":
            entry["launches_saved"] = launches["cluster_attention_bwd_saved"]
        if mf:
            entry["maskfiner_ud_mini"] = block(mf, mf_launches[name])
        for tag in ("r1", "final"):
            part = [r for r in mft if r["ratios"] == tag]
            if part:
                entry[f"maskfiner_ud_mini_train_{tag}"] = block(
                    part, mft_launches[ud_run][name])
        out.append(entry)
    return {"kernels": out}


def main() -> int:
    import torch

    smi = phase_device(torch)
    try:
        env = phase_data_env()
        phase_build()
        fwd = phase_kernels(torch)
        bwd = phase_kernels_bwd(torch)
        rows = {"cluster_attention_fwd": fwd["attention"],
                "cluster_attention_fwd_stats": fwd["stats"],
                "cluster_attention_fwd_dropout": fwd["dropout"],
                "cluster_attention_bwd": bwd["attention"],
                "cluster_attention_bwd_dropout": bwd["dropout"],
                **phase_merge(torch)}
        mf_rows = phase_maskfiner_kernels(torch)
        mft_rows, widest = phase_maskfiner_train_kernels(torch)
        phase_attention_bwd_deterministic(torch, widest)
        del widest
        phase_model(torch)
        phase_train_check(torch)
        phase_maskfiner_model(torch)
        phase_maskfiner_train_check(torch)
        phase_dropout(torch)
        phase_entry(torch, smi)
        launches, aff_img_s = phase_train(torch, smi)
        mf_launches = phase_maskfiner_entry(torch, smi)
        mft_launches, mf_img_s = phase_maskfiner_train(torch, smi)
        mft_launches.update(phase_real_data(
            torch, smi, env,
            {"aff_mini": aff_img_s,
             "maskfiner_ud_mini": mf_img_s["maskfiner_ud_mini"]}))
        line = kernels_line(rows, launches, mf_rows, mf_launches, mft_rows,
                            mft_launches)
    finally:
        stop_processes()
    emit(line)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
