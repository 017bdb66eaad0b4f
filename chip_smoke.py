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
12. the single-card switches: ops_check calls each op of the ``mlaff``
   namespace as ``torch.ops.mlaff.*`` (not through the wrappers) at
   AFF-Mini's stage 2 and second merge, b = 8 fp32, against its plain
   version (1e-4 of max|ref|; the inverse index exactly) with one launch
   per call; remat_check runs one fp32 b = 2 train step of AFF-Mini and
   of UD-Mini (ratio 1.0) with Dropout, DropPath and attention dropout at
   0.1, from equal states, with ``TPU.REMAT`` '' (twice), ``blocks`` and
   ``dots``: the loss equal to the bit, each gradient equal to the bit
   where the two '' runs are and else within twice their spread, the
   generators' states equal, and per step 20 (AFF-Mini) or 32 (UD-Mini)
   attention forwards against 10 / 16 backwards; remat_train runs
   ``main`` at b = 128 bf16 with each mode for one synthetic epoch
   (UD-Mini at ratio 1.0): img/s after the first step and peak memory
   beside the same run without remat (phases 8 and 10); export exports
   AFF-Mini and UD-Mini at b = 128 bf16 on the card, loads each program
   in a fresh process that imports no model code and calls it with the
   model's state dict: logits equal to the eager model's, launches an
   eager forward's (10 + 3, 16), the export's seconds and the artifact's
   bytes; flops runs ``main --throughput --opts PRINT_FLOPS True``
   (GFLOPs per image, parameters; AFF-Mini beside its published 6.75 M
   and 1.08 G ptflops MACs); profile runs ``main --profile`` on AFF-Mini
   with a 2-step window: 2 step spans, and each fused kernel by its CUDA
   name as often as its counter counts over 2 steps;
13. data and tensor parallelism with ZeRO-1, two processes sharing the
   one card (gloo, which carries CUDA tensors through the host; NCCL takes
   one rank per card): kernel_check / kernel_time rows ``attention_tp2_*``
   hold the attention forward (with statistics) and the saved backward at
   AFF-Mini's tensor-parallel shapes (model size 2: h = 1 / 2 / 4 heads of
   c = 16 / 64 / 128 channels, b = 128 bf16) against their plain
   versions; parallel_check runs two train steps of AFF-Mini and of
   UD-Mini 224 (ratio 1.0), fp32, b = 2 per rank, at data 2, data 2 +
   ZeRO-1 and model 2 against the one-process steps of the global batch
   on the same card (loss and grad_norm within 1e-4 relative, every
   gradient and parameter within 1e-3 of its tensor's largest entry),
   UD-Mini also at data 2 with ``ATTN_DROP_RATE`` 0.1 (each data rank's
   attention seed offset by its first global image), each rank's
   launches; parallel_train runs ``main`` on two ranks (``--device
   cuda:0 --dist-backend gloo``) for AFF-Mini and UD-Mini at b = 64 per
   rank, bf16, two epochs of two steps, with and without ``TPU.ZERO1``:
   img/s per rank and summed, peak memory per rank, ms per step in
   collectives (they say nothing of scaling), then a world of one under
   torchrun's environment with NCCL; parallel_ckpt evaluates the two-rank
   ZeRO-1 checkpoint in one process (``--eval --resume``), whose val loss
   must match the run's;
14. sequence parallelism (``TPU.MESH_SEQ``), two processes sharing the
   one card through gloo: kernel_check / kernel_time rows
   ``attention_seq2_*`` hold the attention forward (with statistics and
   with dropout) and the saved backward (with and without dropout, every
   output, also against the exact gradient) over each half of the tokens
   (``q0`` = 0 and the second half) against every token's k/v, at
   AFF-Mini's stages and UD-Mini's n = 1921 / 4165 level shapes, b = 128
   bf16, timed beside the range's bound (``range_work``: the kv rows of
   the clusters the range reads and the positions it reads, counted
   once); seq_full_range: a range of every token (``q0`` = 0, ``nq`` =
   n) gives the plain launch's bits;
   parallel_seq_check runs two train steps of AFF-Mini and UD-Mini (ratio
   1.0), fp32, b = 2, at seq 2 against the one-process steps (loss and
   grad_norm within 1e-5 relative, gradients and parameters as
   parallel_check), UD-Mini also with ``ATTN_DROP_RATE`` 0.1, every
   attention launch of the ranks a range; parallel_seq_train runs ``main``
   on two ranks at seq 2 for AFF-Mini and UD-Mini, b = 64, bf16, one epoch
   of four steps (its throughput protocol cut to 1 + 1 forwards): img/s
   after the first step and peak memory per rank, ms per step in
   collectives, launches;
15. pipeline parallelism (``parallel/pp.py``, GPipe) over AFF-Mini's
   stage 3 (six blocks, dim 256, 8 heads, n = 196), its input, positions,
   nearest clusters and tile metadata captured before the stage's first
   block in a real forward, ranks on the one card through gloo:
   parallel_pipe_check (fp32, b = 8, the same blocks on every rank) runs
   pipe 2 at M = 2, 4 and 8 microbatches and data 2 x pipe 2 at M = 2
   against one process's ``sequential_blocks`` on the card: the output
   within 1e-5 of max|ref|, ``x``'s gradient and every block's gradient
   within 1e-4, whether each is bit-equal, every pipe rank the same
   output; parallel_pipe_train (b = 128 bf16, pipe 2 at M = 4 and 8, the
   collectives timed) holds the same at 2e-2 and gives ms per pipelined
   forward and backward per rank beside one process's sequential ms, the
   bubble (P-1)/(M+P-1), ms and count of collectives per step, peak
   memory per rank above what the process held before; every rank
   launches the attention forward with statistics and the saved backward
   3 M times per pass (3 blocks per stage on M microbatches; the
   bubble's compute is skipped);
16. stop_processes, also when a phase fails: the loaders' worker server
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
(``..._imagefolder_train``), in the remat runs (``..._remat_blocks``,
``_remat_dots``), the exported programs' calls (``..._export``), the
profiled run (``aff_mini_profile``), each rank of the parallel runs
(``<model>[_attn_drop]_<layout>_rank<r>``,
``<model>_parallel_train[_zero1]_rank<r>``,
``<model>[_attn_drop]_seq2_rank<r>``, ``<model>_seq2_train_rank<r>``,
``aff_mini_s3_pipe2_m<M>_rank<r>``: one pipelined pass of the stage-3
chain, counted inside each rank's process) and the NCCL run
(``aff_mini_nccl_world1``), and for the attention kernels their
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
    ATTN_ARGS, ATTN_STAGES, CS, IC, MERGES, NNC, RATIO_ONE,
    attention_inputs, captured_attention, clustered_stage, device_ms,
    merge_inputs, time_ms,
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


def check_modes_fwd(torch, name, dtype_name, args, geo, meta=None, q0=0):
    """The forward with statistics (output and statistics) and with
    dropout against the plain versions (f32 inside) on the same inputs;
    dropout where c_ % 8 == 0 (as the JAX package's, it needs that).
    ``q0``: the token of q's first row (a query range). Returns the
    kernel's (out, stats) of both (None for no dropout), for the
    backwards, and the worst error."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        cluster_attention_forward, cluster_attention_reference,
    )

    plain = [t.float() if t.is_floating_point() else t for t in args]
    saved = cluster_attention_forward(*args, *geo, meta=meta,
                                      want_stats=True, q0=q0)
    ref = cluster_attention_reference(*plain, *geo, want_stats=True, q0=q0)
    torch.cuda.synchronize()
    err = max(check(f"{name}_stats_out", dtype_name, saved[0], ref[0]),
              check_stats(name, dtype_name, geo[0], saved[1], ref[1]))
    dsaved = None
    if (args[0].shape[2] // geo[0]) % 8 == 0:
        dsaved = cluster_attention_forward(*args, *geo, meta=meta, drop=DROP,
                                           want_stats=True, q0=q0)
        dref = cluster_attention_reference(*plain, *geo, drop=DROP, q0=q0)
        torch.cuda.synchronize()
        err = max(err, check(f"{name}_dropout", dtype_name, dsaved[0], dref))
    return saved, dsaved, err


def check_modes_bwd(torch, name, dtype_name, args, g, geo, saved, dsaved,
                    meta=None, q0=0):
    """The saved-stats backward on the forward kernel's own output and
    statistics (``saved``), and under dropout (``dsaved``, the forward's
    with the dropout; None: no dropout check), against the plain saved
    backward in f64 on the same inputs (in batch chunks), every output
    (``..._saved_<output>``, ``..._saved_dropout_<output>``), and against
    the exact gradient (:func:`check_exact`); ``q0`` as for
    :func:`check_modes_fwd`. Returns the worst error."""
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
                               drop=drop, q0=q0)
        got = cluster_attention_backward(*args, g, *geo, meta=meta,
                                         saved=sv, drop=drop, q0=q0)
        torch.cuda.synchronize()
        err = max([err] + [check(f"{name}_{mode}_{o}", dtype_name, x, y)
                           for o, x, y in zip(outs, got, exact)])
        del exact
        err = max(err, check_exact(torch, f"{name}_{mode}", dtype_name, args,
                                   g, geo, got, drop, q0))
    return err


def check_exact(torch, name, dtype_name, args, g, geo, got, drop, q0=0):
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
    exact = plain_backward(torch, args, g, geo, torch.float64, drop=drop,
                           q0=q0)
    out, stats = plain_forward(torch, args, geo, torch.float64, drop=drop,
                               q0=q0)
    emulated = plain_backward(torch, args, g, geo, torch.float64,
                              saved=(out.to(args[0].dtype), stats.float()),
                              drop=drop, q0=q0)
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


def plain_forward(torch, args, geo, dtype, chunk=8, drop=None, q0=0):
    """The plain forward's (out, stats) in ``dtype`` over batch chunks of
    ``chunk`` images, as :func:`plain_backward` goes (``q0``: a query
    range's first token)."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        cluster_attention_reference,
    )

    parts = []
    for s0 in range(0, args[0].shape[0], chunk):
        sl = [(t[s0:s0 + chunk] if i < 4 else t) for i, t in enumerate(args)]
        parts.append(cluster_attention_reference(
            *(t.to(dtype) if t.is_floating_point() else t for t in sl),
            *geo, drop=drop, want_stats=True, img0=s0, q0=q0))
    return tuple(torch.cat([p[i] for p in parts]) for i in range(2))


def plain_backward(torch, args, g, geo, dtype, chunk=8, saved=None,
                   drop=None, q0=0):
    """The plain backward in ``dtype`` over batch chunks of ``chunk``
    images (its gathered (b, h, n, m, c_) tensors of a whole b = 128 batch
    would not fit the card in f64): dq and dkv per image, the parameter
    gradients summed over the chunks. ``saved``: the forward's (out,
    stats); ``drop``: (rate, seed), whose masks hash the image's index in
    the whole batch, so each chunk takes its images' masks apart; ``q0``:
    a query range's first token."""
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
            *sl, cast(g[s0:s0 + chunk]), *geo, q0=q0, **kw))
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


# the launch counters, by kernel (or mode) name: (module of
# ml_autofocusformermod_torch.ops, wrapper, counter attribute); a mode's
# launches are also counted in its kernel's
COUNTERS = {
    "cluster_attention_fwd": ("cluster_attention", "fused_cluster_attention",
                              "launches"),
    "cluster_attention_fwd_stats": ("cluster_attention",
                                    "fused_cluster_attention",
                                    "stats_launches"),
    "cluster_attention_fwd_dropout": ("cluster_attention",
                                      "fused_cluster_attention",
                                      "drop_launches"),
    "cluster_attention_bwd": ("cluster_attention",
                              "cluster_attention_backward", "launches"),
    "cluster_attention_bwd_saved": ("cluster_attention",
                                    "cluster_attention_backward",
                                    "saved_launches"),
    "cluster_attention_bwd_dropout": ("cluster_attention",
                                      "cluster_attention_backward",
                                      "drop_launches"),
    "cluster_merge_fwd": ("cluster_merge", "fused_cluster_merge", "launches"),
    "cluster_merge_bwd": ("cluster_merge", "cluster_merge_backward",
                          "launches"),
    "merge_inverse_index": ("cluster_merge", "merge_inverse_index",
                            "launches"),
    # the attention launches over a proper part of the tokens (sequence
    # parallelism's query ranges)
    "cluster_attention_fwd_range": ("cluster_attention",
                                    "fused_cluster_attention",
                                    "range_launches"),
    "cluster_attention_bwd_range": ("cluster_attention",
                                    "cluster_attention_backward",
                                    "range_launches"),
}


def counters():
    """The launch counters of the kernel wrappers, by kernel (or mode)
    name: (wrapper, counter attribute), from :data:`COUNTERS`."""
    import importlib

    return {k: (getattr(importlib.import_module(
        "ml_autofocusformermod_torch.ops." + m), f), a)
        for k, (m, f, a) in COUNTERS.items()}


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
    return expect_path("aff_mini", fwd_passes, train_steps)


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
    return (launches, train["train_img_s_after_first"],
            train["epochs"][0]["peak_memory_bytes"])


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
    ``<model>_train_attn_drop``), and per model the first epoch's
    images/s after the first step and peak memory, of the preset's run."""
    import os
    import shutil
    import tempfile

    from ml_autofocusformermod_torch.train import curriculum

    by_run, img_s, peak = {}, {}, {}
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
            peak[name] = epochs[0]["peak_memory_bytes"]
    return by_run, img_s, peak


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


# ------------------------------ the single-card switches (TPU.REMAT, ...) --

REMAT = ("blocks", "dots")
# the train state's generators, compared across the remat modes
GENERATORS = ("drop_generator", "attn_drop_generator", "upsample_generator",
              "mix_generator")
# the models of the remat, export, flops and profile phases: name ->
# (preset, attention launches per forward, merge launches per forward)
SWITCH_MODELS = {"aff_mini": ("aff_mini.yaml", 10, 3),
                 "maskfiner_ud_mini": ("maskfiner_up_down_mini.yaml", 16, 0)}
PUBLISHED_AFF_MINI = {"params_m": 6.75, "gmacs": 1.08}  # BASELINE.md:14-15


def expect_path(model, fwd_passes, train_steps=0, remat=False,
                attn_drop=False):
    """The launch counters of ``fwd_passes`` forwards outside training and
    ``train_steps`` train steps of ``model`` (a ``SWITCH_MODELS`` name);
    with ``remat`` every training step runs each attention forward twice
    (the forward and the backward's recompute), each with statistics."""
    _, attn, merges = SWITCH_MODELS[model]
    want = dict.fromkeys(counters(), 0)
    want.update(attention_launches(attn * fwd_passes, attn * train_steps,
                                   attn_drop))
    if remat:
        for k in ("cluster_attention_fwd", "cluster_attention_fwd_stats"):
            want[k] += attn * train_steps
        if attn_drop:
            want["cluster_attention_fwd_dropout"] += attn * train_steps
    want["cluster_merge_fwd"] = merges * (fwd_passes + train_steps)
    want["cluster_merge_bwd"] = merges * train_steps
    want["merge_inverse_index"] = merges * train_steps
    return want


def phase_ops_check(torch):
    """Each op of the ``mlaff`` namespace called as ``torch.ops.mlaff.*``
    on the card (not through the wrappers) at AFF-Mini's stage 2 and
    second merge, b = 8, fp32: the attention forward with statistics and
    dropout, its saved backward under the same dropout, the merge forward
    and backward, the inverse index; each against its plain version on the
    same inputs (the backwards' in f64) within 1e-4 of max|ref| (the index
    exactly), with one launch of its kernel (and its modes) per call."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        cluster_attention_backward_reference, cluster_attention_reference,
        tile_metadata,
    )
    from ml_autofocusformermod_torch.ops.cluster_merge import (
        cluster_merge_backward_reference, cluster_merge_reference,
        merge_inverse_index_reference,
    )

    ops = torch.ops.mlaff
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(9)
    label, n, h, c, _ = ATTN_STAGES[1]
    R = 224 // 4 - 1
    a = attention_inputs(gen, 8, n, h, c, dev, torch.float32)
    args = [a[k] for k in ATTN_ARGS]
    meta = tile_metadata(a["ncc"])
    g = torch.randn(a["q"].shape, generator=gen).to(dev)
    geo = (h, CS, R, 0)
    rate, seed = DROP
    mlabel, mn, mn_, mc = MERGES[1]
    w, feat, sel = merge_inputs(gen, 8, mn, mn_, mc, dev, torch.float32)
    gm = torch.randn(8, mn_, IC, mc, generator=gen).to(dev)

    def f64(ts):
        return [t.double() if t.is_floating_point() and t is not a["pos"]
                else t for t in ts]

    saved = {}

    def attn_fwd():
        out, stats = ops.cluster_attention_fwd(*args, *meta, *geo, rate,
                                               seed, True)
        saved["out"] = (out, stats)
        return (out, stats), cluster_attention_reference(
            *args, *geo, drop=DROP, want_stats=True)

    def attn_bwd():
        got = ops.cluster_attention_bwd(*args, *meta, g, *saved["out"],
                                        *geo, rate, seed)
        dq, dkv, *small = cluster_attention_backward_reference(
            *f64(args), g.double(), *geo, drop=DROP,
            saved=tuple(t.double() for t in saved["out"]))
        # the op's third output: the small parameters' gradients, flat
        return got, (dq, dkv, torch.cat([t.reshape(-1) for t in small]))

    def merge_fwd():
        return (ops.cluster_merge_fwd(w, feat, sel, CS),
                cluster_merge_reference(w, feat, sel, CS))

    def merge_bwd():
        return (ops.cluster_merge_bwd(w, feat, sel, CS, gm),
                cluster_merge_backward_reference(w.double(), feat.double(),
                                                 sel, CS, gm.double()))

    def index():
        return (ops.merge_inverse_index(sel, mn, CS),
                merge_inverse_index_reference(sel, mn, CS))

    cases = [
        ("cluster_attention_fwd", label, attn_fwd,
         ["cluster_attention_fwd", "cluster_attention_fwd_stats",
          "cluster_attention_fwd_dropout"]),
        ("cluster_attention_bwd", label, attn_bwd,
         ["cluster_attention_bwd", "cluster_attention_bwd_saved",
          "cluster_attention_bwd_dropout"]),
        ("cluster_merge_fwd", mlabel, merge_fwd, ["cluster_merge_fwd"]),
        ("cluster_merge_bwd", mlabel, merge_bwd,
         ["cluster_merge_bwd", "merge_inverse_index"]),
        ("merge_inverse_index", mlabel, index, ["merge_inverse_index"]),
    ]
    for op, shape, fn, launched in cases:
        zero_counters()
        got, ref = fn()
        torch.cuda.synchronize()
        launches = read_counters()
        want = {k: int(k in launched) for k in launches}
        if op == "merge_inverse_index":
            err = 0.0 if all(torch.equal(x, y) for x, y in zip(got, ref)) \
                else float("inf")
            tol = 0.0
        else:
            err = max((x.double() - y.double()).abs().max().item()
                      for x, y in zip(got, ref))
            tol = 1e-4 * max(y.double().abs().max().item() for y in ref)
        ok = (err <= tol and launches == want
              and all(bool(x.isfinite().all()) for x in got
                      if x.is_floating_point()))
        emit({"phase": "ops_check", "op": f"mlaff::{op}", "shape": shape,
              "b": 8, "dtype": "float32", "outputs": len(got),
              "max_abs_err": err, "tol": tol, "launches": launches,
              "ok": ok})
        if not ok:
            raise AssertionError(f"mlaff::{op} on the card: err {err} > "
                                 f"{tol} or launches {launches}")


def phase_remat_check(torch):
    """One ``make_train_step`` step of AFF-Mini and of UD-Mini 224 (ratio
    1.0), fp32, b = 2, with Dropout, DropPath and attention dropout all at
    0.1, from equal states, for ``TPU.REMAT`` '' (twice), ``blocks`` and
    ``dots``: the loss equal to the bit across all; each gradient equal to
    the bit where the two '' runs are, else within twice their spread
    (both printed: a few gradients sum with float atomics, the gathers'
    backward); the generators' states after the step equal; the launches
    per step as :func:`expect_path` says (remat: each attention forward
    twice). cuDNN runs its deterministic algorithms meanwhile."""
    import numpy as np

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 224, 224)).astype(
        np.float32)).cuda()
    y = torch.tensor([3, 977]).cuda()
    # cuDNN's conv backwards may pick algorithms that add with atomics,
    # which makes even two plain runs differ in UD-Mini's first level
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _remat_check(torch, x, y)
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _remat_check(torch, x, y):
    from ml_autofocusformermod_torch.models.build import build_model
    from ml_autofocusformermod_torch.models.layers import ClusterAttention
    from ml_autofocusformermod_torch.train.trainer import (
        create_train_state, make_train_step,
    )

    for name, (preset, attn, _) in SWITCH_MODELS.items():
        if name == "aff_mini":
            opts = ["MODEL.DROP_RATE", "0.1", "MODEL.DROP_PATH_RATE", "0.1"]
            ratios = None
        else:
            levels = len(port_config(preset, []).MODEL.MR.NAME)
            opts = ["MODEL.MR.DROP_RATE", str([0.1] * levels),
                    "MODEL.MR.DROP_PATH_RATE", "0.1",
                    "MODEL.MR.ATTN_DROP_RATE", str([0.1] * levels)]
            ratios = RATIO_ONE[preset]

        def one_step(mode):
            cfg = port_config(preset, ["TPU.COMPUTE_DTYPE", "float32", *opts]
                              + (["TPU.REMAT", mode] if mode else []))
            model = build_model(cfg, "cuda", seed=0, upscale_ratios=ratios)
            for mod in model.modules():  # AFF's presets have no such key
                if isinstance(mod, ClusterAttention):
                    mod.attn_drop.p = 0.1
            state, schedule = create_train_state(cfg, model, 10)
            step = make_train_step(cfg, state, schedule)
            zero_counters()
            out = step(x, y)
            torch.cuda.synchronize()
            launches = read_counters()
            grads = {k: p.grad.detach().clone()
                     for k, p in model.named_parameters()
                     if p.grad is not None}
            gens = {k: getattr(state, k).get_state() for k in GENERATORS}
            return out["loss"].item(), grads, gens, launches

        runs = {"": one_step(""), "again": one_step("")}
        runs.update((mode, one_step(mode)) for mode in REMAT)
        base = runs[""]
        spread = {k: (g - runs["again"][1][k]).abs().max().item()
                  for k, g in base[1].items()}
        for mode in REMAT:
            loss, grads, gens, launches = runs[mode]
            errs = {k: (grads[k] - g).abs().max().item()
                    for k, g in base[1].items()}
            worst = max(errs, key=lambda k: errs[k] - 2 * spread[k])
            grads_ok = set(grads) == set(base[1]) and all(
                errs[k] <= 2 * spread[k] for k in errs)
            want = expect_path(name, 0, 1, remat=True, attn_drop=True)
            ok = (loss.hex() == base[0].hex() and grads_ok
                  and all(torch.equal(gens[k], base[2][k]) for k in gens)
                  and launches == want and math.isfinite(loss)
                  and base[3] == expect_path(name, 0, 1, attn_drop=True))
            emit({"phase": "remat_check", "model": name, "remat": mode,
                  "dtype": "float32", "b": 2, "loss": loss,
                  "loss_plain": base[0], "loss_plain_again": runs["again"][0],
                  "grads": len(errs),
                  "grads_bitwise_equal": sum(e == 0 for e in errs.values()),
                  "grads_plain_runs_bitwise_equal": sum(
                      s == 0 for s in spread.values()),
                  "worst_grad": worst, "worst_grad_err": errs[worst],
                  "worst_grad_plain_spread": spread[worst],
                  "generators_equal": all(torch.equal(gens[k], base[2][k])
                                          for k in gens),
                  "launches_per_step": launches,
                  "launches_per_step_plain": base[3], "ok": ok})
            if not ok:
                raise AssertionError(f"{name} TPU.REMAT {mode}: the step "
                                     "differs from the plain one, or the "
                                     "launches")


def phase_remat_train(torch, smi, plain):
    """``main`` training AFF-Mini and UD-Mini 224 (one synthetic epoch of 4
    steps; UD-Mini's curriculum trains it at ratio 1.0) at b = 128 bf16
    with ``--opts TPU.REMAT blocks`` and ``dots``: images/s after the first
    step and the epoch's peak memory, beside the same run without remat
    earlier in this call (``plain``: the ``train`` phase's and the
    ``maskfiner_train`` phase's first epoch). Returns the launches of each
    run by name (``<model>_remat_<mode>``)."""
    import os
    import shutil
    import tempfile

    by_run = {}
    for (name, (preset, _, _)), mode in itertools.product(
            SWITCH_MODELS.items(), REMAT):
        out = tempfile.mkdtemp(prefix="chip_smoke_remat_")
        try:
            result, secs, launches = run_main(torch, [
                "--cfg", preset_path(preset), "--device", "cuda",
                "--data-path", "no_dataset", "--batch-size", "128",
                "--epochs", "1", "--output", out,
                "--opts", "TPU.REMAT", mode])
        finally:
            shutil.rmtree(out, ignore_errors=True)
        train = result["train"]
        epoch = train["epochs"][0]
        # throughput protocol, 4 steps, 512 validation images / 128
        ok = (launches == expect_path(name, 50 + 30 + 4, 4, remat=True)
              and epoch["steps"] == 4 and epoch["skipped_steps"] == 0
              and all(r in (0.0, 1.0) for r in epoch["ratios"] or [1.0])
              and math.isfinite(train["train_loss"]))
        peak, base_peak = epoch["peak_memory_bytes"], plain[name]["peak"]
        emit({"phase": "remat_train", "model": name, "remat": mode,
              "batch": 128, "dtype": "bfloat16", "steps": epoch["steps"],
              "ratios": epoch["ratios"],
              "img_per_s_after_first": epoch["img_s_after_first"],
              "plain_img_per_s_after_first": plain[name]["img_s"],
              "peak_memory_bytes": peak, "plain_peak_memory_bytes": base_peak,
              "peak_memory_ratio": peak / base_peak,
              "step_seconds": epoch["step_seconds"],
              "train_loss": train["train_loss"], "card": smi,
              "seconds": secs, "launches": launches, "ok": ok})
        if not ok:
            raise AssertionError(f"{name} TPU.REMAT {mode} training run: "
                                 f"launches {launches}")
        by_run[f"{name}_remat_{mode}"] = launches
    return by_run


EXPORT_CHILD = r"""
import importlib, json, sys, time
import torch
from ml_autofocusformermod_torch.ckpt.export import load_exported
table, runs = json.loads(sys.argv[1])
counters = {k: (getattr(importlib.import_module(
    "ml_autofocusformermod_torch.ops." + m), f), a)
    for k, (m, f, a) in table.items()}
out = {}
for name, path, inputs, logits in runs:
    d = torch.load(inputs, map_location="cuda")
    t0 = time.perf_counter()
    fn = load_exported(path)
    load_s = time.perf_counter() - t0
    for f, a in counters.values():
        setattr(f, a, 0)
    y = fn(d["state"], d["x"])
    torch.cuda.synchronize()
    launches = {k: getattr(f, a) for k, (f, a) in counters.items()}
    torch.save(y.cpu(), logits)
    out[name] = {"load_seconds": load_s, "launches": launches}
models = sorted(m for m in sys.modules
                if m.startswith("ml_autofocusformermod_torch.models"))
print(json.dumps({"runs": out, "models_imported": models}))
"""


def phase_export(torch):
    """AFF-Mini and UD-Mini 224 at b = 128 bf16: ``export_forward`` on the
    card (after the eager forward it runs to fill the caches), saved, then
    loaded in a fresh process that imports no model code and called with
    the model's state dict on the same images. Its logits must equal the
    eager model's (max abs difference printed), and its launches an eager
    forward's (AFF-Mini 10 attention + 3 merge, UD-Mini 16 attention).
    Prints the export's seconds and the artifact's bytes. Returns the
    child's launches by name (``<model>_export``)."""
    import os
    import shutil
    import tempfile

    from ml_autofocusformermod_torch.ckpt.export import (
        export_forward, save_exported,
    )
    from ml_autofocusformermod_torch.models.build import build_model

    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    try:
        gen = torch.Generator().manual_seed(11)
        runs, eager, info = [], {}, {}
        for name, (preset, _, _) in SWITCH_MODELS.items():
            model = build_model(port_config(preset, []), "cuda", seed=0)
            x = torch.randn(128, 3, 224, 224, generator=gen).cuda()
            t0 = time.perf_counter()
            data = export_forward(model, 128, 224)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            zero_counters()
            with torch.no_grad():
                eager[name] = model(x).float().cpu()
            launches = read_counters()
            path = os.path.join(tmp, f"{name}.pt2")
            save_exported(path, data)
            inputs = os.path.join(tmp, f"{name}_in.pt")
            torch.save({"state": model.state_dict(), "x": x}, inputs)
            runs.append((name, path, inputs,
                         os.path.join(tmp, f"{name}_out.pt")))
            info[name] = {"export_seconds": secs, "bytes": len(data),
                          "eager_launches": launches}
            del model, data
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", EXPORT_CHILD,
             json.dumps([COUNTERS, runs])],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True, text=True, timeout=600)
        child_secs = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError("loading the exported programs failed:\n"
                                 + proc.stderr[-4000:])
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        by_run = {}
        for name, _, _, logits in runs:
            got = torch.load(logits)
            err = (got.float() - eager[name]).abs().max().item()
            launches = child["runs"][name]["launches"]
            want = expect_path(name, 1)
            ok = (err == 0.0 and launches == want
                  and info[name]["eager_launches"] == want
                  and not child["models_imported"]
                  and tuple(got.shape) == (128, 1000))
            emit({"phase": "export", "model": name, "batch": 128,
                  "dtype": "bfloat16", **info[name],
                  "load_seconds": child["runs"][name]["load_seconds"],
                  "child_seconds": child_secs,
                  "max_abs_diff_vs_eager": err, "launches": launches,
                  "models_imported_by_loader": child["models_imported"],
                  "ok": ok})
            if not ok:
                raise AssertionError(f"{name} exported forward: diff {err},"
                                     f" launches {launches}")
            by_run[f"{name}_export"] = launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return by_run


def phase_flops(torch, smi):
    """``main --throughput --opts PRINT_FLOPS True`` for AFF-Mini and
    UD-Mini 224 (b = 128 bf16): GFLOPs per image (FlopCounterMode, two
    per multiply-add, the fused kernels through their formulas) and the
    parameters; for AFF-Mini beside the published 6.75 M parameters and
    1.08 G ptflops MACs (``BASELINE.md``), which count one per
    multiply-add and miss the attention, a custom op ptflops cannot see."""
    for name, (preset, _, _) in SWITCH_MODELS.items():
        result, secs, launches = run_main(torch, [
            "--cfg", preset_path(preset), "--device", "cuda",
            "--data-path", "no_dataset", "--throughput",
            "--batch-size", "128", "--opts", "PRINT_FLOPS", "True"])
        cost = result["complexity"]
        # the count's own forward (b = 1), then the throughput protocol
        ok = (launches == expect_path(name, 1 + 50 + 30)
              and cost["flops"] > 0 and math.isfinite(cost["peak_bytes"]))
        line = {"phase": "flops", "model": name,
                "gflops_per_image": cost["flops"] / 1e9,
                "gmacs_per_image": cost["flops"] / 2e9,
                "params": cost["params"],
                "fwd_b1_peak_bytes": cost["peak_bytes"],
                "img_per_s": result["throughput_img_s"], "card": smi,
                "seconds": secs, "launches": launches, "ok": ok}
        if name == "aff_mini":
            line.update(published_params_m=PUBLISHED_AFF_MINI["params_m"],
                        published_gmacs_ptflops=PUBLISHED_AFF_MINI["gmacs"],
                        relation="FlopCounterMode counts 2 per MAC and sees "
                        "the attention op and the geometry's products; "
                        "ptflops counts 1 per MAC of nn modules only")
            ok = ok and round(cost["params"] / 1e6, 2) == 6.75
            line["ok"] = ok
        emit(line)
        if not ok:
            raise AssertionError(f"{name} PRINT_FLOPS run: {cost}, "
                                 f"launches {launches}")


# the CUDA kernels by name in a trace, and the counter each matches
TRACE_KERNELS = {"cluster_attention_fwd_kernel": "cluster_attention_fwd",
                 "cluster_attention_bwd_saved_kernel":
                     "cluster_attention_bwd_saved",
                 "cluster_merge_fwd_": "cluster_merge_fwd",
                 "cluster_merge_bwd_": "cluster_merge_bwd",
                 "merge_index_kernel": "merge_inverse_index"}


def phase_profile(torch, smi):
    """``main --profile DIR`` on AFF-Mini 224 b = 128 bf16, one synthetic
    epoch of 4 steps, the window steps [1, 3): the trace must hold exactly
    2 ``train_step`` spans, and each fused kernel by its CUDA name as often
    as its launch counter counts over 2 steps. Returns the run's
    launches."""
    import os
    import shutil
    import tempfile

    from ml_autofocusformermod_torch.utils.profiling import STEP_SPAN

    out = tempfile.mkdtemp(prefix="chip_smoke_profile_")
    try:
        result, secs, launches = run_main(torch, [
            "--cfg", preset_path("aff_mini.yaml"), "--device", "cuda",
            "--data-path", "no_dataset", "--batch-size", "128",
            "--epochs", "1", "--output", os.path.join(out, "run"),
            "--profile", os.path.join(out, "trace"),
            "--opts", "PROFILE_START", "1", "PROFILE_STEPS", "2"])
        path = result["train"]["profile"]
        size = os.path.getsize(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    # the host's spans (the card's copies of them are "gpu_user_annotation")
    spans = sum(e.get("name") == STEP_SPAN and e.get("ph") == "X"
                and e.get("cat") == "user_annotation" for e in events)
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    per_step = expect_path("aff_mini", 0, 1)
    found = {sub: sum(sub in k for k in kernels) for sub in TRACE_KERNELS}
    want = {sub: 2 * per_step[c] for sub, c in TRACE_KERNELS.items()}
    ok = (spans == 2 and found == want
          and launches == expect_path("aff_mini", 50 + 30 + 4, 4))
    emit({"phase": "profile", "model": "aff_mini", "batch": 128,
          "dtype": "bfloat16", "window_steps": 2, "step_spans": spans,
          "kernels_in_trace": found, "kernels_from_counters": want,
          "kernel_events": len(kernels), "trace_bytes": size, "card": smi,
          "seconds": secs, "launches": launches, "ok": ok})
    if not ok:
        raise AssertionError(f"profile run: {spans} spans, kernels {found} "
                             f"against {want}")
    return launches


# --------------------------------- data and tensor parallelism, ZeRO-1 ----

# (name, data, model, ZeRO-1) of the two-rank layouts on the one card
PARALLEL_LAYOUTS = (("dp2", 2, 1, False), ("dp2_zero1", 2, 1, True),
                    ("tp2", 1, 2, False))
PARALLEL_MODELS = {"aff_mini": "aff_mini.yaml",
                   "maskfiner_ud_mini": "maskfiner_up_down_mini.yaml"}

PARALLEL_RANK = r"""
import json, os, sys
import torch
import chip_smoke as cs
from ml_autofocusformermod_torch.ckpt import io as ckpt_io
from ml_autofocusformermod_torch.models.build import build_model
from ml_autofocusformermod_torch.parallel import mesh as mesh_lib
from ml_autofocusformermod_torch.parallel.zero import make_layout
from ml_autofocusformermod_torch.time_kernels import RATIO_ONE
from ml_autofocusformermod_torch.train.trainer import (
    create_train_state, make_train_step)
spec = json.loads(sys.argv[1])
torch.backends.cudnn.allow_tf32 = False  # the convs, as in train_check
torch.cuda.set_device(0)
rank, world, _ = mesh_lib.init_distributed("cuda:0", "gloo", spec["init"])
x, y = torch.load(spec["batch"])
try:
    for name, preset, data, model_size, zero1, seq, opts in spec["cases"]:
        cfg = cs.port_config(preset, ["TPU.COMPUTE_DTYPE", "float32", *opts])
        mesh = mesh_lib.make_mesh(data, model_size, seq)
        model = build_model(cfg, "cuda:0", seed=0,
                            upscale_ratios=RATIO_ONE.get(preset))
        layout = make_layout(model, mesh, zero1)
        state, schedule = create_train_state(cfg, model, 10, layout=layout)
        step = make_train_step(cfg, state, schedule)
        b = x.shape[0] // mesh.data
        rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
        xs, ys = x[rows].cuda(), y[rows].cuda()
        cs.zero_counters()
        metrics = [step(xs, ys) for _ in range(2)]
        torch.cuda.synchronize()
        launches = cs.read_counters()
        full = {k: tuple(ckpt_io.full_tensor(k, t, layout, False).float()
                         .cpu() for t in (p.grad, p.detach()))
                for k, p in model.named_parameters()}
        moments = sum(t.numel() * t.element_size() for m in ("mu", "nu")
                      for t in state.optimizer.state[m].values())
        if rank == 0:
            torch.save(full, os.path.join(spec["out"], name + ".pt"))
        print(json.dumps({"rank": rank, "case": name, "launches": launches,
                          "loss": [m["loss"].item() for m in metrics],
                          "grad_norm": [m["grad_norm"].item()
                                        for m in metrics],
                          "moment_bytes": moments}), flush=True)
finally:
    mesh_lib.destroy()
"""


def run_ranks(code_or_argv, world, env_extra=None, timeout=900):
    """Start ``world`` ranks (``python -c code`` with its arguments, or an
    argv) with torchrun's environment, all on the one card, and wait for
    them; each rank's stdout. A rank that fails fails the phase."""
    import os

    argv = ([sys.executable, "-c", *code_or_argv]
            if isinstance(code_or_argv, tuple) else code_or_argv)
    procs = [subprocess.Popen(
        argv, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env={**os.environ, "RANK": str(r), "WORLD_SIZE": str(world),
             "LOCAL_RANK": "0", **(env_extra or {})}) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode:
            raise AssertionError(f"rank {r} exit {p.returncode}:\n"
                                 f"{out[-6000:]}")
    return outs


def json_lines(text):
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith("{")]


def phase_parallel_kernels(torch):
    """The attention kernels at AFF-Mini's tensor-parallel shapes (model
    size 2: each rank's h/2 heads and c/2 channels, stages 1-3, b = 128
    bf16): the forward, with statistics, and the saved backward against
    their plain versions (the limits of kernel_check, the backward against
    the plain backward in f64 and the exact gradient), with times. Returns
    the rows by kernel."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        cluster_attention_backward, cluster_attention_backward_reference,
        cluster_attention_forward, cluster_attention_reference,
        tile_metadata,
    )

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(21)
    R = 224 // 4 - 1
    rows = {"cluster_attention_fwd": [], "cluster_attention_bwd": []}
    for label, n, h, c, per in ATTN_STAGES:
        h, c = h // 2, c // 2
        a = attention_inputs(gen, 128, n, h, c, dev, torch.bfloat16)
        g = torch.randn(128, n, c, generator=gen).to(dev, torch.bfloat16)
        args = [a[k] for k in ATTN_ARGS]
        meta = tile_metadata(a["ncc"])
        geo = (h, CS, R, 0)
        tag = f"attention_tp2_{label}_b128"
        saved, _, err_f = check_modes_fwd(torch, tag, "bfloat16", args, geo,
                                          meta)
        err_b = check_modes_bwd(torch, tag, "bfloat16", args, g, geo, saved,
                                None, meta)
        base = dict(shape=label + "_tp2", b=128, n=n, heads=h, c=c,
                    per_pass=per)
        moved, flops = attn_work(torch, a, h, CS)
        rows["cluster_attention_fwd"].append(timed_row(
            torch, base,
            lambda: cluster_attention_forward(*args, *geo, meta=meta,
                                              want_stats=True),
            lambda: cluster_attention_reference(*args, *geo,
                                                want_stats=True),
            (moved + 128 * n * 2 * h * 4, flops), err_f, mode="stats"))
        moved, flops = attn_bwd_work(torch, a, g, h, CS)
        rows["cluster_attention_bwd"].append(timed_row(
            torch, base,
            lambda: cluster_attention_backward(*args, g, *geo, meta=meta,
                                               saved=saved),
            lambda: cluster_attention_backward_reference(*args, g, *geo,
                                                         saved=saved),
            (moved + nbytes(*saved), flops), err_b, mode="saved"))
        for kernel, rs in rows.items():
            emit({"phase": "kernel_time", "kernel": kernel, "tp": 2,
                  **rs[-1]})
    return rows


# sequence parallelism's query ranges at seq 2: (label, n, heads, c,
# cluster size, nnc, rel width, clamp, canvas, per pass). AFF-Mini's
# stages take their own geometry (canvas None); UD-Mini's finest level at
# the curriculum's final ratios (n = 1921) and at ratio 1.0 (4165), its
# widths (h 2, c 64) and MixRes clamp, on clustered cells of a 96 x 96
# canvas.
SEQ_SHAPES = [(label, n, h, c, CS, NNC, 224 // 4 - 1, 0, None, per)
              for label, n, h, c, per in ATTN_STAGES] + [
    ("ud_n1921", 1921, 2, 64, 8, 6, 511, 1023, 96, 1),
    ("ud_n4165", 4165, 2, 64, 8, 6, 511, 1023, 96, 1)]


def seq_inputs(torch, gen, shape, b, dev, dtype):
    """The attention inputs of one ``SEQ_SHAPES`` entry, by name."""
    _, n, h, c, cs, nnc, _, _, canvas, _ = shape
    geometry = (None if canvas is None
                else clustered_stage(gen, b, n, canvas, dev, cs, nnc))
    return attention_inputs(gen, b, n, h, c, dev, dtype, geometry)


def range_work(torch, a, lo, hi, h, cs, bwd=False):
    """(bytes, flops) of one attention call over the queries ``[lo, hi)``
    of ``a`` (``bwd``: its saved backward), each byte counted once: the
    range's rows of q, ncc, the output and the statistics, the kv rows of
    the clusters the range reads (``union_rows``), the positions of the
    range's queries and of those kv rows, and the small parameters; the
    backward also reads g, the output and the statistics and writes dq and
    dkv of every token. Flops as :func:`attn_work` and
    :func:`attn_bwd_work` count them, over the range's slots."""
    from ml_autofocusformermod_torch.ops.cluster_gather import (
        cluster_token_index,
    )

    q, ncc, pos = a["q"], a["ncc"], a["pos"]
    b, n, c = q.shape
    c_, nq, es = c // h, hi - lo, q.element_size()
    part = ncc[:, lo:hi]
    valid = (cluster_token_index(part, cs) < n).sum().item()
    images = 1 if ncc.stride(0) == 0 else b

    def kv_read(nc):  # one image's range: the tokens whose k/v it reads
        ids = torch.unique(nc).long()
        tok = (ids[:, None] * cs
               + torch.arange(cs, device=ids.device)).flatten()
        read = torch.zeros(n, dtype=torch.bool, device=nc.device)
        read[tok[tok < n]] = True
        return read

    kv = torch.stack([kv_read(part[i]) for i in range(images)])
    union_rows = int(kv.sum().item()) * (b // images)
    at = kv.clone()  # the positions read: the kv rows' and the queries'
    at[:, lo:hi] = True
    if pos.stride(0) == 0:  # one image's positions, shared by the batch
        pos_rows = int(at.any(0).sum().item())
    else:
        pos_rows = int(at.sum().item()) * (b // images)
    small = nbytes(*(a[k] for k in ("pe_kernel", "pe_bias", "blank_k",
                                    "blank_v")))
    rows = b * nq * c * es  # q, the output, g or dq: one range's rows
    stats = b * nq * 2 * h * 4
    moved = (rows + union_rows * 2 * c * es + nbytes(part)
             + pos_rows * pos.shape[-1] * pos.element_size()
             + small + rows + stats)
    if not bwd:
        return moved, valid * h * (4 * c_ + 12) + b * nq * h * 4 * c_
    moved += 2 * rows + b * n * 2 * c * es + small  # g, dq, dkv, d_params
    return moved, valid * h * (10 * c_ + 24) + b * nq * h * 8 * c_


def phase_seq_kernels(torch):
    """The attention kernels over sequence parallelism's query ranges at
    seq 2 (``SEQ_SHAPES``, b = 128 bf16): each rank's half of the tokens
    (``q0`` = 0, and ``q0`` = the first half's size) against every
    token's k and v, the forward with statistics and with dropout and the
    saved backward with and without dropout (every output, also against
    the exact gradient) against their plain versions over the same range
    (kernel_check's limits), with times beside each range's bound
    (``range_work``). A range of every token (``q0`` = 0, ``nq`` = n) is
    the plain launch's, bit for bit (``seq_full_range`` lines). Returns
    the rows by kernel: ``cluster_attention_fwd`` the forward with
    statistics, ``cluster_attention_bwd`` the saved backward, as training
    calls them."""
    from ml_autofocusformermod_torch.ops.cluster_attention import (
        cluster_attention_backward, cluster_attention_forward,
        cluster_attention_reference, tile_metadata,
    )
    from ml_autofocusformermod_torch.parallel.mesh import token_range

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(31)
    rows = {"cluster_attention_fwd": [], "cluster_attention_bwd": []}
    for shape in SEQ_SHAPES:
        label, n, h, c, cs, _, R, clamp, _, per = shape
        a = seq_inputs(torch, gen, shape, 128, dev, torch.bfloat16)
        g = torch.randn(128, n, c, generator=gen).to(dev, torch.bfloat16)
        args = [a[k] for k in ATTN_ARGS]
        geo = (h, cs, R, clamp)
        meta = tile_metadata(a["ncc"])
        whole = cluster_attention_forward(*args, *geo, meta=meta,
                                          want_stats=True)
        ranged = cluster_attention_forward(*args, *geo, meta=meta,
                                           want_stats=True, q0=0)
        dwhole = cluster_attention_backward(*args, g, *geo, meta=meta,
                                            saved=whole)
        dranged = cluster_attention_backward(*args, g, *geo, meta=meta,
                                             saved=ranged, q0=0)
        torch.cuda.synchronize()
        same = (all(torch.equal(x, y) for x, y in zip(whole, ranged))
                and all(torch.equal(x, y) for x, y in zip(dwhole, dranged)))
        emit({"phase": "seq_full_range", "shape": label, "n": n,
              "bitwise_equal": same, "ok": same})
        if not same:
            raise AssertionError(f"seq_full_range {label}")
        del whole, ranged, dwhole, dranged
        for seq_rank in (0, 1):
            lo, hi = token_range(n, 2, seq_rank)
            rargs = [a["q"][:, lo:hi].contiguous(), a["kv"],
                     a["ncc"][:, lo:hi], a["pos"], *args[4:]]
            gr = g[:, lo:hi].contiguous()
            rmeta = tile_metadata(rargs[2])
            tag = f"attention_seq2_{label}_q{lo}_b128"
            saved, dsaved, err_f = check_modes_fwd(
                torch, tag, "bfloat16", rargs, geo, rmeta, q0=lo)
            err_b = check_modes_bwd(torch, tag, "bfloat16", rargs, gr, geo,
                                    saved, dsaved, rmeta, q0=lo)
            base = dict(shape=f"{label}_seq2_q{lo}", b=128, n=n, nq=hi - lo,
                        q0=lo, heads=h, c=c, clamp_width=clamp,
                        per_pass=per, seq_rank=seq_rank)
            rows["cluster_attention_fwd"].append(timed_row(
                torch, base,
                lambda: cluster_attention_forward(*rargs, *geo, meta=rmeta,
                                                  want_stats=True, q0=lo),
                lambda: cluster_attention_reference(*rargs, *geo,
                                                    want_stats=True, q0=lo),
                range_work(torch, a, lo, hi, h, cs), err_f, mode="stats"))
            rows["cluster_attention_bwd"].append(timed_row(
                torch, base,
                lambda: cluster_attention_backward(*rargs, gr, *geo,
                                                   meta=rmeta, saved=saved,
                                                   q0=lo),
                lambda: plain_backward(torch, rargs, gr, geo, torch.float32,
                                       chunk=32, saved=saved, q0=lo),
                range_work(torch, a, lo, hi, h, cs, bwd=True), err_b,
                mode="saved"))
            for kernel, rs in rows.items():
                emit({"phase": "kernel_time", "kernel": kernel, "seq": 2,
                      **rs[-1]})
            del saved, dsaved
    return rows


def phase_parallel_check(torch, smi):
    """Two ranks on the one card through gloo (``PARALLEL_RANK``): AFF-Mini
    and UD-Mini 224 (ratio 1.0) fp32, b = 2 per rank, two train steps at
    data 2, data 2 + ZeRO-1 and model 2, against the one-process steps of
    the global batch (b = 4) on the same card from the same weights (see
    :func:`compare_ranks`; loss and grad_norm within 1e-4 relative);
    UD-Mini also at data 2 with ``ATTN_DROP_RATE`` 0.1 on every level
    (each data rank's kernels hash the global image: its seed is offset by
    the rank's first image). Returns the launches by run
    (``<model>[_attn_drop]_<layout>_rank<r>``)."""
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(4, 3, 224, 224, generator=gen)
    y = torch.tensor([3, 977, 10, 500])
    layouts = [(lay, d, m, z, 1) for lay, d, m, z in PARALLEL_LAYOUTS]
    # at 224 every MixResNeighbour level attends locally: all of this
    # dropout is the kernels' hash, none the per-data-rank Dropout stream
    drop = ["MODEL.MR.ATTN_DROP_RATE", json.dumps([0.1] * 7)]
    return compare_ranks(torch, smi, "parallel_check", x, y, [
        *((model, preset, "", [], layouts)
          for model, preset in PARALLEL_MODELS.items()),
        ("maskfiner_ud_mini", PARALLEL_MODELS["maskfiner_ud_mini"],
         "attn_drop", drop, layouts[:1])], 1e-4)


def phase_parallel_seq_check(torch, smi):
    """Two ranks on the one card through gloo at seq 2 (each rank half of
    every stage's tokens, both the same two images): AFF-Mini and UD-Mini
    224 (ratio 1.0) fp32, b = 2, two train steps against the one-process
    steps on the same card from the same weights: loss and grad_norm
    within 1e-5 relative, gradients and parameters as
    :func:`compare_ranks` holds them; UD-Mini also with ``ATTN_DROP_RATE``
    0.1 on every level (the kernels hash each query's global row). Every
    attention launch of the ranks is a range (``..._range`` counters).
    Returns the launches by run (``<model>[_attn_drop]_seq2_rank<r>``)."""
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(2, 3, 224, 224, generator=gen)
    y = torch.tensor([3, 977])
    seq2 = [("seq2", 1, 1, False, 2)]
    drop = ["MODEL.MR.ATTN_DROP_RATE", json.dumps([0.1] * 7)]
    return compare_ranks(torch, smi, "parallel_seq_check", x, y, [
        ("aff_mini", "aff_mini.yaml", "", [], seq2),
        ("maskfiner_ud_mini", "maskfiner_up_down_mini.yaml", "", [], seq2),
        ("maskfiner_ud_mini", "maskfiner_up_down_mini.yaml", "attn_drop",
         drop, seq2)], 1e-5)


def compare_ranks(torch, smi, phase, x, y, runs, rel):
    """Two ranks on the one card through gloo (``PARALLEL_RANK``) take two
    train steps of the global batch ``x, y`` (each data rank its rows) for
    each ``(model, preset, variant, opts, layouts)`` of ``runs``, every
    layout ``(name, data, model, ZeRO-1, seq)``, fp32; the one-process
    steps of the whole batch on the same card from the same weights are
    the reference: loss and grad_norm within ``rel`` relative, every
    gradient (of the second step) and parameter within 1e-3 of its
    tensor's largest entry (floored at 1e-5 of the gradient norm, as
    train_check). A gradient below that floor in the one-process step is
    zero in exact arithmetic and round-off in both runs: it is held within
    the floor, and its parameter within AdamW's largest move over the two
    steps (twice the sum of the learning rates). Each rank's launches:
    every kernel of the model's path launched (at seq > 1 every attention
    launch a range). A line per run of ``phase``; returns the launches by
    run (``<model>[_<variant>]_<layout>_rank<r>``)."""
    import os
    import shutil
    import tempfile

    from ml_autofocusformermod_torch.models.build import build_model
    from ml_autofocusformermod_torch.train.trainer import (
        create_train_state, make_train_step,
    )

    def run_name(model, variant, lay):
        return "_".join(p for p in (model, variant, lay) if p)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_parallel_")
    by_run = {}
    try:
        torch.save((x, y), os.path.join(tmp, "batch.pt"))
        cases = [(run_name(m, v, lay), preset, d, mo, z, sq, opts)
                 for m, preset, v, opts, layouts in runs
                 for lay, d, mo, z, sq in layouts]
        spec = {"init": f"tcp://localhost:{free_ports(1)[0]}",
                "cases": cases,
                "batch": os.path.join(tmp, "batch.pt"), "out": tmp}
        t0 = time.perf_counter()
        outs = run_ranks((PARALLEL_RANK, json.dumps(spec)), 2)
        ranks_s = time.perf_counter() - t0
        lines = {(ln["case"], ln["rank"]): ln
                 for out in outs for ln in json_lines(out)}
        tf32 = torch.backends.cudnn.allow_tf32
        torch.backends.cudnn.allow_tf32 = False
        try:
            for model_name, preset, variant, opts, layouts in runs:
                cfg = port_config(preset, ["TPU.COMPUTE_DTYPE", "float32",
                                           *opts])
                model = build_model(cfg, "cuda", seed=0,
                                    upscale_ratios=RATIO_ONE.get(preset))
                state, schedule = create_train_state(cfg, model, 10)
                step = make_train_step(cfg, state, schedule)
                ref = [step(x.cuda(), y.cuda()) for _ in range(2)]
                ref_loss = [m["loss"].item() for m in ref]
                ref_gn = [m["grad_norm"].item() for m in ref]
                floor = 1e-5 * ref_gn[-1]
                ref_full = {k: (p.grad.float().cpu(),
                                p.detach().float().cpu())
                            for k, p in model.named_parameters()}
                # gradients below the floor are zero in exact arithmetic
                # (a conv bias ahead of a batch-statistics BatchNorm): their
                # values are the summation order's round-off, and AdamW's
                # normalised step turns that into moves of up to lr
                noise = sorted(k for k, (g, _) in ref_full.items()
                               if g.abs().max().item() < floor)
                step_bound = 2 * sum(m["lr"] for m in ref)
                del model, state, step, ref
                for lay, data, model_size, zero1, seq in layouts:
                    name = run_name(model_name, variant, lay)
                    full = torch.load(os.path.join(tmp, name + ".pt"))
                    worst = {"grad": (0.0, ""), "param": (0.0, "")}
                    noise_ok = True
                    for k, (g, p) in ref_full.items():
                        if k in noise:
                            noise_ok &= (
                                (full[k][0] - g).abs().max().item() <= floor
                                and (full[k][1] - p).abs().max().item()
                                <= step_bound)
                            continue
                        for part, a, b in (("grad", full[k][0], g),
                                           ("param", full[k][1], p)):
                            err = ((a - b).abs().max().item()
                                   / max(b.abs().max().item(), floor))
                            worst[part] = max(worst[part], (err, k))
                    per_rank = [lines[(name, r)] for r in (0, 1)]
                    want = expect_path(
                        "aff_mini" if model_name == "aff_mini"
                        else "maskfiner_ud_mini", 0, 1,
                        attn_drop=variant == "attn_drop")
                    path = [k for k, v in want.items() if v]
                    if seq > 1:
                        path += ["cluster_attention_fwd_range",
                                 "cluster_attention_bwd_range"]
                    launched = all(r["launches"][k] > 0 for r in per_rank
                                   for k in path)
                    ranged = seq == 1 or all(
                        r["launches"][f"cluster_attention_{d}_range"]
                        == r["launches"][f"cluster_attention_{d}"]
                        for r in per_rank for d in ("fwd", "bwd"))
                    ok = (launched and ranged and noise_ok
                          and all(abs(a - b) <= rel * abs(b)
                                  for r in per_rank
                                  for a, b in zip(r["loss"], ref_loss))
                          and all(abs(a - b) <= rel * abs(b)
                                  for r in per_rank
                                  for a, b in zip(r["grad_norm"], ref_gn))
                          and worst["grad"][0] <= 1e-3
                          and worst["param"][0] <= 1e-3)
                    emit({"phase": phase, "model": model_name,
                          **({"variant": variant} if variant else {}),
                          "layout": lay, "data": data, "model_axis":
                          model_size, "seq": seq, "zero1": zero1,
                          "dtype": "float32",
                          "b_per_rank": x.shape[0] // data,
                          "backend": "gloo",
                          "loss": per_rank[0]["loss"], "loss_one": ref_loss,
                          "grad_norm": per_rank[0]["grad_norm"],
                          "grad_norm_one": ref_gn, "rel_limit": rel,
                          "worst_grad_rel_err": worst["grad"],
                          "worst_param_rel_err": worst["param"],
                          "grads_at_floor": noise,
                          "grads_at_floor_ok": noise_ok,
                          "moment_bytes_per_rank": [
                              r["moment_bytes"] for r in per_rank],
                          "launches_per_rank": [r["launches"]
                                                for r in per_rank],
                          "card": smi, "ok": ok})
                    if not ok:
                        raise AssertionError(f"{phase} {name}")
                    for r in (0, 1):
                        by_run[f"{name}_rank{r}"] = per_rank[r]["launches"]
        finally:
            torch.backends.cudnn.allow_tf32 = tf32
        emit({"phase": phase + "_ranks", "seconds": ranks_s})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return by_run


PARALLEL_MAIN = r"""
import functools, gc, json, sys
import torch
import chip_smoke as cs
from ml_autofocusformermod_torch import main as port_main
from ml_autofocusformermod_torch.train.trainer import throughput
if sys.argv[2:] == ["short"]:  # one warmup and one timed forward
    port_main.throughput = functools.partial(throughput, warmup=1, iters=1)
for argv in json.loads(sys.argv[1]):
    gc.collect()  # the last run's state, so that its memory is free
    cs.zero_counters()
    result = port_main.main(argv)
    torch.cuda.synchronize()
    print(json.dumps({"launches": cs.read_counters(), "run": result}),
          flush=True)
"""


def free_ports(n: int) -> list:
    """``n`` distinct free ports on localhost."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("localhost", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def main_runs(outs):
    """The ``PARALLEL_MAIN`` lines of each rank's output, in run order."""
    return [[d for d in json_lines(o) if "run" in d] for o in outs]


def phase_parallel_train(torch, smi):
    """``main`` on two ranks sharing the one card (gloo, ``--device
    cuda:0``), the runs one after another in the same two processes:
    AFF-Mini and UD-Mini 224, b = 64 per rank, bf16, two synthetic epochs
    of two steps, with and without ``TPU.ZERO1``, the collectives timed
    (``MLAFF_COMM_TIMING=1``). Per run the img/s after the first step per
    rank and summed, peak memory per rank and the ms per step in
    collectives: gloo through the host on one shared card, which says
    nothing of scaling. Then a world of one under torchrun's environment
    with NCCL (``env://``), AFF-Mini, one epoch: the launch path of a
    multi-card host. Returns the launches by run and the AFF-Mini ZeRO-1
    run's output directory, checkpoint and val loss (the directory is the
    caller's to remove)."""
    import os
    import shutil
    import tempfile

    runs = list(itertools.product(PARALLEL_MODELS.items(), (False, True)))
    outs = [tempfile.mkdtemp(prefix="chip_smoke_parallel_train_")
            for _ in runs]
    argvs = [["--cfg", preset_path(preset), "--device", "cuda:0",
              "--dist-backend", "gloo", "--dist-url",
              f"tcp://localhost:{port}", "--data-path", "no_dataset",
              "--batch-size", "64", "--epochs", "2", "--output", out,
              "--opts", "TPU.ZERO1", str(zero1)]
             for ((_, preset), zero1), out, port in zip(
                 runs, outs, free_ports(len(runs)))]
    t0 = time.perf_counter()
    per_rank = main_runs(run_ranks((PARALLEL_MAIN, json.dumps(argvs)), 2,
                                   {"MLAFF_COMM_TIMING": "1"}))
    secs = time.perf_counter() - t0
    by_run, kept = {}, None
    for i, ((model_name, _), zero1) in enumerate(runs):
        ranks = [lines[i] for lines in per_rank]
        trains = [r["run"]["train"] for r in ranks]
        steps = [sum(e["steps"] for e in t["epochs"]) for t in trains]
        want = expect_path(model_name, 50 + 30 + 2 * 2, 4)
        ok = (steps == [4, 4] and all(r["launches"] == want for r in ranks)
              and all(t["skipped_steps"] == 0 for t in trains)
              and trains[0]["train_loss"] == trains[1]["train_loss"]
              and trains[0]["val_loss"] == trains[1]["val_loss"]
              and all(math.isfinite(t["val_loss"]) for t in trains))
        img_s = [t["epochs"][-1]["img_s_after_first"] for t in trains]
        emit({"phase": "parallel_train", "model": model_name,
              "zero1": zero1, "ranks": 2, "backend": "gloo",
              "device": "one card, two processes", "b_per_rank": 64,
              "dtype": "bfloat16", "steps_per_rank": steps,
              "img_per_s_after_first_per_rank": img_s,
              "img_per_s_after_first_summed": sum(img_s),
              "throughput_img_s_per_rank": [
                  r["run"]["throughput_img_s"] for r in ranks],
              "peak_memory_bytes_per_rank": [
                  t["epochs"][-1]["peak_memory_bytes"] for t in trains],
              "collective_ms_per_step_per_rank": [
                  1e3 * t["epochs"][-1]["collective_seconds"]
                  / t["epochs"][-1]["steps"] for t in trains],
              "collective_calls_per_step": [
                  t["epochs"][-1]["collective_calls"]
                  / t["epochs"][-1]["steps"] for t in trains],
              "train_loss": trains[0]["train_loss"],
              "val_loss": trains[0]["val_loss"],
              "launches_per_rank": [r["launches"] for r in ranks],
              "card": smi, "ok": ok})
        if not ok:
            raise AssertionError(f"parallel_train {model_name} zero1 "
                                 f"{zero1}: steps {steps}")
        for r in (0, 1):
            tag = "_zero1" if zero1 else ""
            by_run[f"{model_name}_parallel_train{tag}_rank{r}"] = (
                ranks[r]["launches"])
        if model_name == "aff_mini" and zero1:
            kept = (outs[i], trains[0]["checkpoint"], trains[0]["val_loss"])
        else:
            shutil.rmtree(outs[i], ignore_errors=True)
    emit({"phase": "parallel_train_ranks", "runs": len(runs),
          "seconds": secs})

    # a world of one with NCCL, as torchrun starts each process of a
    # multi-card host
    out = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    try:
        argv = ["--cfg", preset_path("aff_mini.yaml"), "--device", "cuda",
                "--data-path", "no_dataset", "--batch-size", "64",
                "--epochs", "1", "--output", out]
        t0 = time.perf_counter()
        (lines,) = main_runs(run_ranks(
            (PARALLEL_MAIN, json.dumps([argv])), 1,
            {"MASTER_ADDR": "localhost",
             "MASTER_PORT": str(free_ports(1)[0])}))
        secs = time.perf_counter() - t0
    finally:
        shutil.rmtree(out, ignore_errors=True)
    (run,) = lines
    train = run["run"]["train"]
    ok = (run["run"]["world"] == 1 and run["run"]["backend"] == "nccl"
          and train["steps"] == 4
          and run["launches"] == expect_path("aff_mini", 50 + 30 + 4, 4)
          and math.isfinite(train["val_loss"]))
    emit({"phase": "parallel_nccl_world1", "model": "aff_mini",
          "backend": "nccl", "world": 1, "b": 64, "dtype": "bfloat16",
          "steps": train["steps"],
          "img_per_s_after_first": train["train_img_s_after_first"],
          "seconds": secs, "launches": run["launches"], "card": smi,
          "ok": ok})
    if not ok:
        raise AssertionError("world-of-one NCCL run of main")
    by_run["aff_mini_nccl_world1"] = run["launches"]
    return by_run, kept


def phase_parallel_seq_train(torch, smi):
    """``main`` on two ranks sharing the one card (gloo, ``--device
    cuda:0``) at ``TPU.MESH_SEQ`` 2, the runs one after another in the
    same two processes: AFF-Mini and UD-Mini 224, b = 64 (both ranks the
    same images, each half of every stage's tokens), bf16, one synthetic
    epoch of four steps (UD-Mini at the curriculum's ratio 1.0), the
    collectives timed (``MLAFF_COMM_TIMING=1``). ``main``'s throughput
    protocol is cut to one warmup and one timed forward: at seq 2 every
    block gathers its k and v through the host. Per run the img/s after
    the first step per rank (the two ranks train the same images: not
    summed), peak memory per rank and the ms per step in collectives;
    every attention launch a range. Returns the launches by run."""
    import os
    import shutil
    import tempfile

    outs = [tempfile.mkdtemp(prefix="chip_smoke_seq_train_")
            for _ in PARALLEL_MODELS]
    argvs = [["--cfg", preset_path(preset), "--device", "cuda:0",
              "--dist-backend", "gloo", "--dist-url",
              f"tcp://localhost:{port}", "--data-path", "no_dataset",
              "--batch-size", "64", "--epochs", "1", "--output", out,
              "--opts", "TPU.MESH_SEQ", "2"]
             for preset, out, port in zip(PARALLEL_MODELS.values(), outs,
                                          free_ports(len(outs)))]
    t0 = time.perf_counter()
    try:
        per_rank = main_runs(run_ranks(
            (PARALLEL_MAIN, json.dumps(argvs), "short"), 2,
            {"MLAFF_COMM_TIMING": "1"}))
    finally:
        for out in outs:
            shutil.rmtree(out, ignore_errors=True)
    secs = time.perf_counter() - t0
    by_run = {}
    for i, model_name in enumerate(PARALLEL_MODELS):
        ranks = [lines[i] for lines in per_rank]
        trains = [r["run"]["train"] for r in ranks]
        steps = [t["steps"] for t in trains]
        # 1 + 1 throughput forwards, 256 validation images / 64, 4 steps
        want = expect_path(model_name, 1 + 1 + 4, 4)
        for d in ("fwd", "bwd"):
            want[f"cluster_attention_{d}_range"] = want[
                f"cluster_attention_{d}"]
        ok = (steps == [4, 4] and all(r["launches"] == want for r in ranks)
              and all(r["run"]["seq"] == 2 for r in ranks)
              and all(t["skipped_steps"] == 0 for t in trains)
              and trains[0]["train_loss"] == trains[1]["train_loss"]
              and trains[0]["val_loss"] == trains[1]["val_loss"]
              and all(math.isfinite(t["val_loss"]) for t in trains))
        epoch = [t["epochs"][-1] for t in trains]
        emit({"phase": "parallel_seq_train", "model": model_name,
              "ranks": 2, "seq": 2, "data": 1, "backend": "gloo",
              "device": "one card, two processes", "b": 64,
              "dtype": "bfloat16", "steps_per_rank": steps,
              "img_per_s_after_first_per_rank": [
                  e["img_s_after_first"] for e in epoch],
              "peak_memory_bytes_per_rank": [
                  e["peak_memory_bytes"] for e in epoch],
              "collective_ms_per_step_per_rank": [
                  1e3 * e["collective_seconds"] / e["steps"]
                  for e in epoch],
              "collective_calls_per_step": [
                  e["collective_calls"] / e["steps"] for e in epoch],
              "train_loss": trains[0]["train_loss"],
              "val_loss": trains[0]["val_loss"],
              "launches_per_rank": [r["launches"] for r in ranks],
              "card": smi, "ok": ok})
        if not ok:
            raise AssertionError(f"parallel_seq_train {model_name}: "
                                 f"steps {steps}")
        for r in (0, 1):
            by_run[f"{model_name}_seq2_train_rank{r}"] = ranks[r]["launches"]
    emit({"phase": "parallel_seq_train_ranks", "runs": len(outs),
          "seconds": secs})
    return by_run


def phase_parallel_ckpt(torch, smi, kept):
    """The two-rank ZeRO-1 run's checkpoint (AFF-Mini, bf16) in one
    process: ``main --eval --resume`` at b = 64 over the same 256
    synthetic validation images reproduces the run's val loss within 1e-3
    relative (bf16; the two ranks' global batches of 2 x 64 hold other
    images than the one process's batches of 64, which moves the
    batch-wide max of the clustering's sort key and cuBLAS's choice of
    kernel) and gives the launches of an eval."""
    import shutil

    out, ckpt, val_loss = kept
    try:
        result, secs, launches = run_main(torch, [
            "--cfg", preset_path("aff_mini.yaml"), "--device", "cuda",
            "--data-path", "no_dataset", "--batch-size", "64", "--eval",
            "--resume", ckpt])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    rel = abs(result["loss"] - val_loss) / abs(val_loss)
    ok = (rel <= 1e-3 and result["val_count"] == 256
          and launches == expect_path("aff_mini", 50 + 30 + 4))
    emit({"phase": "parallel_ckpt", "model": "aff_mini", "zero1": True,
          "written_by_ranks": 2, "loaded_in": "one process",
          "val_loss_ranks": val_loss, "val_loss_one": result["loss"],
          "rel_err": rel, "val_count": result["val_count"],
          "seconds": secs, "launches": launches, "card": smi, "ok": ok})
    if not ok:
        raise AssertionError(f"parallel_ckpt: val loss {result['loss']} vs "
                             f"{val_loss}")


# ----------------------------------- pipeline parallelism (parallel/pp.py) --

PIPE_STAGE = 2  # AFF-Mini's stage 3: six blocks of one shape
PIPE_CHECK = (("p2m2", 1, 2, 2), ("p2m4", 1, 2, 4), ("p2m8", 1, 2, 8),
              ("d2p2m2", 2, 2, 2))  # (name, data, pipe, microbatches)
PIPE_TRAIN = (("p2m4", 1, 2, 4), ("p2m8", 1, 2, 8))
PIPE_ITERS = 5  # timed forward + backward passes per layout

PIPE_RANK = r"""
import json, sys
import torch
import chip_smoke as cs
from ml_autofocusformermod_torch.parallel import mesh as mesh_lib
spec = json.loads(sys.argv[1])
dev = torch.device(spec["device"])
if dev.type == "cuda":
    torch.cuda.set_device(0)
mesh_lib.init_distributed(dev, "gloo", spec["init"])
try:
    for case in spec["cases"]:
        print(json.dumps(cs.pipe_rank_case(torch, spec, case, dev)),
              flush=True)
finally:
    mesh_lib.destroy()
"""


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def capture_stage3(torch, b, dtype_name, dev, path):
    """AFF-Mini 224 built from seed 0 in ``dtype_name`` on ``dev``, one
    eval forward of ``b`` synthetic images (``captured_attention``'s): the
    stage-3 blocks' input ``feat`` and the ``ncc``, ``pos`` and tile
    metadata that ``BasicLayer.forward`` gives them, captured before the
    first block, with the stage's six blocks, saved to ``path``; also
    ``g``, an output gradient drawn from seed 7."""
    import numpy as np

    from ml_autofocusformermod_torch.models.build import build_model

    cfg = port_config("aff_mini.yaml", ["TPU.COMPUTE_DTYPE", dtype_name])
    model = build_model(cfg, dev, seed=0).eval()
    images = torch.from_numpy(np.stack([
        np.random.default_rng(i).standard_normal((224, 224, 3)).astype(
            np.float32) for i in range(b)]).transpose(0, 3, 1, 2).copy())
    blocks = model.layers[PIPE_STAGE].blocks
    seen = {}

    def hook(module, args):
        x, _, _, ncc, cs, pos, meta = args[:7]
        seen.update(x=x.detach().clone(), ncc=ncc.clone(), pos=pos.clone(),
                    meta=tuple(t.clone() for t in meta), cs=cs)

    handle = blocks[0].register_forward_pre_hook(hook)
    try:
        with torch.no_grad():
            model(images.to(dev))
    finally:
        handle.remove()
    gen = torch.Generator().manual_seed(7)
    seen["g"] = torch.randn(seen["x"].shape, generator=gen).to(
        dev, seen["x"].dtype)
    seen["blocks"] = blocks
    torch.save(seen, path)


def pipe_chain(torch, spec, dev):
    """The captured chain of ``spec`` on ``dev`` (its blocks in training
    mode) and the block function."""
    from ml_autofocusformermod_torch.ops.cluster_attention import TileMeta

    saved = torch.load(spec["captured"], weights_only=False,
                       map_location=dev)
    cs = saved["cs"]

    def block_fn(blk, x, ncc, pos, meta):
        return blk(x, False, None, ncc, cs, pos, meta)

    saved["meta"] = TileMeta(*saved["meta"])
    saved["blocks"].train()
    return saved, block_fn


def pipe_step(torch, block_fn, blocks, x, consts, g, run):
    """One forward (``run(block_fn, blocks, x, consts)``) and the backward
    of ``sum(out * g)``, the blocks' gradients reset first and left on
    them: the output, ``x``'s gradient and the two phases' host ms
    (synchronised)."""
    for t in blocks.parameters():
        t.grad = None
    x = x.detach().requires_grad_()
    sync(torch, x.device)
    t0 = time.perf_counter()
    out = run(block_fn, blocks, x, consts)
    sync(torch, x.device)
    t1 = time.perf_counter()
    (out.float() * g.float()).sum().backward()
    sync(torch, x.device)
    t2 = time.perf_counter()
    return out.detach(), x.grad, 1e3 * (t1 - t0), 1e3 * (t2 - t1)


def pipe_passes(torch, run, block_fn, blocks, x, consts, g, dev, timed,
                first=0):
    """Passes of ``run`` (the pipelined or the sequential chain) over
    ``blocks``: with ``timed`` one first (the path's first launches); then
    the pass whose launches are counted (counters zeroed just before, read
    just after), which gives the output, ``x``'s gradient and the blocks'
    gradients (keys ``<first + j>.<parameter>``); with ``timed`` then
    ``PIPE_ITERS`` passes: the median forward, backward and step ms, the
    collectives per step and the passes' peak memory above what the
    process held before them (the caller's earlier phases hold some)."""
    from ml_autofocusformermod_torch.parallel import comm

    args = (torch, block_fn, blocks, x, consts, g, run)
    if timed:
        pipe_step(*args)
    zero_counters()
    out, x_grad, _, _ = pipe_step(*args)
    res = {"launches": read_counters(), "out": out, "x_grad": x_grad,
           "grads": {f"{first + j}.{k}": t.grad.clone()
                     for j, blk in enumerate(blocks)
                     for k, t in blk.named_parameters()}}
    if timed:
        held = 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
        calls, secs = comm.STATS["calls"], comm.STATS["seconds"]
        times = [pipe_step(*args)[2:] for _ in range(PIPE_ITERS)]
        mid = PIPE_ITERS // 2
        res.update(
            fwd_ms=sorted(t[0] for t in times)[mid],
            bwd_ms=sorted(t[1] for t in times)[mid],
            step_ms=sorted(sum(t) for t in times)[mid],
            collective_calls_per_step=(comm.STATS["calls"] - calls)
            / PIPE_ITERS,
            collective_ms_per_step=1e3 * (comm.STATS["seconds"] - secs)
            / PIPE_ITERS,
            peak_memory_bytes=(torch.cuda.max_memory_allocated(dev) - held
                               if dev.type == "cuda" else None))
    return res


def pipe_rank_case(torch, spec, case, dev):
    """One rank's run of a pipe layout (``PIPE_RANK``): this rank's stage
    of the captured chain on its data rank's rows in ``M`` microbatches,
    through :func:`pipe_passes` (``timed`` from ``spec``). Saves this
    rank's output, ``x`` gradient and stage gradients (the data line's
    mean) for the caller; returns the JSON line."""
    import os

    from ml_autofocusformermod_torch.parallel import comm, pp

    name, data, pipe, M = case
    saved, block_fn = pipe_chain(torch, spec, dev)
    mesh = pp.make_pipe_mesh(pipe, data)
    stage = pp.stage_blocks(saved["blocks"], mesh)
    b = saved["x"].shape[0] // data
    rows = slice(mesh.data_rank * b, (mesh.data_rank + 1) * b)
    consts = tuple(c[rows].contiguous() if isinstance(c, torch.Tensor) else
                   type(c)(*(t[rows].contiguous() for t in c))
                   for c in (saved["ncc"], saved["pos"], saved["meta"]))

    def run(fn, blks, y, cs_):
        return pp.pipeline_blocks(fn, blks, y, cs_, mesh=mesh,
                                  num_microbatches=M)

    res = pipe_passes(torch, run, block_fn, stage,
                      saved["x"][rows].contiguous(), consts,
                      saved["g"][rows].contiguous(), dev, spec["timed"],
                      mesh.pipe_rank * len(stage))
    comm.all_reduce_mean_(list(res["grads"].values()), mesh.data_group)
    torch.save({k: res.pop(k) for k in ("out", "x_grad", "grads")},
               os.path.join(spec["out"], f"{name}_rank{mesh.rank}.pt"))
    return {"rank": mesh.rank, "case": name, "pipe_rank": mesh.pipe_rank,
            "data_rank": mesh.data_rank, **res}


def run_pipe_layouts(torch, spec, layouts, timeout=300, env_extra=None):
    """Every layout of ``layouts`` on its ranks (``PIPE_RANK``; one launch
    per world size, in order): the JSON lines by ``(case, rank)``."""
    lines = {}
    for world in sorted({d * p for _, d, p, _ in layouts}):
        cases = [c for c in layouts if c[1] * c[2] == world]
        outs = run_ranks((PIPE_RANK, json.dumps({
            **spec, "cases": cases,
            "init": f"tcp://localhost:{free_ports(1)[0]}"})), world,
            env_extra, timeout=timeout)
        for out in outs:
            for ln in json_lines(out):
                lines[(ln["case"], ln["rank"])] = ln
    return lines


def pipe_compare(torch, tmp, name, world, data, ref):
    """The worst error of layout ``name``'s ranks against the sequential
    ``ref`` (``out``, ``x_grad``, ``grads``), each relative to its
    tensor's max|ref|: the output and ``x``'s gradient as every pipe rank
    holds them (the data ranks' rows in order), every block's gradient
    from its own pipe rank (times ``data``: each data rank's loss is its
    rows' sum); and whether each is bit-equal to the reference."""
    import os

    ranks = [torch.load(os.path.join(tmp, f"{name}_rank{r}.pt"))
             for r in range(world)]
    pipe = world // data

    def rows(key, p):
        return torch.cat([ranks[d * pipe + p][key] for d in range(data)])

    def rel(a, b):
        return ((a.float() - b.float()).abs().max().item()
                / max(b.float().abs().max().item(), 1e-30))

    outs = [rows("out", p) for p in range(pipe)]
    x_grads = [rows("x_grad", p) for p in range(pipe)]
    grads = {k: t * data for r in ranks[:pipe] for k, t in r["grads"].items()}
    worst = max((rel(grads[k], t), k) for k, t in ref["grads"].items())
    return {
        "out_rel_err": max(rel(o, ref["out"]) for o in outs),
        "x_grad_rel_err": max(rel(xg, ref["x_grad"]) for xg in x_grads),
        "worst_grad_rel_err": worst,
        "bit_equal": {
            "out": all(torch.equal(o, ref["out"]) for o in outs),
            "x_grad": all(torch.equal(xg, ref["x_grad"]) for xg in x_grads),
            "grads": all(torch.equal(grads[k], t)
                         for k, t in ref["grads"].items())},
        "same_on_pipe_ranks": all(torch.equal(o, outs[0]) for o in outs),
        "grad_keys_match": sorted(grads) == sorted(ref["grads"])}


def pipe_sequential(torch, saved, block_fn, timed, dev):
    """The sequential chain in this process on the captured inputs
    (:func:`pipe_passes`)."""
    from ml_autofocusformermod_torch.parallel import pp

    return pipe_passes(torch, lambda fn, blks, y, cs_: pp.sequential_blocks(
        fn, blks, y, cs_), block_fn, saved["blocks"], saved["x"],
        (saved["ncc"], saved["pos"], saved["meta"]), saved["g"], dev, timed)


def phase_parallel_pipe_check(torch, smi, dev="cuda", b=8):
    """GPipe (``parallel/pp.py``) over AFF-Mini's stage 3 (six blocks,
    dim 256, 8 heads, n = 196, clusters of 8, nnc 6), fp32, ``b`` = 8, on
    inputs captured from a real forward, the same blocks on every rank:
    pipe 2 at M = 2, 4 and 8 (two ranks) and data 2 x pipe 2 at M = 2
    (four ranks), all on the one card through gloo, against one process's
    ``sequential_blocks`` on the card: the output within 1e-5 of max|ref|,
    ``x``'s gradient and every block's parameter gradient within 1e-4;
    whether each is bit-equal; every pipe rank the same output; each
    rank's attention launches (3 M forwards with statistics and 3 M saved
    backwards)."""
    import shutil
    import tempfile

    dev = torch.device(dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pipe_")
    try:
        path = f"{tmp}/captured.pt"
        capture_stage3(torch, b, "float32", dev, path)
        saved, block_fn = pipe_chain(torch, {"captured": path}, dev)
        ref = pipe_sequential(torch, saved, block_fn, False, dev)
        t0 = time.perf_counter()
        lines = run_pipe_layouts(torch, {"captured": path, "out": tmp,
                                         "device": str(dev),
                                         "timed": False}, PIPE_CHECK)
        secs = time.perf_counter() - t0
        for name, data, pipe, M in PIPE_CHECK:
            world = data * pipe
            cmp = pipe_compare(torch, tmp, name, world, data, ref)
            per_rank = [lines[(name, r)]["launches"] for r in range(world)]
            want = attention_launches(0, 3 * M)
            launched = all(ln[k] == v for ln in per_rank
                           for k, v in want.items())
            ok = (cmp["out_rel_err"] <= 1e-5 and cmp["x_grad_rel_err"] <= 1e-4
                  and cmp["worst_grad_rel_err"][0] <= 1e-4
                  and cmp["same_on_pipe_ranks"] and cmp["grad_keys_match"]
                  and launched)
            emit({"phase": "parallel_pipe_check", "model": "aff_mini",
                  "chain": "stage 3, 6 blocks", "layout": name,
                  "data": data, "pipe": pipe, "microbatches": M,
                  "dtype": "float32", "b": b, "backend": "gloo",
                  **cmp, "limits": {"out": 1e-5, "grads": 1e-4},
                  "launches_per_rank": per_rank, "card": smi, "ok": ok})
            if not ok:
                raise AssertionError(f"parallel_pipe_check {name}")
        emit({"phase": "parallel_pipe_check_ranks", "seconds": secs})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def phase_parallel_pipe_train(torch, smi, dev="cuda", b=128):
    """The same chain at ``b`` = 128 bf16 (inputs captured from a bf16
    forward), pipe 2 at M = 4 and 8, the collectives timed
    (``MLAFF_COMM_TIMING=1``): forward, then the backward of ``sum(out *
    g)``, against the sequential chain in one process on the card (2e-2
    of max|ref|). Per layout: ms per pipelined forward and backward per
    rank (medians of ``PIPE_ITERS``) beside one process's sequential ms,
    the bubble (P-1)/(M+P-1), ms and count of collectives per step, peak
    memory per rank (above what the process held before: the caller
    holds earlier phases' tensors), and the attention launches of one pass per rank: 3 M
    forwards with statistics and 3 M saved backwards (the bubble's
    compute is skipped). Two ranks time-share one card and gloo carries
    the hand-offs through the host: not a scaling number. Returns the
    launches by run (``aff_mini_s3_pipe2_m<M>_rank<r>``)."""
    import shutil
    import tempfile

    dev = torch.device(dev)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_pipe_train_")
    by_run = {}
    try:
        path = f"{tmp}/captured.pt"
        capture_stage3(torch, b, "bfloat16", dev, path)
        saved, block_fn = pipe_chain(torch, {"captured": path}, dev)
        ref = pipe_sequential(torch, saved, block_fn, True, dev)
        seq_launches = ref["launches"]
        t0 = time.perf_counter()
        lines = run_pipe_layouts(torch, {"captured": path, "out": tmp,
                                         "device": str(dev), "timed": True},
                                 PIPE_TRAIN,
                                 env_extra={"MLAFF_COMM_TIMING": "1"})
        secs = time.perf_counter() - t0
        for name, data, pipe, M in PIPE_TRAIN:
            world = data * pipe
            cmp = pipe_compare(torch, tmp, name, world, data, ref)
            per_rank = [lines[(name, r)] for r in range(world)]
            want = attention_launches(0, 3 * M)
            launched = all(ln["launches"][k] == v for ln in per_rank
                           for k, v in want.items())
            ok = (cmp["out_rel_err"] <= 2e-2 and cmp["x_grad_rel_err"] <= 2e-2
                  and cmp["worst_grad_rel_err"][0] <= 2e-2
                  and cmp["same_on_pipe_ranks"] and cmp["grad_keys_match"]
                  and launched)
            emit({"phase": "parallel_pipe_train", "model": "aff_mini",
                  "chain": "stage 3, 6 blocks", "layout": name,
                  "data": data, "pipe": pipe, "microbatches": M,
                  "dtype": "bfloat16", "b": b, "backend": "gloo",
                  "device": "one card, two processes",
                  "bubble_predicted": (pipe - 1) / (M + pipe - 1),
                  "fwd_ms_per_rank": [ln["fwd_ms"] for ln in per_rank],
                  "bwd_ms_per_rank": [ln["bwd_ms"] for ln in per_rank],
                  "step_ms_per_rank": [ln["step_ms"] for ln in per_rank],
                  "sequential_fwd_ms": ref["fwd_ms"],
                  "sequential_bwd_ms": ref["bwd_ms"],
                  "sequential_step_ms": ref["step_ms"],
                  "collective_ms_per_step_per_rank": [
                      ln["collective_ms_per_step"] for ln in per_rank],
                  "collective_calls_per_step_per_rank": [
                      ln["collective_calls_per_step"] for ln in per_rank],
                  "peak_memory_bytes_per_rank": [
                      ln["peak_memory_bytes"] for ln in per_rank],
                  "sequential_peak_memory_bytes": ref["peak_memory_bytes"],
                  **cmp, "rel_limit": 2e-2,
                  "launches_per_rank": [ln["launches"] for ln in per_rank],
                  "sequential_launches": seq_launches,
                  "card": smi, "ok": ok})
            if not ok:
                raise AssertionError(f"parallel_pipe_train {name}")
            for r in range(world):
                by_run[f"aff_mini_s3_pipe2_m{M}_rank{r}"] = (
                    per_rank[r]["launches"])
        emit({"phase": "parallel_pipe_train_ranks", "seconds": secs})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return by_run


def kernels_line(rows, launches, mf_rows, mf_launches, mft_rows,
                 mft_launches, tp_rows, seq_rows):
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
    (``launches_from``). The attention forward and backward also carry
    ``aff_mini_tp2``: their rows at AFF-Mini's tensor-parallel shapes (h/2
    heads, c/2 channels), with the launches of rank 0 of the model-2 run
    of parallel_check (two steps), and ``aff_mini_seq2``: rank 0's query
    ranges at seq 2 (AFF-Mini's first half of every stage's tokens), with
    the launches of rank 0 of parallel_seq_check's AFF-Mini run (two
    steps), every row of the seq-2 ranges (both halves, AFF-Mini and
    UD-Mini) under ``seq2_per_shape``. A kernel of the path that the run
    did not launch fails the script."""
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
        seq = seq_rows.get(name, [])
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
            "max_abs_err": max(r["max_abs_err"]
                               for r in rs + mf + mft + seq),
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
        if name in tp_rows:
            entry["aff_mini_tp2"] = block(
                tp_rows[name], mft_launches["aff_mini_tp2_rank0"][name])
        if seq:
            entry["aff_mini_seq2"] = block(
                [r for r in seq if r["seq_rank"] == 0
                 and r["shape"].startswith("stage")],
                mft_launches["aff_mini_seq2_rank0"][name])
            entry["seq2_per_shape"] = seq
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
        launches, aff_img_s, aff_peak = phase_train(torch, smi)
        mf_launches = phase_maskfiner_entry(torch, smi)
        mft_launches, mf_img_s, mf_peak = phase_maskfiner_train(torch, smi)
        mft_launches.update(phase_real_data(
            torch, smi, env,
            {"aff_mini": aff_img_s,
             "maskfiner_ud_mini": mf_img_s["maskfiner_ud_mini"]}))
        phase_ops_check(torch)
        phase_remat_check(torch)
        mft_launches.update(phase_remat_train(torch, smi, {
            "aff_mini": {"img_s": aff_img_s, "peak": aff_peak},
            "maskfiner_ud_mini": {"img_s": mf_img_s["maskfiner_ud_mini"],
                                  "peak": mf_peak["maskfiner_ud_mini"]}}))
        mft_launches.update(phase_export(torch))
        phase_flops(torch, smi)
        mft_launches["aff_mini_profile"] = phase_profile(torch, smi)
        tp_rows = phase_parallel_kernels(torch)
        seq_rows = phase_seq_kernels(torch)
        mft_launches.update(phase_parallel_check(torch, smi))
        mft_launches.update(phase_parallel_seq_check(torch, smi))
        by_run, kept = phase_parallel_train(torch, smi)
        mft_launches.update(by_run)
        phase_parallel_ckpt(torch, smi, kept)
        mft_launches.update(phase_parallel_seq_train(torch, smi))
        phase_parallel_pipe_check(torch, smi)
        mft_launches.update(phase_parallel_pipe_train(torch, smi))
        line = kernels_line(rows, launches, mf_rows, mf_launches, mft_rows,
                            mft_launches, tp_rows, seq_rows)
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
