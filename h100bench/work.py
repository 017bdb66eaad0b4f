"""The work of a kernel call and of a model pass, from shapes alone.

Copies of the arithmetic of the measured package's ``chip_smoke.py``
(``bound_ms``, ``nbytes``, ``attn_work``, ``attn_bwd_work``,
``merge_work``, ``merge_bwd_work``; NVIDIA's published H100 SXM peaks) and
``utils/flops.py`` (two flops per multiply-add of every product), kept
here so that the yardstick does not move with the program. Bytes count
each input read once and each output written once; the attention
forward's saved softmax statistics are the implementation's and are not
counted. Flops count the slots that hold a token, at least: a query
whose neighbours include the last, padded cluster loses its padded slots,
so ``b * nq * (nnc * cs - pad)`` is a lower bound of the data-dependent
count, and the least time it gives is never above the true one.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12,
              "float32": 67e12}  # dense tensor cores; f32 off them


class Arg(NamedTuple):
    """A tensor argument of a call: shape, bytes per element, strides
    (None: contiguous) and dtype name."""

    shape: Tuple[int, ...]
    itemsize: int
    strides: Optional[Tuple[int, ...]] = None
    dtype: str = "float32"


def nbytes(*args: Arg) -> int:
    """Bytes of each argument's distinct storage (a dimension of stride 0,
    such as a batch-broadcast table, counts once)."""
    total = 0
    for a in args:
        n = 1
        for i, s in enumerate(a.shape):
            if not (a.strides is not None and a.strides[i] == 0):
                n *= s
        total += n * a.itemsize
    return total


def least_seconds(moved: float, flops: float, dtype: str) -> float:
    """The least time the card needs to move ``moved`` bytes once and do
    ``flops`` at the dtype's peak."""
    return max(moved / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def _valid_slots(b: int, nq: int, n: int, nnc: int, cs: int) -> int:
    pad = -(-n // cs) * cs - n
    return b * nq * max(nnc * cs - pad, 0)


def attention_fwd(q: Arg, kv: Arg, ncc: Arg, pos: Arg,
                  small: Sequence[Arg], num_heads: int, cs: int):
    """(bytes, flops) of one attention forward: q, kv, ncc, pos and the
    small parameters read once, the output written once."""
    b, nq, c = q.shape
    c_ = c // num_heads
    valid = _valid_slots(b, nq, kv.shape[1], ncc.shape[2], cs)
    moved = nbytes(q, kv, ncc, pos, *small) + nbytes(q)
    flops = valid * num_heads * (4 * c_ + 12) + b * nq * num_heads * 4 * c_
    return moved, flops


def attention_bwd(q: Arg, kv: Arg, ncc: Arg, pos: Arg, small: Sequence[Arg],
                  g: Arg, num_heads: int, cs: int):
    """(bytes, flops) of one attention backward: the forward's inputs and g
    read once, dq, dkv and the small parameters' gradients written once;
    per slot q.k, g.v, dq, dk and dv plus the geometry and softmax
    terms."""
    b, nq, c = q.shape
    c_ = c // num_heads
    valid = _valid_slots(b, nq, kv.shape[1], ncc.shape[2], cs)
    moved = nbytes(q, kv, ncc, pos, *small, g) + nbytes(q, kv, *small)
    flops = valid * num_heads * (10 * c_ + 24) + b * nq * num_heads * 8 * c_
    return moved, flops


def merge_fwd(w: Arg, feat: Arg, ncc: Arg, cs: int):
    """(bytes, flops) of one merge forward: weights, features and ncc read
    once, the (b, n', ic, c) output written once."""
    b, n_, _, ic = w.shape
    n, c = feat.shape[1], feat.shape[2]
    valid = _valid_slots(b, n_, n, ncc.shape[2], cs)
    return nbytes(w, feat, ncc) + b * n_ * ic * c * w.itemsize, \
        valid * ic * c * 2


def merge_bwd(w: Arg, feat: Arg, ncc: Arg, g: Arg, cs: int):
    """(bytes, flops) of one merge backward: w, feat, ncc, g read once, dw
    and dfeat written once."""
    b, n_, _, ic = w.shape
    n, c = feat.shape[1], feat.shape[2]
    valid = _valid_slots(b, n_, n, ncc.shape[2], cs)
    return nbytes(w, feat, ncc, g) + nbytes(w, feat), valid * ic * c * 4


def op_work(name: str, args: list):
    """(bytes, flops, dtype) of a recorded call of one of the ``mlaff``
    ops, from its arguments (:class:`Arg` for tensors, values for
    scalars), or None for an op with no work of its own (the merge
    backward's inverse index, whose time counts against the merge)."""
    if name == "mlaff::cluster_attention_fwd":
        q, kv, ncc, pos = args[:4]
        moved, flops = attention_fwd(q, kv, ncc, pos, args[4:8],
                                     int(args[11]), int(args[12]))
        return moved, flops, q.dtype
    if name == "mlaff::cluster_attention_bwd":
        q, kv, ncc, pos = args[:4]
        moved, flops = attention_bwd(q, kv, ncc, pos, args[4:8], args[11],
                                     int(args[14]), int(args[15]))
        return moved, flops, q.dtype
    if name == "mlaff::cluster_merge_fwd":
        moved, flops = merge_fwd(args[0], args[1], args[2], int(args[3]))
        return moved, flops, args[0].dtype
    if name == "mlaff::cluster_merge_bwd":
        moved, flops = merge_bwd(args[0], args[1], args[2], args[4],
                                 int(args[3]))
        return moved, flops, args[0].dtype
    return None


def model_flops_per_image(model, img_size: int) -> float:
    """Flops of one eval forward of ``model`` on one zero image, by
    ``torch.utils.flop_counter.FlopCounterMode`` (two per multiply-add of
    every matmul and convolution)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    device = next(model.parameters()).device
    counter = FlopCounterMode(display=False)
    was = model.training
    model.eval()
    with torch.no_grad(), counter:
        model(torch.zeros((1, 3, img_size, img_size), device=device))
    model.train(was)
    return float(counter.get_total_flops())


def mfu(images_per_s: float, flops_per_image: float, passes: float,
        dtype: str = "bfloat16") -> float:
    """The share of the dtype's peak that ``images_per_s`` images of
    ``passes`` forward-equivalents each make (3 for a training step: the
    forward and a backward of twice its work; recompute not counted)."""
    return images_per_s * passes * flops_per_image / PEAK_FLOPS[dtype]
