"""Core AFF building blocks (counterpart of the JAX package's
``models/layers.py``).

Attribute names follow the reference torch module tree, so ``state_dict()``
keys equal what the JAX package's ``ckpt/pth_import.py::_torch_key`` maps
its flax paths to (``layers.0.blocks.0.attn.q.weight``,
``layers.0.downsample.weight_net.0.weight``, ...).

Compute-dtype semantics follow flax's ``dtype=``: parameters stay float32,
matmuls and convolutions run in the compute dtype (explicit casts, no
autocast), and LayerNorm, softmax, kNN and clustering run in float32.
The JAX package's ``training`` flag is ``module.train()``: in training mode
Dropout and DropPath are active and PatchEmbed's BatchNorm normalises with
the batch statistics and updates its running stats with flax's semantics.
:func:`remat_call` is the JAX package's ``remat_wrap`` (``TPU.REMAT``): the
block loops run each transformer block through it. No BatchNorm sits
inside a block, so a recompute never updates running statistics twice.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops import cluster_attention as attention_ops
from ..ops.cluster_attention import fused_cluster_attention, offset_features
from ..ops.cluster_gather import gather_clusters, gather_rows
from ..ops.cluster_merge import fused_cluster_merge
from ..ops.clusten import wf_contract
from ..ops.knn import nearest_other_distance
from ..ops.layer_norm import layer_norm, layer_norm_reference
from ..parallel import comm
from ..utils.profiling import span

__all__ = [
    "Linear", "LayerNormFp32", "rel_pos_features", "Dropout", "DropPath",
    "Mlp",
    "ClusterAttention", "ClusterTransformerBlock", "ClusterMerging",
    "PatchEmbed", "batch_norm_train", "REMAT_MODES", "check_remat",
    "remat_call", "row_parallel",
]

REMAT_MODES = ("", "blocks", "dots")
# the products whose outputs ``dots`` keeps: a 2-D matmul, what nn.Linear on
# (b, n, c) becomes (JAX: dot_generals without batch dimensions)
_SAVED_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def check_remat(mode: str) -> str:
    """``mode`` if it is one of :data:`REMAT_MODES`, else ValueError with
    the JAX package's message."""
    if mode not in REMAT_MODES:
        raise ValueError(
            f"Unknown remat mode: {mode!r} (use '', 'blocks', 'dots')")
    return mode


def _dots_policy(ctx, op, *args, **kwargs):
    """``dots_with_no_batch_dims_saveable``: keep the outputs of 2-D
    products, recompute everything else (batched matmuls, the attention
    op, the elementwise interior)."""
    if op in _SAVED_PRODUCTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _explicit_generators(block: nn.Module):
    """The distinct ``torch.Generator`` objects ``block``'s Dropout,
    DropPath and attention dropout draw from (those the trainer set;
    torch's default generators are left to checkpoint's own
    ``preserve_rng_state``)."""
    gens = {}
    for mod in block.modules():
        for gen in (getattr(mod, "generator", None),
                    getattr(mod, "attn_drop_generator", None)):
            if isinstance(gen, torch.Generator):
                gens[id(gen)] = gen
    return list(gens.values())


def remat_call(mode: str, block: nn.Module, *args):
    """``block(*args)``, rematerialised in the backward as the JAX
    package's ``remat_wrap`` gates a block (``models/layers.py:69-93``):
    ``''`` runs it as is; ``'blocks'`` keeps only its inputs and recomputes
    its forward in the backward (``torch.utils.checkpoint``, non-reentrant);
    ``'dots'`` does the same but keeps the outputs of 2-D products
    (:func:`_dots_policy`). Without autograd recording there is nothing to
    keep, and the block runs as is.

    The recompute draws the same random numbers as the forward: the
    explicit generators' states are taken before the forward, set at the
    start of the recompute and, after it, set back to where they were when
    it began, so the next step starts where it would without remat (JAX's
    ``nn.remat`` lifts its rngs the same way); checkpoint restores torch's
    default generators itself. The numerics are those of ``''`` bit for
    bit."""
    if not mode or not torch.is_grad_enabled():
        return block(*args)
    gens = _explicit_generators(block)
    stash = []

    def run(*a):
        if not stash:  # the forward
            stash.append([g.get_state() for g in gens])
            return block(*a)
        now = [g.get_state() for g in gens]  # the recompute
        for g, state in zip(gens, stash[0]):
            g.set_state(state)
        try:
            return block(*a)
        finally:
            for g, state in zip(gens, now):
                g.set_state(state)

    context = (functools.partial(create_selective_checkpoint_contexts,
                                 _dots_policy) if mode == "dots" else None)
    kwargs = {"context_fn": context} if context else {}
    return checkpoint(run, *args, use_reentrant=False, **kwargs)


def row_parallel(linear: "Linear", x, group):
    """``linear(x)`` for a row-parallel layer: with a tensor-parallel
    ``group`` the product of this rank's input block and weight columns,
    summed over the group (Megatron's g), then the bias, added once."""
    if group is None:
        return linear(x)
    dt = linear.compute_dtype
    y = comm.reduce_from_model(F.linear(x.to(dt), linear.weight.to(dt)),
                               group)
    return y + linear.bias.to(dt)


class Linear(nn.Linear):
    """``nn.Linear`` whose product runs in ``compute_dtype`` (flax ``Dense``
    with ``dtype=``): input, weight and bias are cast, params stay f32.
    Initialised like the JAX package: truncated normal (std 0.02, +-2 std)
    weights, zero bias."""

    def __init__(self, in_features, out_features, compute_dtype=torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        nn.init.trunc_normal_(self.weight, std=0.02, a=-0.04, b=0.04,
                              generator=generator)
        nn.init.zeros_(self.bias)

    def forward(self, x):
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class LayerNormFp32(nn.Module):
    """LayerNorm in float32 with the fast-variance form ``E[x^2]-E[x]^2``
    (JAX package ``layers.py:170-175``); returns the input dtype. On a CUDA
    tensor it is the op ``mlaff::layer_norm_fwd`` (``ops/layer_norm.py``:
    one kernel forward, two backward); on the CPU the expression below."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        if x.is_cuda:
            return layer_norm(x, self.weight, self.bias, self.eps)
        return self.expression(x)

    def expression(self, x):
        """The plain expression (the CPU's path; on the card the kernels'
        yardstick): :func:`layer_norm_reference`'s y."""
        return layer_norm_reference(x, self.weight, self.bias, self.eps)[0]


def rel_pos_features(rel_pos: torch.Tensor, rel_pos_width: int):
    """(dx, dy, dist, sin, cos) from table-frame coords ``pos_j - pos_i + R``
    (JAX package ``layers.py:178-194``)."""
    R = rel_pos_width
    return offset_features(rel_pos[..., 0] - R, rel_pos[..., 1] - R)


class Dropout(nn.Module):
    """Element-wise dropout (flax ``nn.Dropout``): in training mode each
    element is kept with probability ``1 - p`` and scaled by ``1 / (1 -
    p)``, else zeroed; at ``p = 1`` everything is zeroed.

    The mask is drawn on the input's device from ``generator`` (a
    ``torch.Generator`` on that device, set by the trainer) or, when it is
    None, from torch's global generator. Inside a tensor-parallel layer
    ``x`` is this rank's block along ``dim`` of the activation, and
    ``group`` the layer's model group: the mask is drawn for the whole
    activation, as one process draws it, and sliced to the rank's block, so
    the model ranks' generators stay in step and each drops its own block.
    Under sequence parallelism ``x`` holds this seq rank's ``tokens``
    (``parallel/comm.py::TokenRange``) along ``token_dim``: the mask is
    drawn for all of the stage's tokens and sliced to the rank's, so the
    seq ranks drop what one process drops.
    """

    def __init__(self, p: float = 0.0):
        super().__init__()
        self.p = float(p)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x, group=None, dim: int = -1, tokens=None,
                token_dim: int = 1):
        if self.p == 0.0 or not self.training:
            return x
        if self.p >= 1.0:
            return torch.zeros_like(x)
        keep = 1.0 - self.p
        parts = comm.size(group)
        shape = list(x.shape)
        shape[dim] *= parts
        if tokens is not None:
            shape[token_dim] = tokens.n
        u = torch.rand(shape, generator=self.generator, device=x.device)
        if parts > 1:
            u = u.chunk(parts, dim=dim)[comm.rank(group)]
        u = comm.slice_tokens(u, tokens, token_dim)
        return torch.where(u < keep, x / keep, torch.zeros_like(x))


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm ``DropPath``, JAX package
    ``layers.py:197-210``): in training mode each sample is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, else zeroed.

    The mask is drawn from ``generator`` (a ``torch.Generator`` on the
    input's device, set by the trainer) or, when it is None, from torch's
    global generator. Under data parallelism it is the global batch's draw,
    sliced to this rank's rows (``parallel/comm.py::global_draw``).
    """

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        u = comm.global_draw(
            lambda rows: torch.rand((rows,) + (1,) * (x.ndim - 1),
                                    generator=self.generator,
                                    device=x.device), x.shape[0])
        mask = u < keep
        return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> dropout -> fc2 -> dropout (JAX package
    ``layers.py:239-261``). Tensor-parallel when ``tp_group`` is set
    (``parallel/tp.py``): fc1 holds this rank's block of the hidden units,
    fc2 the matching input columns."""

    def __init__(self, dim, hidden, out, compute_dtype, drop: float = 0.0):
        super().__init__()
        self.fc1 = Linear(dim, hidden, compute_dtype)
        self.fc2 = Linear(hidden, out, compute_dtype)
        self.drop = Dropout(drop)
        self.tp_group = None

    def forward(self, x, tokens=None):
        if self.tp_group is not None:
            x = comm.copy_to_model(x, self.tp_group)
        x = self.drop(F.gelu(self.fc1(x)), self.tp_group, tokens=tokens)
        return self.drop(row_parallel(self.fc2, x, self.tp_group),
                         tokens=tokens)


class ClusterAttention(nn.Module):
    """Local attention over each token's nearest clusters (the fused kernel)
    or, in global mode, dense attention over all tokens (plain torch).

    ``attn_drop`` drops attention probabilities in training mode: in the
    global mode with :class:`Dropout`; in the local mode inside the fused
    kernels, with one seed per call drawn by
    ``ops/cluster_attention.py::draw_drop_seed`` from
    ``attn_drop_generator`` (a CPU ``torch.Generator`` that the trainer
    owns; torch's default CPU generator when None), as the JAX layer draws
    one from its "dropout" stream. The kernels' masks are a hash of the
    seed and the coordinates, so one generator state drops the same
    probabilities on every device.

    ``clamp_width`` (MixRes: the rel-pos table width, 0 for AFF) clamps the
    local mode's relative coordinates inside the kernel; in the global mode
    the caller's ``pe_feat`` carries the clamp.

    Tensor-parallel when ``tp_group`` is set (``parallel/tp.py``): the
    layer holds ``num_heads`` local heads (its block of q, kv, pos_embed
    and the blank tokens, and proj's matching input columns), runs the
    attention on them and sums proj's partial products over the group. Its
    dropout seed is offset to its first head
    (``ops/cluster_attention.py::head_offset_seed``), so each rank drops
    its heads' probabilities as one process drops them; under data
    parallelism also to the data rank's first image of the global batch
    (``image_offset_seed``), since the kernels hash the image index.

    Under sequence parallelism (``tokens``, this seq rank's
    ``parallel/comm.py::TokenRange``) ``feat`` holds the rank's token rows:
    k and v are gathered over the seq ranks (their gradient summed back),
    and the queries of the range attend to them, the local mode through
    the kernels' query range (``nearest_cluster``, ``tile_meta`` and, in
    the global mode, ``pe_feat`` are the range's rows; ``pos`` is the
    whole stage's).
    """

    def __init__(self, dim, num_heads, rel_pos_width,
                 compute_dtype=torch.float32, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, clamp_width: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.attn_drop = Dropout(attn_drop)
        self.attn_drop_generator: Optional[torch.Generator] = None
        self.proj_drop = Dropout(proj_drop)
        self.rel_pos_width = rel_pos_width
        self.clamp_width = clamp_width
        self.compute_dtype = compute_dtype
        self.q = Linear(dim, dim, compute_dtype)
        self.kv = Linear(dim, 2 * dim, compute_dtype)
        self.pos_embed = Linear(5, num_heads, compute_dtype)
        self.blank_k = nn.Parameter(torch.empty(dim))
        self.blank_v = nn.Parameter(torch.empty(dim))
        self.proj = Linear(dim, dim, compute_dtype)
        self.tp_group = None

    def forward(self, feat, global_attn: bool, pe_feat=None,
                nearest_cluster=None, cluster_size: int = 0, pos=None,
                tile_meta=None, tokens=None):
        if self.tp_group is not None:
            feat = comm.copy_to_model(feat, self.tp_group)
        b, nq, _ = feat.shape
        h = self.num_heads
        c_ = self.q.weight.shape[0] // h
        c = h * c_  # this rank's channels
        q = self.q(feat) * c_**-0.5
        kv = comm.gather_tokens(self.kv(feat), tokens)
        n = kv.shape[1]
        if not global_attn:
            rate = self.attn_drop.p if self.training else 0.0
            seed = None
            if rate > 0.0:
                seed = attention_ops.draw_drop_seed(self.attn_drop_generator)
                if self.tp_group is not None:  # this rank's heads
                    seed = attention_ops.head_offset_seed(
                        seed, comm.rank(self.tp_group) * h)
                # this data rank's images of the global batch
                seed = attention_ops.image_offset_seed(
                    seed, comm.data_coords()[0] * b)
            out = fused_cluster_attention(
                q.contiguous(), kv.contiguous(), nearest_cluster, pos,
                self.pos_embed.weight.t(), self.pos_embed.bias,
                self.blank_k.reshape(h, c_).t(), self.blank_v.reshape(h, c_),
                h, cluster_size, self.rel_pos_width, self.clamp_width,
                drop_rate=rate, drop_seed=seed, meta=tile_meta,
                q0=tokens.lo if tokens is not None else 0,
            )
        else:
            dt = self.compute_dtype
            q = q.reshape(b, nq, h, c_).transpose(1, 2)  # b h nq c_
            kv = kv.reshape(b, n, h, 2, c_).permute(3, 0, 2, 1, 4)
            key, v = kv[0], kv[1]
            blank_attn = (
                q * self.blank_k.to(q.dtype).reshape(1, h, 1, c_)
            ).sum(-1, keepdim=True)  # b h n 1
            bias = self.pos_embed(pe_feat.to(dt)).permute(0, 3, 1, 2)
            attn = torch.matmul(q, key.transpose(-1, -2)) + bias
            attn = torch.cat([attn, blank_attn], dim=-1)
            attn = torch.softmax(attn.float(), dim=-1).to(dt)
            attn = self.attn_drop(attn, self.tp_group, dim=1, tokens=tokens,
                                  token_dim=2)
            blank_w = attn[..., -1:]
            out = torch.matmul(attn[..., :-1], v)
            out = out + blank_w * self.blank_v.to(dt).reshape(1, h, 1, c_)
            out = out.transpose(1, 2).reshape(b, nq, c)
        return self.proj_drop(row_parallel(self.proj, out, self.tp_group),
                              tokens=tokens)


class ClusterTransformerBlock(nn.Module):
    """Pre-LN attention + MLP residual block."""

    def __init__(self, dim, num_heads, mlp_ratio, layer_scale, rel_pos_width,
                 compute_dtype=torch.float32, drop: float = 0.0,
                 attn_drop: float = 0.0, drop_path: float = 0.0,
                 clamp_width: int = 0):
        super().__init__()
        self.norm1 = LayerNormFp32(dim)
        self.attn = ClusterAttention(dim, num_heads, rel_pos_width,
                                     compute_dtype=compute_dtype,
                                     attn_drop=attn_drop, proj_drop=drop,
                                     clamp_width=clamp_width)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNormFp32(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, compute_dtype, drop)
        self.use_layer_scale = layer_scale is not None and layer_scale > 0
        if self.use_layer_scale:
            self.gamma1 = nn.Parameter(torch.full((dim,), float(layer_scale)))
            self.gamma2 = nn.Parameter(torch.full((dim,), float(layer_scale)))

    def forward(self, feat, global_attn, pe_feat, nearest_cluster,
                cluster_size, pos, tile_meta=None, tokens=None):
        x = self.attn(self.norm1(feat), global_attn, pe_feat,
                      nearest_cluster, cluster_size, pos, tile_meta, tokens)
        if self.use_layer_scale:
            feat = feat + self.drop_path(self.gamma1.to(x.dtype) * x)
            y = self.mlp(self.norm2(feat), tokens)
            return feat + self.drop_path(self.gamma2.to(y.dtype) * y)
        feat = feat + self.drop_path(x)
        return feat + self.drop_path(self.mlp(self.norm2(feat), tokens))


class ClusterMerging(nn.Module):
    """Adaptive downsampling (JAX package ``layers.py:513-705``, fused-merge
    route): grid prior + alpha * detached learned importance, coarse-grid
    reserve tokens forced in, then PointConv over each centre's nearest
    clusters with the fused merge kernel (after a global-attention stage,
    ``nearest_cluster`` is None and the neighbourhood is every token, a
    plain contraction)."""

    def __init__(self, dim, out_dim, alpha=4.0, ds_rate=0.25, reserve_on=True,
                 rel_pos_width=55, compute_dtype=torch.float32):
        super().__init__()
        self.alpha = alpha
        self.ds_rate = ds_rate
        self.reserve_on = reserve_on
        self.rel_pos_width = rel_pos_width
        self.compute_dtype = compute_dtype
        self.weight_net = nn.Sequential(
            Linear(5, 4, compute_dtype), LayerNormFp32(4)
        )
        self.norm = LayerNormFp32(4 * dim)
        self.linear = Linear(4 * dim, out_dim, compute_dtype)

    def forward(self, pos, feat, cluster_mask, learned_prob, stride: int,
                reserve_num: int, nearest_cluster, cluster_size: int):
        b, n, c = feat.shape
        d = pos.shape[2]
        keep_num = int(n * self.ds_rate)

        with span("geom.merge_select"):
            # --- grid prior (aff_transformer.py:295-301) ---
            if stride == 2:
                grid_prob = ((pos % stride).sum(-1) == 0).float()
            else:
                min_dist = nearest_other_distance(pos)  # b x n
                ada_stride = 2.0 ** (torch.ceil(torch.log2(min_dist)) + 1)
                grid_prob = (
                    (pos.int() % ada_stride[..., None].int()).sum(-1) == 0
                ).float()
            final_prob = grid_prob + (
                learned_prob.detach().reshape(b, n).float() * self.alpha)

            # --- reserve tokens on a coarse grid ---
            if self.reserve_on:
                reserve_mask = ((pos % (stride * 2)).sum(-1) == 0).float()
                final_prob = final_prob + reserve_mask * (-100.0)
                sample_num = keep_num - reserve_num
            else:
                sample_num = keep_num

            # --- top-k centres: a stable descending sort puts the lower
            # index first on ties, as jax.lax.top_k does (torch.topk
            # promises no order); reserve indices come out in index order ---
            sample_idx = torch.sort(final_prob, dim=-1, descending=True,
                                    stable=True)[1][:, :sample_num]
            if self.reserve_on:
                reserve_idx = torch.sort(reserve_mask, dim=-1,
                                         descending=True,
                                         stable=True)[1][:, :reserve_num]
                idx = torch.cat([sample_idx, reserve_idx], dim=-1)
            else:
                idx = sample_idx
            if idx.shape[1] != keep_num:
                raise ValueError(
                    f"selected {idx.shape[1]} centres != {keep_num}")

        new_pos = gather_rows(pos, idx)
        R = self.rel_pos_width
        if nearest_cluster is None:
            # a global-attention stage: every centre's neighbourhood is all
            # n tokens (JAX package aff.py:260-270, clusten_wf route)
            pos_g = pos[:, None].expand(b, keep_num, n, d)
            lp = learned_prob[:, None].expand(b, keep_num, n, 1)
            sel_mask = sel_ncc = None
        else:
            sel_mask = (None if cluster_mask is None
                        else gather_rows(cluster_mask, idx))
            sel_ncc = gather_rows(nearest_cluster, idx).contiguous()
            pos_g = gather_clusters(pos[:, None], sel_ncc, cluster_size)[:, 0]
            # learned_prob is not detached here: pointconv weights carry it
            lp = gather_clusters(learned_prob[:, None], sel_ncc,
                                 cluster_size)[:, 0]
        sel_rel = rel_pos_features(pos_g - (new_pos[:, :, None, :] - R), R)

        wt = self.weight_net[0](sel_rel.to(self.compute_dtype))
        weights = F.gelu(self.weight_net[1](wt))  # b x n' x m x 4
        inner_ch = weights.shape[-1]
        if sel_mask is not None:
            lp = lp * sel_mask[..., None].to(lp.dtype)
        weights = weights * lp.to(weights.dtype)

        if sel_ncc is None:
            merged = wf_contract(
                weights, feat.to(weights.dtype)[:, None].expand(
                    b, keep_num, n, c))
        else:
            merged = fused_cluster_merge(
                weights.contiguous(), feat.to(weights.dtype).contiguous(),
                sel_ncc, cluster_size,
            )
        merged = merged.reshape(b, keep_num, inner_ch * c)
        return new_pos, self.linear(self.norm(merged))


def batch_norm_train(x, bn: nn.BatchNorm2d, momentum: float = 0.9):
    """BatchNorm over (N, H, W) with batch statistics, as flax's
    ``nn.BatchNorm(use_running_average=False, momentum=0.9)`` computes it
    (JAX package ``layers.py:726-729``): mean and the fast, biased variance
    ``E[x^2] - E[x]^2`` (clamped at 0) in float32, ``y = (x - mean) *
    (rsqrt(var + eps) * scale) + bias``. The running stats are updated in
    place as ``ra = momentum * ra + (1 - momentum) * stat`` with the biased
    variance, written out by hand: ``F.batch_norm(training=True)`` would
    store the unbiased one. Returns float32.

    Under data parallelism the statistics are the global batch's, as in
    JAX's step on a batch-sharded mesh: the sums and sums of squares are
    all-reduced over the data ranks (with their gradient), and the running
    stats take the global values."""
    x32 = x.float()
    _, w, group = comm.data_coords()
    if w == 1:
        mean = x32.mean(dim=(0, 2, 3))
        mean2 = (x32 * x32).mean(dim=(0, 2, 3))
    else:
        count = x32.numel() // x32.shape[1] * w
        sums = comm.all_reduce(torch.stack([x32.sum(dim=(0, 2, 3)),
                                            (x32 * x32).sum(dim=(0, 2, 3))]),
                               group)
        mean, mean2 = sums[0] / count, sums[1] / count
    var = torch.clamp_min(mean2 - mean * mean, 0.0)
    with torch.no_grad():
        bn.running_mean.copy_(momentum * bn.running_mean
                              + (1.0 - momentum) * mean)
        bn.running_var.copy_(momentum * bn.running_var
                             + (1.0 - momentum) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return ((x32 - mean[:, None, None]) * mul[:, None, None]
            + bn.bias[:, None, None])


class PatchEmbed(nn.Module):
    """Two stride-2 3x3 convs (NCHW) with BatchNorm (batch statistics in
    training mode, running stats at eval) and GELU between, then LayerNorm; emits row-major tokens and their
    integer grid positions (x, y) (JAX package ``layers.py:708-743``)."""

    def __init__(self, embed_dim=32, use_norm=True, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.proj1 = nn.Conv2d(3, embed_dim // 2, 3, stride=2, padding=1)
        self.bn = nn.BatchNorm2d(embed_dim // 2, eps=1e-5, momentum=0.1)
        self.proj2 = nn.Conv2d(embed_dim // 2, embed_dim, 3, stride=2,
                               padding=1)
        self.norm = LayerNormFp32(embed_dim) if use_norm else None

    def _conv(self, conv, x):
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt),
                        stride=conv.stride, padding=conv.padding)

    def forward(self, x) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
        x = self._conv(self.proj1, x)
        if self.training:
            x = batch_norm_train(x, self.bn)
        else:
            x = F.batch_norm(x.float(), self.bn.running_mean,
                             self.bn.running_var, self.bn.weight, self.bn.bias,
                             False, 0.0, self.bn.eps)
        x = self._conv(self.proj2, F.gelu(x))
        b, c, h, w = x.shape
        feat = x.flatten(2).transpose(1, 2)  # b x (h*w) x c, row-major
        if self.norm is not None:
            feat = self.norm(feat)
        ys, xs = torch.meshgrid(torch.arange(h, device=x.device),
                                torch.arange(w, device=x.device), indexing="ij")
        pos = torch.stack([xs, ys], dim=2).reshape(1, h * w, 2).float()
        return pos.expand(b, h * w, 2), feat, h, w
