"""AFF building blocks of the plain reference.

A frozen copy of the plain paths of the measured package's
``models/layers.py``, ``ops/cluster_attention.py`` (the gather-based
attention) and ``ops/cluster_merge.py`` (the gather-based merge), with
the same parameter names in the same state-dict order, so that one state
dict, and one flat draw of weights over it, loads into both. No kernel,
element-wise dropout, remat or parallel path: every product runs through
a :class:`~h100bench.reference.precision.Precision`, everything else in
float32. LayerNorm uses the fast variance ``E[x^2] - E[x]^2`` and
BatchNorm in training mode the biased batch variance, as the model
defines them.

Stochastic depth is replayed: :func:`draw_drop_masks` draws a training
forward's per-sample keep masks up front from a generator seeded as the
program's, one ``rand((b, 1, 1))`` per :class:`DropPath` call in the
program's forward order, and each :class:`DropPath` holds its two, so a
checkpointed block's recompute reads the masks its forward read.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .geometry import (cluster_token_index, gather_clusters, gather_rows,
                       nearest_other_distance)
from .precision import Precision


class Linear(nn.Module):
    def __init__(self, din: int, dout: int, prec: Precision):
        super().__init__()
        self.prec = prec
        self.weight = nn.Parameter(torch.zeros(dout, din))
        self.bias = nn.Parameter(torch.zeros(dout))

    def forward(self, x):
        return self.prec.linear(x, self.weight, self.bias)


class LayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


def batch_norm(x, bn: nn.BatchNorm2d, training: bool, momentum: float = 0.9):
    """BatchNorm2d in float32: batch statistics (biased variance, running
    stats updated with flax's momentum) in training, running stats at
    eval."""
    x = x.float()
    if not training:
        return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight,
                            bn.bias, False, 0.0, bn.eps)
    mean = x.mean(dim=(0, 2, 3))
    var = torch.clamp_min((x * x).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
    with torch.no_grad():
        bn.running_mean.mul_(momentum).add_((1 - momentum) * mean)
        bn.running_var.mul_(momentum).add_((1 - momentum) * var)
    mul = torch.rsqrt(var + bn.eps) * bn.weight
    return (x - mean[:, None, None]) * mul[:, None, None] \
        + bn.bias[:, None, None]


def offset_features(dx, dy):
    """(..., 5) features (dx, dy, dist, sin, cos) of the offsets; sin and
    cos are 0 where dist is 0."""
    dist = torch.sqrt(dx * dx + dy * dy)
    zero = dist == 0
    safe = torch.where(zero, torch.ones_like(dist), dist)
    sin = torch.where(zero, torch.zeros_like(dist), dy / safe)
    cos = torch.where(zero, torch.zeros_like(dist), dx / safe)
    return torch.stack([dx, dy, dist, sin, cos], dim=-1)


def local_attention(prec, q, kv, ncc, pos, pe_w, pe_b, blank_k, blank_v, h,
                    cs, rel_width, clamp_width, chunk):
    """Each query attends over its ``nnc`` nearest clusters' tokens and a
    learned blank token, with a relative-position bias: one softmax over
    the slots that hold a token and the blank. ``q`` is scaled already;
    ``kv`` (b, n, 2c) holds k and v interleaved per head. With ``chunk``
    the queries go ``chunk`` rows at a time, each under ``checkpoint``, so
    that only one chunk's gathered keys and values are held."""
    b, n, c = q.shape
    c_ = c // h
    qh = q.float().reshape(b, n, h, c_).permute(0, 2, 1, 3)
    kvh = kv.float().reshape(b, n, h, 2, c_)
    kh = kvh[..., 0, :].permute(0, 2, 1, 3)
    vh = kvh[..., 1, :].permute(0, 2, 1, 3)
    args = (pe_w, pe_b, blank_k, blank_v, cs, rel_width, clamp_width)
    if not chunk or chunk >= n:
        out = _attend(prec, qh, kh, vh, ncc, pos, pos, *args)
    else:
        out = torch.cat([torch.utils.checkpoint.checkpoint(
            _attend, prec, qh[:, :, i:i + chunk], kh, vh,
            ncc[:, i:i + chunk], pos, pos[:, i:i + chunk], *args,
            use_reentrant=False) for i in range(0, n, chunk)], dim=2)
    return out.permute(0, 2, 1, 3).reshape(b, n, c)


def _attend(prec, qh, kh, vh, ncc, pos, pos_q, pe_w, pe_b, blank_k, blank_v,
            cs, rel_width, clamp_width):
    """(b, h, nq, c_) outputs of the queries ``qh`` at ``pos_q`` over the
    clusters ``ncc`` (b, nq, nnc) of the ``n`` tokens ``kh``, ``vh`` at
    ``pos``."""
    h, n, c_ = kh.shape[1], kh.shape[2], kh.shape[3]
    pos_g = gather_clusters(pos[:, None].float(), ncc, cs)[:, 0]
    rel = pos_g - pos_q[:, :, None, :].float()
    if clamp_width:
        rel = torch.clamp(rel + rel_width, 0, clamp_width - 1) - rel_width
    feat5 = offset_features(rel[..., 0], rel[..., 1])  # b n m 5
    bias = prec.einsum("bnmf,hf->bhnm", feat5, pe_w) \
        + pe_b.float()[None, :, None, None]
    kg = gather_clusters(kh, ncc, cs)
    vg = gather_clusters(vh, ncc, cs)
    logits = prec.einsum("bhic,bhimc->bhim", qh, kg) + bias
    valid = (cluster_token_index(ncc, cs) < n)[:, None]
    logits = logits.masked_fill(~valid, float("-inf"))
    bk = blank_k.float().reshape(h, c_)
    blank = prec.einsum("bhic,hc->bhi", qh, bk)[..., None]
    mx = torch.maximum(logits.amax(-1, keepdim=True), blank).detach()
    p = torch.exp(logits - mx)
    pb = torch.exp(blank - mx)
    denom = p.sum(-1, keepdim=True) + pb
    p, pb = p / denom, pb / denom
    return prec.einsum("bhim,bhimc->bhic", p, vg) \
        + pb * blank_v.float().reshape(1, h, 1, c_)


def dense_attention(prec, q, kv, pe_feat, pos_embed, blank_k, blank_v, h):
    """Every query over every token and the blank token, with the bias of
    ``pe_feat`` (b, n, n, 5) through ``pos_embed``."""
    b, n, c = q.shape
    c_ = c // h
    qh = q.float().reshape(b, n, h, c_).transpose(1, 2)
    kvh = kv.float().reshape(b, n, h, 2, c_).permute(3, 0, 2, 1, 4)
    key, v = kvh[0], kvh[1]
    blank = (qh * blank_k.float().reshape(1, h, 1, c_)).sum(-1, keepdim=True)
    bias = pos_embed(pe_feat).permute(0, 3, 1, 2)
    attn = prec.matmul(qh, key.transpose(-1, -2)) + bias
    attn = torch.softmax(torch.cat([attn, blank], dim=-1), dim=-1)
    out = prec.matmul(attn[..., :-1], v) \
        + attn[..., -1:] * blank_v.float().reshape(1, h, 1, c_)
    return out.transpose(1, 2).reshape(b, n, c)


class ClusterAttention(nn.Module):
    def __init__(self, dim, num_heads, rel_pos_width, prec, clamp_width,
                 chunk):
        super().__init__()
        self.prec = prec
        self.num_heads = num_heads
        self.rel_pos_width = rel_pos_width
        self.clamp_width = clamp_width
        self.chunk = chunk
        self.q = Linear(dim, dim, prec)
        self.kv = Linear(dim, 2 * dim, prec)
        self.pos_embed = Linear(5, num_heads, prec)
        self.blank_k = nn.Parameter(torch.zeros(dim))
        self.blank_v = nn.Parameter(torch.zeros(dim))
        self.proj = Linear(dim, dim, prec)

    def forward(self, x, global_attn, pe_feat, ncc, cs, pos):
        h = self.num_heads
        q = self.q(x) * (x.shape[-1] // h) ** -0.5
        kv = self.kv(x)
        if global_attn:
            out = dense_attention(self.prec, q, kv, pe_feat, self.pos_embed,
                                  self.blank_k, self.blank_v, h)
        else:
            out = local_attention(
                self.prec, q, kv, ncc, pos, self.pos_embed.weight,
                self.pos_embed.bias, self.blank_k, self.blank_v, h, cs,
                self.rel_pos_width, self.clamp_width, self.chunk)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim, hidden, prec):
        super().__init__()
        self.fc1 = Linear(dim, hidden, prec)
        self.fc2 = Linear(hidden, dim, prec)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class DropPath(nn.Module):
    """Per-sample stochastic depth in training: a sample is kept where its
    draw is below ``1 - rate`` and scaled by ``1 / (1 - rate)``, else
    zeroed. ``masks`` holds the two draws of the step (the attention
    branch's, the MLP branch's), set by :func:`draw_drop_masks`."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.masks = None

    def forward(self, x, which: int):
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        return torch.where(self.masks[which] < keep, x / keep,
                           torch.zeros_like(x))


def draw_drop_masks(model: nn.Module, generator, b: int, device) -> None:
    """A training forward's keep masks: two ``rand((b, 1, 1))`` draws from
    ``generator`` for each :class:`DropPath` of ``model`` whose rate is
    not 0, in the order of the model's modules, which is the order its
    forward calls them."""
    for mod in model.modules():
        if isinstance(mod, DropPath) and mod.rate != 0.0:
            if generator is None:
                raise ValueError("DropPath needs the model's drop_generator")
            mod.masks = [torch.rand((b, 1, 1), generator=generator,
                                    device=device) for _ in range(2)]


def drop_path_rates(rate: float, depths) -> list:
    """The rate of each block, rising linearly from 0 over all blocks."""
    return np.linspace(0, rate, sum(depths)).tolist()


class ClusterTransformerBlock(nn.Module):
    """Pre-LN attention + MLP residual block; with ``layer_scale`` each
    branch is scaled by its learned ``gamma1`` / ``gamma2`` before
    stochastic depth."""

    def __init__(self, dim, num_heads, mlp_ratio, rel_pos_width, prec,
                 clamp_width, layer_scale, drop_path, chunk):
        super().__init__()
        if layer_scale:
            self.gamma1 = nn.Parameter(torch.zeros(dim))
            self.gamma2 = nn.Parameter(torch.zeros(dim))
        self.norm1 = LayerNorm(dim)
        self.attn = ClusterAttention(dim, num_heads, rel_pos_width, prec,
                                     clamp_width, chunk)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), prec)

    def forward(self, x, global_attn, pe_feat, ncc, cs, pos):
        y = self.attn(self.norm1(x), global_attn, pe_feat, ncc, cs, pos)
        return residual(self, x, y, lambda t: self.mlp(self.norm2(t)))


def residual(block, x, y, mlp):
    """``x + y`` then the MLP branch, each branch through the block's
    ``gamma`` (when it has one) and ``drop_path``."""
    gamma = getattr(block, "gamma1", None) is not None
    x = x + block.drop_path(block.gamma1 * y if gamma else y, 0)
    z = mlp(x)
    return x + block.drop_path(block.gamma2 * z if gamma else z, 1)


def run_blocks(blocks, x, checkpoint: bool, *args):
    """The blocks in turn; with ``checkpoint`` each block's activations are
    recomputed in the backward (``torch.utils.checkpoint``), to fit a
    whole batch in float32."""
    for blk in blocks:
        if checkpoint and torch.is_grad_enabled():
            x = torch.utils.checkpoint.checkpoint(blk, x, *args,
                                                  use_reentrant=False)
        else:
            x = blk(x, *args)
    return x


class ClusterMerging(nn.Module):
    """Adaptive downsampling: grid prior + alpha * detached importance,
    coarse-grid reserve tokens forced in, then a PointConv of each centre's
    neighbour clusters."""

    def __init__(self, dim, out_dim, alpha, ds_rate, rel_pos_width, prec):
        super().__init__()
        self.prec = prec
        self.alpha = alpha
        self.ds_rate = ds_rate
        self.rel_pos_width = rel_pos_width
        self.weight_net = nn.Sequential(Linear(5, 4, prec), LayerNorm(4))
        self.norm = LayerNorm(4 * dim)
        self.linear = Linear(4 * dim, out_dim, prec)

    def forward(self, pos, feat, cluster_mask, learned_prob, stride,
                reserve_num, ncc, cs):
        b, n, c = feat.shape
        d = pos.shape[2]
        keep_num = int(n * self.ds_rate)
        if stride == 2:
            grid_prob = ((pos % stride).sum(-1) == 0).float()
        else:
            ada = 2.0 ** (torch.ceil(torch.log2(nearest_other_distance(pos)))
                          + 1)
            grid_prob = ((pos.int() % ada[..., None].int()).sum(-1)
                         == 0).float()
        final = grid_prob + learned_prob.detach().reshape(b, n) * self.alpha
        reserve = ((pos % (stride * 2)).sum(-1) == 0).float()
        final = final + reserve * -100.0
        sample = torch.sort(final, dim=-1, descending=True,
                            stable=True)[1][:, :keep_num - reserve_num]
        kept = torch.sort(reserve, dim=-1, descending=True,
                          stable=True)[1][:, :reserve_num]
        idx = torch.cat([sample, kept], dim=-1)
        new_pos = gather_rows(pos, idx)
        if ncc is None:
            pos_g = pos[:, None].expand(b, keep_num, n, d)
            lp = learned_prob[:, None].expand(b, keep_num, n, 1)
            feat_g = feat[:, None].expand(b, keep_num, n, c)
        else:
            sel = gather_rows(ncc, idx)
            pos_g = gather_clusters(pos[:, None], sel, cs)[:, 0]
            lp = gather_clusters(learned_prob[:, None], sel, cs)[:, 0]
            if cluster_mask is not None:
                lp = lp * gather_rows(cluster_mask, idx)[..., None].float()
            feat_g = gather_clusters(feat[:, None], sel, cs)[:, 0]
        rel = pos_g - new_pos[:, :, None, :]
        wt = self.weight_net[1](self.weight_net[0](offset_features(
            rel[..., 0], rel[..., 1])))
        weights = F.gelu(wt) * lp
        merged = self.prec.einsum("bnmi,bnmc->bnic", weights, feat_g)
        merged = merged.reshape(b, keep_num, 4 * c)
        return new_pos, self.linear(self.norm(merged))


class PatchEmbed(nn.Module):
    """Two stride-2 3x3 convs with BatchNorm and GELU between, then
    LayerNorm; row-major tokens and their (x, y) grid positions."""

    def __init__(self, embed_dim, prec):
        super().__init__()
        self.prec = prec
        self.proj1 = nn.Conv2d(3, embed_dim // 2, 3, stride=2, padding=1)
        self.bn = nn.BatchNorm2d(embed_dim // 2, eps=1e-5)
        self.proj2 = nn.Conv2d(embed_dim // 2, embed_dim, 3, stride=2,
                               padding=1)
        self.norm = LayerNorm(embed_dim)

    def forward(self, x):
        p = self.prec
        x = p.conv2d(x, self.proj1.weight, self.proj1.bias, stride=2,
                     padding=1)
        x = batch_norm(x, self.bn, self.training)
        x = p.conv2d(F.gelu(x), self.proj2.weight, self.proj2.bias, stride=2,
                     padding=1)
        b, c, h, w = x.shape
        feat = self.norm(x.flatten(2).transpose(1, 2))
        ys, xs = torch.meshgrid(torch.arange(h, device=x.device),
                                torch.arange(w, device=x.device),
                                indexing="ij")
        pos = torch.stack([xs, ys], dim=2).reshape(1, h * w, 2).float()
        return pos.expand(b, h * w, 2), feat, h, w


def no_dropout(rate: Optional[float], what: str) -> None:
    if rate:
        raise ValueError(f"{what}={rate}: the reference has no dropout; the "
                         "benchmark's configurations set it to 0")
