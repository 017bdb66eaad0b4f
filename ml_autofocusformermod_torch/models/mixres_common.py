"""Shared MixRes components (counterpart of the JAX package's
``models/mixres_common.py``): sine PE, scale-coordinate grids, MLP ladders,
overlap patch embeddings and scale partitioning.

Tokens carry a 3-vector position ``(scale, x, y)`` in min-patch units. The
per-scale token counts follow from the split cascade alone, so the models
thread a host ``layout: {scale: count}`` and :func:`extract_scale` picks a
scale's tokens with a stable argsort on the mismatch flag: the same tokens
in the same relative order, with no device sync.

Compute-dtype semantics are those of ``models/layers.py``: f32 parameters,
explicit casts, LayerNorm and the norms of the conv blocks in f32.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cluster_gather import gather_rows
from ..utils.profiling import span
from .layers import LayerNormFp32, Linear, batch_norm_train

__all__ = [
    "MIXRES_REL_POS_WIDTH", "MIXRES_TABLE_WIDTH", "sine_position_embedding",
    "scale_grid_positions", "grid_positions", "extract_scale", "MLPBlock",
    "MLPDeepNorm", "MLP", "DownSampleConvBlock", "OverlapPatchEmbedding",
    "gather_image_patches", "init_mixres_weights",
]

# the reference sizes the MixRes relative-position table for inputs up to
# 2048 x 2048 (JAX package mixres_common.py:31-34)
MIXRES_REL_POS_WIDTH = 2048 // 4 - 1
MIXRES_TABLE_WIDTH = 2 * MIXRES_REL_POS_WIDTH + 1


def sine_position_embedding(pos: torch.Tensor, num_pos_feats: int,
                            temperature: float = 10000.0,
                            normalize: bool = True,
                            scale: Optional[float] = None) -> torch.Tensor:
    """DETR-style sine embedding of (b, n, 2) positions (x, y), f32.

    The positions are normalised by their max over the WHOLE batch, not per
    image, as in the JAX package. Under data parallelism no collective is
    needed: both callers pass the same grid for every image, so each
    rank's max is the global batch's."""
    if scale is None:
        scale = 2 * math.pi
    x_embed = pos[:, :, 0].float()
    y_embed = pos[:, :, 1].float()
    if normalize:
        eps = 1e-6
        y_embed = torch.clamp(y_embed / (y_embed.max() + eps), 0, 1) * scale
        x_embed = torch.clamp(x_embed / (x_embed.max() + eps), 0, 1) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=pos.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    pos_x = x_embed[:, :, None] / dim_t
    pos_y = y_embed[:, :, None] / dim_t
    pos_x = torch.cat([torch.sin(pos_x[:, :, 0::2]),
                       torch.cos(pos_x[:, :, 1::2])], dim=2)
    pos_y = torch.cat([torch.sin(pos_y[:, :, 0::2]),
                       torch.cos(pos_y[:, :, 1::2])], dim=2)
    return torch.cat([pos_x, pos_y], dim=2)


@functools.lru_cache(maxsize=None)
def scale_grid_positions(height: int, width: int, patch_size: int,
                         min_patch_size: int, scale: int) -> np.ndarray:
    """(n, 3) float32 rows of (scale, x, y): the patch corners in min-patch
    units, x varying fastest (host constants)."""
    step = patch_size // min_patch_size
    xs = np.arange(0, width // min_patch_size, step)
    ys = np.arange(0, height // min_patch_size, step)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    coords = np.stack([gx, gy], axis=2).reshape(-1, 2)
    out = np.concatenate([np.full((coords.shape[0], 1), scale), coords],
                         axis=1)
    return out.astype(np.float32)


_GRIDS: Dict[tuple, torch.Tensor] = {}


def grid_positions(height: int, width: int, patch_size: int,
                   min_patch_size: int, scale: int,
                   device: torch.device) -> torch.Tensor:
    """:func:`scale_grid_positions` as a tensor on ``device``, moved there
    once per arguments."""
    key = (height, width, patch_size, min_patch_size, scale, str(device))
    if key not in _GRIDS:
        _GRIDS[key] = torch.as_tensor(
            scale_grid_positions(height, width, patch_size, min_patch_size,
                                 scale), device=device)
    return _GRIDS[key]


def extract_scale(feat: torch.Tensor, pos: torch.Tensor, scale: int,
                  count: int, extra: Optional[torch.Tensor] = None):
    """The ``count`` tokens whose scale channel equals ``scale``, in their
    relative order, and the rest: ``(feat_s, pos_s, feat_r, pos_r[,
    extra_s])``. A stable argsort on the mismatch flag (JAX package
    ``mixres_common.py:81-103``)."""
    with span("geom.reorder"):
        mismatch = (pos[:, :, 0] != scale).to(torch.int32)
        order = torch.argsort(mismatch, dim=1, stable=True)  # matches first
        sel, rest = order[:, :count], order[:, count:]
        out = (gather_rows(feat, sel), gather_rows(pos, sel),
               gather_rows(feat, rest), gather_rows(pos, rest))
        if extra is not None:
            return out + (gather_rows(extra, sel),)
        return out


class MLPBlock(nn.Module):
    """Linear -> exact GELU -> LayerNorm."""

    def __init__(self, in_dim, out_dim, compute_dtype=torch.float32):
        super().__init__()
        self.linear = Linear(in_dim, out_dim, compute_dtype)
        self.norm = LayerNormFp32(out_dim)

    def forward(self, x):
        return self.norm(F.gelu(self.linear(x)))


class MLPDeepNorm(nn.Module):
    """A ladder of ``num_layers`` :class:`MLPBlock`."""

    def __init__(self, in_dim, hidden_features, out_features,
                 num_layers: int = 3, compute_dtype=torch.float32):
        super().__init__()
        dims = [hidden_features] * (num_layers - 1) + [out_features]
        self.layers = nn.ModuleList(
            MLPBlock(d_in, d, compute_dtype)
            for d_in, d in zip([in_dim] + dims[:-1], dims))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class MLP(nn.Module):
    """ReLU MLP head."""

    def __init__(self, in_dim, hidden_dim, output_dim, num_layers,
                 compute_dtype=torch.float32):
        super().__init__()
        dims = [hidden_dim] * (num_layers - 1) + [output_dim]
        self.layers = nn.ModuleList(
            Linear(d_in, d, compute_dtype)
            for d_in, d in zip([in_dim] + dims[:-1], dims))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < len(self.layers) - 1:
                x = F.relu(x)
        return x


class DownSampleConvBlock(nn.Module):
    """3x3 conv, stride 2, padding 1 -> LeakyReLU(0.01) -> BatchNorm
    (``norm="batch"``: running stats at eval, batch stats in training,
    momentum 0.9 as flax counts it) or GroupNorm(1) (``norm="group"``),
    eps 1e-5, in f32. NCHW in and out, compute dtype out."""

    def __init__(self, in_dim, out_dim, norm="batch",
                 compute_dtype=torch.float32):
        super().__init__()
        if norm not in ("batch", "group"):
            raise ValueError(f"norm must be 'batch' or 'group', got {norm!r}")
        self.compute_dtype = compute_dtype
        self.conv = nn.Conv2d(in_dim, out_dim, 3, stride=2, padding=1)
        if norm == "batch":
            self.b_norm = nn.BatchNorm2d(out_dim, eps=1e-5)
        else:
            self.g_norm = nn.GroupNorm(1, out_dim, eps=1e-5)

    def forward(self, x):
        dt = self.compute_dtype
        x = F.conv2d(x.to(dt), self.conv.weight.to(dt),
                     self.conv.bias.to(dt), stride=2, padding=1)
        x = F.leaky_relu(x, 0.01)
        if hasattr(self, "g_norm"):
            g = self.g_norm
            x = F.group_norm(x.float(), 1, g.weight, g.bias, g.eps)
        elif self.training:
            x = batch_norm_train(x, self.b_norm)
        else:
            bn = self.b_norm
            x = F.batch_norm(x.float(), bn.running_mean, bn.running_var,
                             bn.weight, bn.bias, False, 0.0, bn.eps)
        return x.to(dt)


class OverlapPatchEmbedding(nn.Module):
    """log2(patch_size) stride-2 :class:`DownSampleConvBlock` and a final
    LayerNorm: NHWC images in, (b, n, c) row-major tokens out."""

    def __init__(self, patch_size, embed_dim, norm="batch", in_chans=3,
                 compute_dtype=torch.float32):
        super().__init__()
        n_layers = int(math.log2(patch_size))
        dims = [int(embed_dim // 2 ** (n_layers - 1 - i))
                for i in range(n_layers)]
        self.conv_layers = nn.ModuleList(
            DownSampleConvBlock(d_in, d, norm, compute_dtype)
            for d_in, d in zip([in_chans] + dims[:-1], dims))
        self.out_norm = LayerNormFp32(dims[-1])

    def forward(self, im):
        x = im.permute(0, 3, 1, 2)  # NHWC memory, NCHW view (channels-last)
        for layer in self.conv_layers:
            x = layer(x)
        return self.out_norm(x.flatten(2).transpose(1, 2))


def gather_image_patches(im: torch.Tensor, pos2d: torch.Tensor,
                         patch_size: int, min_patch_size: int) -> torch.Tensor:
    """Raw pixels under each token's patch, (b, n, patch_size**2 * 3),
    ordered x-fastest, then channels. ``im`` (b, H, W, 3) NHWC; ``pos2d``
    (b, n, 2) patch corners in min-patch units."""
    b, H, W, _ = im.shape
    n = pos2d.shape[1]
    ar = torch.arange(patch_size, device=im.device)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    offs = torch.stack([gx, gy], dim=2).reshape(-1, 2)  # ps*ps x 2
    pp = (pos2d * min_patch_size)[:, :, None, :] + offs  # b n p 2
    idx = (pp[..., 1] * W + pp[..., 0]).long().reshape(b, -1)
    pix = gather_rows(im.reshape(b, H * W, 3), idx)  # b n*p 3
    return pix.reshape(b, n, patch_size * patch_size * 3)


# bare parameters drawn from N(0, 1)
_UNIT_NORMAL = ("blank_k", "blank_v", "rel_pos_emb", "scale_emb")


@torch.no_grad()
def init_mixres_weights(model: nn.Module, generator: torch.Generator):
    """Seeded random init in the JAX package's distributions: truncated
    normal (std 0.02) linears with zero bias, LeCun-normal convs (the
    depthwise ones included), unit norms, N(0, 1) blank tokens and split
    embeddings; importances stay 1, register tokens 0, layer-scale gammas
    at their constant."""
    for mod in model.modules():
        if isinstance(mod, Linear):
            mod.reset_parameters(generator)
        elif isinstance(mod, nn.Conv2d):
            std = mod.weight[0].numel() ** -0.5
            nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            nn.init.zeros_(mod.bias)
    for name, p in model.named_parameters():
        if name.endswith(_UNIT_NORMAL):
            nn.init.normal_(p, 0.0, 1.0, generator=generator)
    return model
