"""MixResViT: the global-attention MaskFiner level (counterpart of the JAX
package's ``models/mixres_vit.py``).

The coarsest (32x32-patch) encoder level and the last decoder level: dense
pre-LN attention blocks whose FeedForward carries a 3x3 depthwise conv over
the token grid. The dense attention is plain torch (``torch.matmul`` and an
f32 softmax), as the JAX package computes it outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Dropout, DropPath, LayerNormFp32, Linear
from .mixres_common import (
    OverlapPatchEmbedding,
    grid_positions,
    sine_position_embedding,
)

__all__ = ["DWConv", "FeedForward", "Attention", "Block", "MixResViT"]


class DWConv(nn.Module):
    """Depthwise 3x3 conv over the (h, w) token grid, (b, n, c) in and
    out."""

    def __init__(self, dim, compute_dtype=torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x, h: int, w: int):
        b, n, c = x.shape
        dt = self.compute_dtype
        img = x.to(dt).reshape(b, h, w, c).permute(0, 3, 1, 2)
        img = F.conv2d(img, self.dwconv.weight.to(dt),
                       self.dwconv.bias.to(dt), padding=1, groups=c)
        return img.permute(0, 2, 3, 1).reshape(b, n, c)


class FeedForward(nn.Module):
    """fc1 -> (dwconv) -> exact GELU -> dropout -> fc2 -> dropout."""

    def __init__(self, dim, hidden_dim, dropout=0.0, dw_conv=True,
                 out_dim=None, compute_dtype=torch.float32):
        super().__init__()
        self.fc1 = Linear(dim, hidden_dim, compute_dtype)
        self.dwconv = DWConv(hidden_dim, compute_dtype) if dw_conv else None
        self.fc2 = Linear(hidden_dim, out_dim or dim, compute_dtype)
        self.drop = Dropout(dropout)

    def forward(self, x, h: int, w: int):
        x = self.fc1(x)
        if self.dwconv is not None:
            x = self.dwconv(x, h, w)
        x = self.drop(F.gelu(x))
        return self.drop(self.fc2(x))


class Attention(nn.Module):
    """Dense multi-head self-attention: q.k in the compute dtype, scaled
    after the product, softmax in f32."""

    def __init__(self, dim, heads, dropout=0.0, compute_dtype=torch.float32):
        super().__init__()
        self.heads = heads
        self.compute_dtype = compute_dtype
        self.qkv = Linear(dim, 3 * dim, compute_dtype)
        self.proj = Linear(dim, dim, compute_dtype)
        self.drop = Dropout(dropout)

    def forward(self, x):
        b, n, c = x.shape
        h = self.heads
        c_ = c // h
        qkv = self.qkv(x).reshape(b, n, 3, h, c_).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # b h n c_
        attn = torch.matmul(q, k.transpose(-1, -2)) * c_**-0.5
        attn = torch.softmax(attn.float(), dim=-1).to(self.compute_dtype)
        out = torch.matmul(self.drop(attn), v)
        out = out.transpose(1, 2).reshape(b, n, c)
        return self.drop(self.proj(out))


class Block(nn.Module):
    """Pre-LN attention + FeedForward block with optional LayerScale."""

    def __init__(self, dim, heads, mlp_dim, dropout=0.0, drop_path=0.0,
                 layer_scale=0.0, compute_dtype=torch.float32):
        super().__init__()
        self.norm1 = LayerNormFp32(dim)
        self.attn = Attention(dim, heads, dropout, compute_dtype)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNormFp32(dim)
        self.mlp = FeedForward(dim, mlp_dim, dropout,
                               compute_dtype=compute_dtype)
        self.use_layer_scale = layer_scale is not None and layer_scale > 0
        if self.use_layer_scale:
            self.gamma1 = nn.Parameter(torch.full((dim,), float(layer_scale)))
            self.gamma2 = nn.Parameter(torch.full((dim,), float(layer_scale)))

    def forward(self, x, h: int, w: int):
        y = self.attn(self.norm1(x))
        if self.use_layer_scale:
            x = x + self.drop_path(self.gamma1.to(y.dtype) * y)
            z = self.mlp(self.norm2(x), h, w)
            return x + self.drop_path(self.gamma2.to(z.dtype) * z)
        x = x + self.drop_path(y)
        return x + self.drop_path(self.mlp(self.norm2(x), h, w))


class MixResViT(nn.Module):
    """The global-attention MaskFiner level.

    ``first_layer``: overlap patch embedding (GroupNorm convs) plus the
    sine PE on a fresh grid. Otherwise LayerNorm and a linear projection of
    the incoming tokens. Emits the ``res*`` output dict and the layout.
    """

    def __init__(self, patch_sizes: Sequence[int], n_layers: int,
                 d_model: int, n_heads: int, mlp_ratio: float = 4.0,
                 dropout: float = 0.0,
                 drop_path_rate: Sequence[float] = (0.0,), channels: int = 3,
                 split_ratio: int = 4, n_scales: int = 2,
                 min_patch_size: int = 4, upscale_ratio: float = 0.0,
                 first_layer: bool = True, layer_scale: float = 0.0,
                 num_register_tokens: int = 0,
                 out_features: Sequence[str] = ("res5",),
                 compute_dtype=torch.float32):
        super().__init__()
        self.patch_sizes = tuple(patch_sizes)
        self.d_model = d_model
        self.channels = channels
        self.min_patch_size = min_patch_size
        self.upscale_ratio = upscale_ratio
        self.first_layer = first_layer
        self.num_register_tokens = num_register_tokens
        self.out_features = tuple(out_features)
        if first_layer:
            self.patch_embed = OverlapPatchEmbedding(
                self.patch_size, d_model, norm="group",
                compute_dtype=compute_dtype)
        else:
            self.token_norm = LayerNormFp32(channels)
            if channels != d_model:
                self.token_projection = Linear(channels, d_model,
                                               compute_dtype)
        if num_register_tokens:
            self.register_tokens = nn.Parameter(
                torch.zeros(1, num_register_tokens, d_model))
        dpr = list(drop_path_rate)
        self.layers = nn.ModuleDict({"blocks": nn.ModuleList(
            Block(d_model, n_heads, int(d_model * mlp_ratio), dropout,
                  dpr[i] if i < len(dpr) else dpr[-1], layer_scale,
                  compute_dtype)
            for i in range(n_layers))})
        self.norm_out = LayerNormFp32(d_model)

    @property
    def patch_size(self) -> int:
        return self.patch_sizes[-1]

    def forward(self, im: torch.Tensor, scale: int,
                features: Optional[torch.Tensor],
                features_pos: Optional[torch.Tensor],
                upsampling_mask: Optional[torch.Tensor],
                layout: Dict[int, int]) -> Tuple[Dict[str, Any],
                                                 Dict[int, int]]:
        """``im`` (b, H, W, 3) NHWC; ``features`` (b, n, channels) and
        ``features_pos`` (b, n, 3) when not the first layer."""
        b, H, W, _ = im.shape
        ps = self.patch_size
        patched = (H // ps, W // ps)
        min_patched = (H // self.min_patch_size, W // self.min_patch_size)
        if self.first_layer:
            x = self.patch_embed(im)
            grid = grid_positions(H, W, ps, self.min_patch_size, scale,
                                  im.device)
            pos = grid[None].expand(b, *grid.shape)
            x = x + sine_position_embedding(
                pos[:, :, 1:], self.d_model // 2).to(x.dtype)
            layout = {scale: grid.shape[0]}
        else:
            x = self.token_norm(features)
            if self.channels != self.d_model:
                x = self.token_projection(x)
            pos = features_pos
        if self.num_register_tokens:
            reg = self.register_tokens.to(x.dtype)
            x = torch.cat([reg.expand(b, *reg.shape[1:]), x], dim=1)
        for blk in self.layers["blocks"]:
            x = blk(x, patched[0], patched[1])
        x = x[:, self.num_register_tokens:]

        name = self.out_features[0]
        outs: Dict[str, Any] = {
            name: self.norm_out(x),
            name + "_pos": pos[:, :, 1:],
            name + "_spatial_shape": patched,
            name + "_scale": pos[:, :, 0],
            "min_spatial_shape": min_patched,
        }
        return outs, dict(layout)
