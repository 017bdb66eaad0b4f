"""AutoFocusFormer: 4-stage off-grid vision backbone (counterpart of the JAX
package's ``models/aff.py``, ``use_pallas=True`` route). The JAX
``training`` flag is ``module.train()``.

Stage 1 (tokens on the regular grid) takes its clustering and kNN as host
constants cached on the device (``ops/sfc.py::grid_tensors``); later local
stages cluster with :func:`space_filling_cluster` + :func:`knn`. Local
stages run the fused cluster-attention kernel; a stage whose neighbourhood
covers all its tokens (AFF stage 4) runs dense global attention in plain
torch. Every downsample runs the fused merge kernel.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops.cluster_attention import constant_tile_metadata, tile_metadata
from ..ops.cluster_gather import cluster_token_index
from ..ops.knn import knn
from ..ops.sfc import grid_tensors, space_filling_cluster
from .layers import (
    ClusterMerging,
    ClusterTransformerBlock,
    Dropout,
    LayerNormFp32,
    Linear,
    PatchEmbed,
    rel_pos_features,
)

__all__ = ["BasicLayer", "AutoFocusFormer"]


class BasicLayer(nn.Module):
    """One AFF stage: cluster -> local/global attention blocks -> merge."""

    def __init__(self, dim: int, out_dim: Optional[int], cluster_size: int,
                 nbhd_size: int, depth: int, num_heads: int, mlp_ratio: float,
                 alpha: float = 4.0, ds_rate: float = 0.25,
                 reserve_on: bool = True, layer_scale: float = 0.0,
                 rel_pos_width: int = 55, compute_dtype=torch.float32,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: Sequence[float] = ()):
        super().__init__()
        if cluster_size <= 1:
            raise ValueError("cluster_size must be > 1")
        self.cluster_size = cluster_size
        self.nbhd_size = nbhd_size
        self.rel_pos_width = rel_pos_width
        drop_path = list(drop_path) or [0.0] * depth
        self.blocks = nn.ModuleList(
            ClusterTransformerBlock(dim, num_heads, mlp_ratio, layer_scale,
                                    rel_pos_width, compute_dtype, drop,
                                    attn_drop, drop_path[i])
            for i in range(depth)
        )
        self.prob_net = None
        self.downsample = None
        if out_dim is not None:
            self.prob_net = Linear(dim, 1, compute_dtype)
            self.downsample = ClusterMerging(
                dim, out_dim, alpha, ds_rate, reserve_on, rel_pos_width,
                compute_dtype,
            )

    def forward(self, pos, feat, h: int, w: int, on_grid: bool, stride: int):
        b, n, d = pos.shape
        R = self.rel_pos_width
        m = self.cluster_size
        global_attn = self.nbhd_size >= n
        ncc = cluster_mask = pe_feat = tile_meta = None
        if global_attn:
            rel_pos = (pos[:, None, :, :] + R) - pos[:, :, None, :]  # b n n 2
            pe_feat = rel_pos_features(rel_pos, R)
        else:
            k = int(math.ceil(n / float(m)))
            nnc = min(int(round(self.nbhd_size / float(m))), k)
            if on_grid:
                g_pos, g_reorder, g_ncc = grid_tensors(h, w, m, nnc, pos.device)
                feat = feat[:, g_reorder]
                pos = g_pos[None].expand(b, n, d)
                ncc = g_ncc[None].expand(b, n, nnc)
                tile_meta = constant_tile_metadata(g_ncc)
            else:
                pos, mean_pos, _, _, reorder = space_filling_cluster(pos, m, h, w)
                feat = torch.gather(
                    feat, 1, reorder.expand(b, n, feat.shape[2]))
                ncc = knn(pos, mean_pos, nnc)  # b n nnc int32
                # the kernels' tile unions, once for every block of the stage
                tile_meta = tile_metadata(ncc)
            if k * m != n:
                cluster_mask = (cluster_token_index(ncc, m) < n).to(torch.int32)

        for blk in self.blocks:
            feat = blk(feat, global_attn, pe_feat, ncc, m, pos, tile_meta)

        if self.downsample is not None:
            learned_prob = torch.sigmoid(self.prob_net(feat))
            reserve_num = (math.ceil(h / (stride * 2))
                           * math.ceil(w / (stride * 2)))
            pos, feat = self.downsample(
                pos, feat, cluster_mask, learned_prob, stride, reserve_num,
                ncc, m,
            )
        return pos, feat


class AutoFocusFormer(nn.Module):
    """The AFF classifier. Input NCHW images, output (b, num_classes)
    logits in the compute dtype."""

    def __init__(self, num_classes: int = 1000,
                 embed_dim: Sequence[int] = (32, 128, 256, 512),
                 cluster_size: int = 8,
                 nbhd_size: Sequence[int] = (48, 48, 48, 49),
                 alpha: float = 4.0, ds_rate: float = 0.25,
                 reserve_on: bool = True,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24),
                 mlp_ratio: float = 2.0, patch_norm: bool = True,
                 layer_scale: float = 0.0, img_size: int = 224,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.0,
                 drop_path_rate: float = 0.0, compute_dtype=torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.compute_dtype = compute_dtype
        R = img_size // 4 - 1  # aff_transformer.py:20
        self.patch_embed = PatchEmbed(embed_dim[0], patch_norm, compute_dtype)
        self.pos_drop = Dropout(drop_rate)
        num_layers = len(depths)
        # stochastic depth rises linearly over the blocks (aff.py:335)
        dpr = np.linspace(0, drop_path_rate, sum(depths)).tolist()
        self.layers = nn.ModuleList(
            BasicLayer(
                dim=int(embed_dim[i]),
                out_dim=int(embed_dim[i + 1]) if i < num_layers - 1 else None,
                cluster_size=cluster_size, nbhd_size=nbhd_size[i],
                depth=depths[i], num_heads=num_heads[i], mlp_ratio=mlp_ratio,
                alpha=alpha, ds_rate=ds_rate, reserve_on=reserve_on,
                layer_scale=layer_scale, rel_pos_width=R,
                compute_dtype=compute_dtype, drop=drop_rate,
                attn_drop=attn_drop_rate,
                drop_path=dpr[sum(depths[:i]):sum(depths[:i + 1])],
            )
            for i in range(num_layers)
        )
        self.norm = LayerNormFp32(int(embed_dim[-1]))
        self.head = (Linear(int(embed_dim[-1]), num_classes, compute_dtype)
                     if num_classes > 0 else None)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "AutoFocusFormer":
        """Seeded random init in the JAX package's distributions: truncated
        normal (std 0.02) linears with zero bias, N(0, 1) blank tokens,
        LeCun-normal convs, unit LayerNorm/BatchNorm."""
        for mod in self.modules():
            if isinstance(mod, Linear):
                mod.reset_parameters(generator)
            elif isinstance(mod, nn.Conv2d):
                fan_in = mod.weight[0].numel()
                std = fan_in**-0.5
                nn.init.trunc_normal_(mod.weight, std=std, a=-2 * std,
                                      b=2 * std, generator=generator)
                nn.init.zeros_(mod.bias)
        for name, p in self.named_parameters():
            if name.endswith(("blank_k", "blank_v")):
                nn.init.normal_(p, 0.0, 1.0, generator=generator)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (b, 3, H, W) -> logits (b, num_classes)."""
        pos, feat, h, w = self.patch_embed(x)
        feat = self.pos_drop(feat)
        for i, layer in enumerate(self.layers):
            pos, feat = layer(pos, feat, h, w, on_grid=i == 0,
                              stride=2 ** (i + 1))
        feat = self.norm(feat).mean(dim=1)
        if self.head is not None:
            feat = self.head(feat)
        return feat
