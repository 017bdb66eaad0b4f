"""AutoFocusFormer, plain reference (a frozen copy of the plain path of the
measured package's ``models/aff.py``; parameter names as there).

The configuration's ``arch`` block may hold the keys of :data:`ARCH` and
no other; element-wise and attention dropout must be 0. Layer scale and
stochastic depth (rates rising linearly over all blocks) are replayed,
the latter from ``drop_generator`` (:func:`layers.draw_drop_masks`).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn

from .geometry import (cluster_token_index, grid_constants, knn,
                       space_filling_cluster)
from .layers import (ClusterMerging, ClusterTransformerBlock, LayerNorm,
                     Linear, PatchEmbed, draw_drop_masks, drop_path_rates,
                     no_dropout, offset_features, run_blocks)
from .precision import Precision

ARCH = ("embed_dim", "depths", "num_heads", "cluster_size", "nbhd_size",
        "alpha", "ds_rate", "mlp_ratio", "img_size", "num_classes",
        "drop_rate", "drop_path_rate", "attn_drop_rate", "layer_scale")


class BasicLayer(nn.Module):
    """One stage: cluster -> local or global attention blocks -> merge."""

    def __init__(self, dim, out_dim, cs, nbhd, depth, heads, mlp_ratio, alpha,
                 ds_rate, rel_pos_width, prec, layer_scale, drop_path, chunk):
        super().__init__()
        self.cs, self.nbhd, self.R = cs, nbhd, rel_pos_width
        self.checkpoint = False
        self.blocks = nn.ModuleList(
            ClusterTransformerBlock(dim, heads, mlp_ratio, rel_pos_width,
                                    prec, 0, layer_scale, drop_path[i],
                                    chunk)
            for i in range(depth))
        self.prob_net = self.downsample = None
        if out_dim is not None:
            self.prob_net = Linear(dim, 1, prec)
            self.downsample = ClusterMerging(dim, out_dim, alpha, ds_rate,
                                             rel_pos_width, prec)

    def forward(self, pos, feat, h, w, on_grid, stride):
        b, n, _ = pos.shape
        m = self.cs
        global_attn = self.nbhd >= n
        ncc = cluster_mask = pe_feat = None
        if global_attn:
            rel = pos[:, None, :, :] - pos[:, :, None, :]
            pe_feat = offset_features(rel[..., 0], rel[..., 1])
        else:
            k = int(math.ceil(n / m))
            nnc = min(int(round(self.nbhd / m)), k)
            if on_grid:
                g_pos, g_reorder, g_ncc = (
                    torch.as_tensor(t, device=pos.device)
                    for t in grid_constants(h, w, m, nnc))
                feat = feat[:, g_reorder.long()]
                pos = g_pos.float()[None].expand(b, n, 2)
                ncc = g_ncc[None].expand(b, n, nnc)
            else:
                pos, mean_pos, reorder = space_filling_cluster(pos, m, h, w)
                feat = torch.gather(feat, 1, reorder[..., None].expand(
                    b, n, feat.shape[2]))
                ncc = knn(pos, mean_pos, nnc)
            if k * m != n:
                cluster_mask = (cluster_token_index(ncc, m) < n).int()
        feat = run_blocks(self.blocks, feat, self.checkpoint, global_attn,
                          pe_feat, ncc, m, pos)
        if self.downsample is not None:
            lp = torch.sigmoid(self.prob_net(feat))
            reserve = (math.ceil(h / (stride * 2))
                       * math.ceil(w / (stride * 2)))
            pos, feat = self.downsample(pos, feat, cluster_mask, lp, stride,
                                        reserve, ncc, m)
        return pos, feat


class AutoFocusFormer(nn.Module):
    """NCHW images -> (b, num_classes) float32 logits. ``chunk``: queries
    per checkpointed chunk of the local attention (0: all at once)."""

    def __init__(self, arch: dict, prec: Precision, chunk: int = 0):
        super().__init__()
        unknown = sorted(set(arch) - set(ARCH))
        if unknown:
            raise ValueError(f"{unknown}: not in the AFF reference")
        for key in ("drop_rate", "attn_drop_rate"):
            no_dropout(arch.get(key), key)
        dims, depths = arch["embed_dim"], arch["depths"]
        R = arch["img_size"] // 4 - 1
        dpr = drop_path_rates(arch.get("drop_path_rate", 0.0), depths)
        self.drop_generator = None
        self.patch_embed = PatchEmbed(dims[0], prec)
        self.layers = nn.ModuleList(
            BasicLayer(dims[i], dims[i + 1] if i + 1 < len(depths) else None,
                       arch["cluster_size"], arch["nbhd_size"][i], depths[i],
                       arch["num_heads"][i], arch["mlp_ratio"],
                       arch["alpha"], arch["ds_rate"], R, prec,
                       arch.get("layer_scale", 0.0),
                       dpr[sum(depths[:i]):sum(depths[:i + 1])], chunk)
            for i in range(len(depths)))
        self.norm = LayerNorm(dims[-1])
        self.head = Linear(dims[-1], arch["num_classes"], prec)

    def set_checkpoint(self, on: bool) -> None:
        for layer in self.layers:
            layer.checkpoint = on

    def forward(self, x):
        if self.training:
            draw_drop_masks(self, self.drop_generator, x.shape[0], x.device)
        pos, feat, h, w = self.patch_embed(x)
        for i, layer in enumerate(self.layers):
            pos, feat = layer(pos, feat, h, w, on_grid=i == 0,
                              stride=2 ** (i + 1))
        return self.head(self.norm(feat).mean(dim=1))
