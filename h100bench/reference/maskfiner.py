"""MaskFiner Up-Down, plain reference (a frozen copy of the plain paths of
the measured package's ``models/mixres_common.py``, ``mixres_neighbour.py``,
``mixres_vit.py``, ``maskfiner_ot.py`` and ``maskfiner_ud.py``; parameter
names as there).

Tokens carry ``(scale, x, y)`` positions in min-patch units. The
upsampling masks are random scores: in training a fresh ``randn((b, n))``
per level from the CPU generator ``upsample_generator``, at eval one draw
per level from a generator seeded with ``mask_seed * 1009 + level``.
Layer scale and stochastic depth (``mr``'s ``drop_path_rate``, rising
linearly over all levels' blocks) are replayed as in the AFF reference,
the latter from ``drop_generator``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .geometry import gather_rows, knn, space_filling_cluster
from .layers import (ClusterTransformerBlock, DropPath, LayerNorm, Linear,
                     batch_norm, draw_drop_masks, drop_path_rates, no_dropout,
                     offset_features, residual, run_blocks)
from .precision import Precision

REL_POS_WIDTH = 2048 // 4 - 1
TABLE_WIDTH = 2 * REL_POS_WIDTH + 1


def sine_position_embedding(pos, num_pos_feats, temperature=10000.0):
    """DETR sine embedding of (b, n, 2) positions, normalised by their max
    over the whole batch."""
    scale, eps = 2 * math.pi, 1e-6
    x = pos[:, :, 0].float()
    y = pos[:, :, 1].float()
    y = torch.clamp(y / (y.max() + eps), 0, 1) * scale
    x = torch.clamp(x / (x.max() + eps), 0, 1) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32,
                         device=pos.device)
    dim_t = temperature ** (2 * torch.floor(dim_t / 2) / num_pos_feats)
    px, py = x[:, :, None] / dim_t, y[:, :, None] / dim_t
    px = torch.cat([torch.sin(px[:, :, 0::2]), torch.cos(px[:, :, 1::2])], 2)
    py = torch.cat([torch.sin(py[:, :, 0::2]), torch.cos(py[:, :, 1::2])], 2)
    return torch.cat([px, py], dim=2)


def grid_positions(H, W, patch, min_patch, scale, device):
    """(n, 3) rows (scale, x, y) of the patch corners, x fastest."""
    step = patch // min_patch
    gx, gy = np.meshgrid(np.arange(0, W // min_patch, step),
                         np.arange(0, H // min_patch, step), indexing="xy")
    coords = np.stack([gx, gy], axis=2).reshape(-1, 2)
    out = np.concatenate([np.full((coords.shape[0], 1), scale), coords], 1)
    return torch.as_tensor(out.astype(np.float32), device=device)


def extract_scale(feat, pos, scale, count, extra=None):
    """The ``count`` tokens of ``scale`` in their order, then the rest."""
    order = torch.argsort((pos[:, :, 0] != scale).int(), dim=1, stable=True)
    sel, rest = order[:, :count], order[:, count:]
    out = (gather_rows(feat, sel), gather_rows(pos, sel),
           gather_rows(feat, rest), gather_rows(pos, rest))
    return out + (gather_rows(extra, sel),) if extra is not None else out


def gather_image_patches(im, pos2d, patch, min_patch):
    """Raw pixels under each token's patch, x fastest then channels."""
    b, H, W, _ = im.shape
    n = pos2d.shape[1]
    ar = torch.arange(patch, device=im.device)
    gy, gx = torch.meshgrid(ar, ar, indexing="ij")
    offs = torch.stack([gx, gy], dim=2).reshape(-1, 2)
    pp = (pos2d * min_patch)[:, :, None, :] + offs
    idx = (pp[..., 1] * W + pp[..., 0]).long().reshape(b, -1)
    return gather_rows(im.reshape(b, H * W, 3), idx).reshape(
        b, n, patch * patch * 3)


class MLPBlock(nn.Module):
    def __init__(self, din, dout, prec):
        super().__init__()
        self.linear = Linear(din, dout, prec)
        self.norm = LayerNorm(dout)

    def forward(self, x):
        return self.norm(F.gelu(self.linear(x)))


class MLPDeepNorm(nn.Module):
    def __init__(self, din, hidden, dout, prec, num_layers=3):
        super().__init__()
        dims = [hidden] * (num_layers - 1) + [dout]
        self.layers = nn.ModuleList(MLPBlock(a, d, prec) for a, d in
                                    zip([din] + dims[:-1], dims))

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x


class DownSampleConvBlock(nn.Module):
    """3x3 stride-2 conv -> LeakyReLU(0.01) -> BatchNorm or GroupNorm(1)."""

    def __init__(self, din, dout, norm, prec):
        super().__init__()
        self.prec = prec
        self.conv = nn.Conv2d(din, dout, 3, stride=2, padding=1)
        if norm == "batch":
            self.b_norm = nn.BatchNorm2d(dout, eps=1e-5)
        else:
            self.g_norm = nn.GroupNorm(1, dout, eps=1e-5)

    def forward(self, x):
        x = F.leaky_relu(self.prec.conv2d(x, self.conv.weight, self.conv.bias,
                                          stride=2, padding=1), 0.01)
        if hasattr(self, "g_norm"):
            g = self.g_norm
            return F.group_norm(x, 1, g.weight, g.bias, g.eps)
        return batch_norm(x, self.b_norm, self.training)


class OverlapPatchEmbedding(nn.Module):
    def __init__(self, patch, embed_dim, norm, prec):
        super().__init__()
        n_layers = int(math.log2(patch))
        dims = [int(embed_dim // 2 ** (n_layers - 1 - i))
                for i in range(n_layers)]
        self.conv_layers = nn.ModuleList(
            DownSampleConvBlock(a, d, norm, prec)
            for a, d in zip([3] + dims[:-1], dims))
        self.out_norm = LayerNorm(dims[-1])

    def forward(self, im):
        x = im.permute(0, 3, 1, 2)
        for layer in self.conv_layers:
            x = layer(x)
        return self.out_norm(x.flatten(2).transpose(1, 2))


class MixResBasicLayer(nn.Module):
    def __init__(self, dim, cs, nbhd, depth, heads, mlp_ratio, prec,
                 layer_scale, drop_path, chunk):
        super().__init__()
        self.cs, self.nbhd = cs, nbhd
        self.checkpoint = False
        self.blocks = nn.ModuleList(
            ClusterTransformerBlock(dim, heads, mlp_ratio, REL_POS_WIDTH,
                                    prec, TABLE_WIDTH, layer_scale,
                                    drop_path[i], chunk)
            for i in range(depth))

    def forward(self, pos, feat, h, w):
        R, tw = REL_POS_WIDTH, TABLE_WIDTH
        pos_scale, pos = pos[:, :, :1], pos[:, :, 1:]
        n = pos.shape[1]
        global_attn = self.nbhd >= n
        ncc = pe_feat = None
        m = 0
        if global_attn:
            rel = torch.clamp(pos[:, None] - pos[:, :, None] + R, 0,
                              tw - 1) - R
            pe_feat = offset_features(rel[..., 0], rel[..., 1])
        else:
            m = self.cs
            k = int(math.ceil(n / m))
            nnc = min(int(round(self.nbhd / m)), k)
            if k == n:
                m, mean_pos = 1, pos
            else:
                pos, mean_pos, reorder = space_filling_cluster(pos, m, h, w)
                feat = gather_rows(feat, reorder)
                pos_scale = gather_rows(pos_scale, reorder)
            ncc = knn(pos, mean_pos, nnc)
        feat = run_blocks(self.blocks, feat, self.checkpoint, global_attn,
                          pe_feat, ncc, m, pos)
        return torch.cat([pos_scale, pos], dim=2), feat


class MixResNeighbour(nn.Module):
    def __init__(self, a: dict, prec: Precision):
        super().__init__()
        self.patch_sizes = a["patch_sizes"]
        self.d_model, self.channels = a["d_model"], a["channels"]
        self.split_ratio, self.n_scales = a["split_ratio"], a["n_scales"]
        self.min_patch = a["min_patch_size"]
        self.upscale_ratio = a["upscale_ratio"]
        self.keep_old_scale = a["keep_old_scale"]
        self.first_layer = a["first_layer"]
        self.out_features = a["out_features"]
        if a["add_image_data_to_all"]:
            raise ValueError("ADD_IMAGE_DATA_TO_ALL: not in the reference")
        c = self.channels
        if self.first_layer:
            self.patch_embed = OverlapPatchEmbedding(
                self.patch_sizes[-1], self.d_model, "batch", prec)
        else:
            if self.do_upsample:
                self.rel_pos_emb = nn.Parameter(
                    torch.zeros(1, self.split_ratio, c))
                self.scale_emb = nn.Parameter(torch.zeros(1, 1, c))
                self.image_patch_projection = Linear(
                    self.patch_sizes[-1] ** 2 * 3, c, prec)
                self.image_feat_importance = nn.Parameter(torch.ones(1))
                self.old_feat_importance = nn.Parameter(torch.ones(1))
                self.high_res_norm1 = LayerNorm(c)
                self.high_res_mlp = MLPDeepNorm(c, c, c, prec)
                self.high_res_norm2 = LayerNorm(c)
            self.token_norm = LayerNorm(c)
            if c != self.d_model:
                self.token_projection = Linear(c, self.d_model, prec)
        self.layers = MixResBasicLayer(self.d_model, a["cluster_size"],
                                       a["nbhd_size"], a["n_layers"],
                                       a["n_heads"], a["mlp_ratio"], prec,
                                       a["layer_scale"], a["drop_path"],
                                       a["chunk"])
        self.norm_out = LayerNorm(self.d_model)

    @property
    def do_upsample(self) -> bool:
        return not (self.upscale_ratio == 0 or self.first_layer)

    def _upsample(self, im, scale, features, features_pos, mask, layout):
        old = scale - 1
        m_old = layout[old]
        if mask.shape[1] == features.shape[1]:
            f_cur, p_cur, f_old, p_old, mask = extract_scale(
                features, features_pos, old, m_old, extra=mask)
        else:
            f_cur, p_cur, f_old, p_old = extract_scale(
                features, features_pos, old, m_old)
        n_ = f_cur.shape[1]
        k = int(n_ * self.upscale_ratio)
        order = torch.argsort(mask, dim=1, stable=True)
        bottom, top = order[:, :n_ - k], order[:, n_ - k:]
        soft = torch.softmax(mask.float(), dim=1)
        ste = soft - soft.detach()
        f_split = gather_rows(f_cur, top) * torch.gather(
            1.0 + ste, 1, top)[..., None]
        f_keep = gather_rows(f_cur, bottom) * torch.gather(
            1.0 - ste, 1, bottom)[..., None]
        p_split, p_keep = gather_rows(p_cur, top), gather_rows(p_cur, bottom)
        new_layout = dict(layout)
        feats, poss = [f_old, f_keep], [p_old, p_keep]
        if self.keep_old_scale:
            feats.append(f_split)
            poss.append(p_split)
        else:
            new_layout[old] = m_old - k
        new_layout[scale] = new_layout.get(scale, 0) + k * self.split_ratio
        b, _, c = f_split.shape
        emb = self.rel_pos_emb[:, None] + self.scale_emb[:, None]
        up = (f_split[:, :, None, :] + emb).reshape(b, k * self.split_ratio,
                                                     c)
        r = 2 ** (self.n_scales - scale - 1)
        x, y = p_split[:, :, 1], p_split[:, :, 2]
        kids = torch.stack([torch.stack(t, dim=2) for t in (
            (x, y), (x + r, y), (x, y + r), (x + r, y + r))], dim=2)
        kids = kids.reshape(b, k * self.split_ratio, 2)
        up_pos = torch.cat([torch.full_like(kids[:, :, :1], scale), kids], 2)
        pix = gather_image_patches(im, up_pos[:, :, 1:], self.patch_sizes[-1],
                                   self.min_patch)
        px = self.high_res_norm1(F.gelu(self.image_patch_projection(pix)))
        px = self.high_res_norm2(self.high_res_mlp(px))
        up = self.old_feat_importance * up + self.image_feat_importance * px
        return (torch.cat(feats + [up], dim=1),
                torch.cat(poss + [up_pos], dim=1), new_layout)

    def forward(self, im, scale, features, features_pos, mask, layout):
        b, H, W, _ = im.shape
        h, w = H // self.min_patch, W // self.min_patch
        if self.first_layer:
            x = self.patch_embed(im)
            grid = grid_positions(H, W, self.patch_sizes[-1], self.min_patch,
                                  scale, im.device)
            pos = grid[None].expand(b, *grid.shape)
            x = x + sine_position_embedding(pos[:, :, 1:], self.d_model // 2)
            layout = {scale: grid.shape[0]}
        else:
            if self.do_upsample:
                x, pos, layout = self._upsample(im, scale, features,
                                                features_pos, mask, layout)
            else:
                x, pos, layout = features, features_pos, dict(layout)
            x = self.token_norm(x)
            if self.channels != self.d_model:
                x = self.token_projection(x)
        pos, x = self.layers(pos, x, h, w)
        outs = {}
        rem_f, rem_p = x, pos
        for s in range(scale + 1):
            cnt = layout.get(s, 0)
            if cnt == 0:
                continue
            name = f"res{self.n_scales - s + 1}"
            f_s, p_s, rem_f, rem_p = extract_scale(rem_f, rem_p, s, cnt)
            outs[name] = self.norm_out(f_s)
            outs[name + "_pos"] = p_s[:, :, 1:]
            outs[name + "_scale"] = p_s[:, :, 0]
        return outs, dict(layout)


class DWConv(nn.Module):
    def __init__(self, dim, prec):
        super().__init__()
        self.prec = prec
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x, h, w):
        b, n, c = x.shape
        img = x.reshape(b, h, w, c).permute(0, 3, 1, 2)
        img = self.prec.conv2d(img, self.dwconv.weight, self.dwconv.bias,
                               padding=1, groups=c)
        return img.permute(0, 2, 3, 1).reshape(b, n, c)


class FeedForward(nn.Module):
    def __init__(self, dim, hidden, prec):
        super().__init__()
        self.fc1 = Linear(dim, hidden, prec)
        self.dwconv = DWConv(hidden, prec)
        self.fc2 = Linear(hidden, dim, prec)

    def forward(self, x, h, w):
        return self.fc2(F.gelu(self.dwconv(self.fc1(x), h, w)))


class Attention(nn.Module):
    def __init__(self, dim, heads, prec):
        super().__init__()
        self.prec, self.heads = prec, heads
        self.qkv = Linear(dim, 3 * dim, prec)
        self.proj = Linear(dim, dim, prec)

    def forward(self, x):
        b, n, c = x.shape
        h = self.heads
        qkv = self.qkv(x).reshape(b, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        attn = self.prec.matmul(qkv[0], qkv[1].transpose(-1, -2)) \
            * (c // h) ** -0.5
        out = self.prec.matmul(torch.softmax(attn, dim=-1), qkv[2])
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class Block(nn.Module):
    def __init__(self, dim, heads, mlp_dim, prec, layer_scale, drop_path):
        super().__init__()
        if layer_scale:
            self.gamma1 = nn.Parameter(torch.zeros(dim))
            self.gamma2 = nn.Parameter(torch.zeros(dim))
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, heads, prec)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim)
        self.mlp = FeedForward(dim, mlp_dim, prec)

    def forward(self, x, h, w):
        y = self.attn(self.norm1(x))
        return residual(self, x, y, lambda t: self.mlp(self.norm2(t), h, w))


class MixResViT(nn.Module):
    def __init__(self, a: dict, prec: Precision):
        super().__init__()
        self.patch_sizes = a["patch_sizes"]
        self.d_model, self.channels = a["d_model"], a["channels"]
        self.min_patch = a["min_patch_size"]
        self.first_layer = a["first_layer"]
        self.out_features = a["out_features"]
        self.upscale_ratio = a["upscale_ratio"]
        self.checkpoint = False
        if self.first_layer:
            self.patch_embed = OverlapPatchEmbedding(
                self.patch_sizes[-1], self.d_model, "group", prec)
        else:
            self.token_norm = LayerNorm(self.channels)
            if self.channels != self.d_model:
                self.token_projection = Linear(self.channels, self.d_model,
                                               prec)
        self.layers = nn.ModuleDict({"blocks": nn.ModuleList(
            Block(self.d_model, a["n_heads"],
                  int(self.d_model * a["mlp_ratio"]), prec,
                  a["layer_scale"], a["drop_path"][i])
            for i in range(a["n_layers"]))})
        self.norm_out = LayerNorm(self.d_model)

    def forward(self, im, scale, features, features_pos, mask, layout):
        b, H, W, _ = im.shape
        ps = self.patch_sizes[-1]
        if self.first_layer:
            x = self.patch_embed(im)
            grid = grid_positions(H, W, ps, self.min_patch, scale, im.device)
            pos = grid[None].expand(b, *grid.shape)
            x = x + sine_position_embedding(pos[:, :, 1:], self.d_model // 2)
            layout = {scale: grid.shape[0]}
        else:
            x = self.token_norm(features)
            if self.channels != self.d_model:
                x = self.token_projection(x)
            pos = features_pos
        x = run_blocks(self.layers["blocks"], x, self.checkpoint, H // ps,
                       W // ps)
        name = self.out_features[0]
        return ({name: self.norm_out(x), name + "_pos": pos[:, :, 1:],
                 name + "_scale": pos[:, :, 0]}, dict(layout))


class UpDown(nn.Module):
    """The UD classifier: NCHW images -> (b, num_classes) logits."""

    def __init__(self, mr: dict, num_classes: int, ratios, prec: Precision,
                 mask_seed: int = 0, chunk: int = 0):
        super().__init__()
        for key in ("drop_rate", "attn_drop_rate"):
            no_dropout(max(mr.get(key, [0.0])), key)
        if mr.get("num_register_tokens") or mr.get("aux_loss"):
            raise ValueError("register tokens and aux heads are not in the "
                             "reference")
        n_scales = mr["n_resolution_scales"]
        total = len(mr["name"])
        depths = mr["depths"]
        dpr = drop_path_rates(mr.get("drop_path_rate", 0.0), depths)
        self.drop_generator = None
        self.n_scales = n_scales
        self.all_out_features = tuple(mr["out_features"])
        self.mask_seed = int(mask_seed)
        self.upsample_generator: Optional[torch.Generator] = None
        self._eval_masks: Dict[tuple, torch.Tensor] = {}
        levels = []
        for i, kind in enumerate(mr["name"]):
            a = dict(n_layers=mr["depths"][i], d_model=mr["embed_dim"][i],
                     n_heads=mr["num_heads"][i], mlp_ratio=mr["mlp_ratio"][i],
                     split_ratio=mr["split_ratio"][i], n_scales=n_scales,
                     upscale_ratio=ratios[i],
                     min_patch_size=mr["patch_sizes"][n_scales - 1],
                     first_layer=i == 0,
                     channels=3 if i == 0 else mr["embed_dim"][i - 1],
                     cluster_size=mr["cluster_size"][i],
                     nbhd_size=mr["nbhd_size"][i],
                     keep_old_scale=mr["keep_old_scale"],
                     add_image_data_to_all=mr["add_image_data_to_all"],
                     layer_scale=mr.get("layer_scale", 0.0),
                     drop_path=dpr[sum(depths[:i]):sum(depths[:i + 1])],
                     chunk=chunk)
            if i >= n_scales:
                a.update(patch_sizes=tuple(mr["patch_sizes"][i:]),
                         out_features=tuple(mr["out_features"][-(total - i):]),
                         channels=mr["embed_dim"][i - 1]
                         + mr["embed_dim"][total - i - 1])
            else:
                a.update(patch_sizes=tuple(mr["patch_sizes"][:i + 1]),
                         out_features=tuple(mr["out_features"][-(i + 1):]))
            levels.append(MixResViT(a, prec) if kind == "MixResViT"
                          else MixResNeighbour(a, prec))
        self.backbones = nn.ModuleList(levels)
        self.head = Linear(mr["embed_dim"][-1], num_classes, prec)
        scales = list(range(n_scales))
        self.bb_scales = scales + scales[-2::-1]
        self.bb_in_feats = [[None], ["res5"], ["res5", "res4"],
                            ["res5", "res4", "res3"],
                            ["res5", "res4", "res3"], ["res5", "res4"],
                            ["res5"], [None]]

    def set_checkpoint(self, on: bool) -> None:
        for bb in self.backbones:
            if isinstance(bb, MixResViT):
                bb.checkpoint = on
            else:
                bb.layers.checkpoint = on

    def _mask(self, j, b, n, device):
        if self.training:
            return torch.randn((b, n),
                               generator=self.upsample_generator).to(device)
        key = (j, b, n)
        if key not in self._eval_masks:
            gen = torch.Generator().manual_seed(self.mask_seed * 1009 + j)
            self._eval_masks[key] = torch.randn((b, n), generator=gen)
        return self._eval_masks[key].to(device)

    def _feature_scale(self, f):
        return (len(self.all_out_features) - 1
                - self.all_out_features.index(f))

    def forward(self, x):
        if self.training:
            draw_drop_masks(self, self.drop_generator, x.shape[0], x.device)
        im = x.permute(0, 2, 3, 1).contiguous()
        mask = features = features_pos = None
        layout: Dict[int, int] = {}
        outs: Dict[str, list] = {}
        first_pos: Dict[str, torch.Tensor] = {}
        for j, bb in enumerate(self.backbones):
            output, layout = bb(im, self.bb_scales[j], features, features_pos,
                                mask, layout)
            all_feat, all_scale, all_pos = [], [], []
            next_layout: Dict[int, int] = {}
            for f in bb.out_features:
                feat, fpos = output[f], output[f + "_pos"]
                fscale = output[f + "_scale"]
                n = feat.shape[1]
                if f in first_pos:
                    idx = align_to_order(first_pos[f], fpos)
                    feat, fpos = gather_rows(feat, idx), gather_rows(fpos, idx)
                    fscale = torch.gather(fscale, 1, idx)
                    outs[f].append(feat)
                else:
                    outs[f] = [feat]
                    first_pos[f] = fpos
                if j + 1 < len(self.bb_in_feats) \
                        and f in self.bb_in_feats[j + 1]:
                    if j >= self.n_scales - 1:
                        res = outs[f][-((j - self.n_scales + 1) * 2 + 2)]
                        feat = torch.cat([feat, res], dim=2)
                    all_feat.append(feat)
                    all_pos.append(fpos)
                    all_scale.append(fscale)
                    next_layout[self._feature_scale(f)] = n
            if j < self.n_scales - 1:
                b, n, _ = all_feat[0].shape
                mask = self._mask(j, b, n, x.device)
            if j < len(self.backbones) - 1:
                features_pos = torch.cat([torch.cat(all_scale, 1)[..., None],
                                          torch.cat(all_pos, 1)], dim=2)
                features = torch.cat(all_feat, dim=1)
                layout = next_layout
        return self.head(output[self.all_out_features[-1]].mean(dim=1))


def align_to_order(pos_org, pos_shuffled):
    """``idx`` with ``pos_shuffled[b, idx[b, t]] == pos_org[b, t]``, by
    exact integer keys of the (half-)integer positions."""
    def key(p):
        p2 = torch.round(p.float() * 2.0).long()
        return p2[..., 1] * 32768 + p2[..., 0]
    p = torch.argsort(key(pos_shuffled), dim=1, stable=True)
    rank = torch.argsort(torch.argsort(key(pos_org), dim=1, stable=True),
                         dim=1, stable=True)
    return torch.gather(p, 1, rank)
