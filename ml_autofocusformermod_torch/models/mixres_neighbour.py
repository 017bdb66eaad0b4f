"""MixResNeighbour: the cluster-attention MaskFiner level with token
splitting (counterpart of the JAX package's ``models/mixres_neighbour.py``).

One pyramid level of the MaskFiner backbones, entered in one of three
modes:

* ``first_layer``: overlap patch embedding (BatchNorm convs) and sine PE;
* upsample mode: the previous scale's highest-scoring tokens are split into
  ``split_ratio`` finer children (straight-through gates), with raw image
  pixels fused into the new tokens or into every token;
* plain mode: LayerNorm and a linear projection of the incoming tokens.

Then one cluster-attention stage over the mixed-resolution token cloud
(:class:`MixResBasicLayer`, the fused CUDA kernel with the MixRes
relative-position clamp) and the per-scale ``res*`` outputs. Token counts
per scale are a host ``layout``: no device sync per level.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cluster_attention import tile_metadata
from ..ops.cluster_gather import gather_rows
from ..ops.knn import knn
from ..ops.sfc import space_filling_cluster
from ..parallel import comm
from ..utils.profiling import span
from .layers import ClusterTransformerBlock, LayerNormFp32, Linear, \
    check_remat, rel_pos_features, remat_call
from .mixres_common import (
    MIXRES_REL_POS_WIDTH,
    MIXRES_TABLE_WIDTH,
    MLPDeepNorm,
    OverlapPatchEmbedding,
    extract_scale,
    gather_image_patches,
    grid_positions,
    sine_position_embedding,
)

__all__ = ["MixResBasicLayer", "MixResNeighbour"]


class MixResBasicLayer(nn.Module):
    """A cluster-attention stage over a (scale, x, y) token cloud; no
    downsample. The scale channel is set aside for the clustering and put
    back after.

    A stage whose neighbourhood covers all its tokens attends densely
    (plain torch, rel-pos features clamped to the table). Otherwise its
    tokens are clustered along the space-filling curve (``h, w`` the
    min-patch grid) and kNN'd to their ``nnc`` nearest clusters, one
    :func:`tile_metadata` is made for all blocks, and every block runs the
    fused kernel with ``rel_pos_width = 511, clamp_width = 1023``. The
    kernel (and its plain version) expands each cluster to its member rows
    and excludes the padded slots of the last cluster itself. Under
    sequence parallelism the blocks run on this seq rank's token range and
    their output is gathered, as in ``aff.py::BasicLayer``; the clustering
    and kNN stay whole on every seq rank.
    """

    def __init__(self, dim, cluster_size, nbhd_size, depth, num_heads,
                 mlp_ratio, drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path: Sequence[float] = (), layer_scale: float = 0.0,
                 compute_dtype=torch.float32, remat: str = ""):
        super().__init__()
        self.remat = check_remat(remat)
        self.cluster_size = cluster_size
        self.nbhd_size = nbhd_size
        drop_path = list(drop_path) or [0.0] * depth
        self.blocks = nn.ModuleList(
            ClusterTransformerBlock(
                dim, num_heads, mlp_ratio, layer_scale, MIXRES_REL_POS_WIDTH,
                compute_dtype, drop, attn_drop, drop_path[i],
                clamp_width=MIXRES_TABLE_WIDTH)
            for i in range(depth))

    def forward(self, pos, feat, h: int, w: int):
        """``pos`` (b, n, 3), ``feat`` (b, n, c) -> (pos, feat), both in the
        stage's (possibly cluster-sorted) token order."""
        R, tw = MIXRES_REL_POS_WIDTH, MIXRES_TABLE_WIDTH
        pos_scale = pos[:, :, :1]
        pos = pos[:, :, 1:]
        b, n, _ = pos.shape
        global_attn = self.nbhd_size >= n
        tokens = comm.token_range_of(n)
        lo, hi = (tokens.lo, tokens.hi) if tokens is not None else (0, n)
        ncc = pe_feat = meta = None
        m = 0
        if global_attn:
            rel_pos = (pos[:, None, :, :] + R) - pos[:, lo:hi, None, :]
            pe_feat = rel_pos_features(torch.clamp(rel_pos, 0, tw - 1), R)
        else:
            m = self.cluster_size
            k = int(math.ceil(n / float(m)))
            nnc = min(int(round(self.nbhd_size / float(m))), k)
            if k == n:
                m = 1
                pos = pos.contiguous()
                mean_pos = pos
            else:
                pos, mean_pos, _, _, reorder = space_filling_cluster(
                    pos, m, h, w)
                feat = gather_rows(feat, reorder[..., 0])
                pos_scale = gather_rows(pos_scale, reorder[..., 0])
            ncc = knn(pos, mean_pos, nnc)[:, lo:hi]  # the range's rows
            meta = tile_metadata(ncc)  # once for every block of the stage
        x = comm.slice_tokens(feat, tokens)
        for blk in self.blocks:
            x = remat_call(self.remat, blk, x, global_attn, pe_feat, ncc, m,
                           pos, meta, tokens)
        return torch.cat([pos_scale, pos], dim=2), comm.gather_tokens(
            x, tokens)


class MixResNeighbour(nn.Module):
    """One MaskFiner pyramid level of cluster attention."""

    def __init__(self, patch_sizes: Sequence[int], n_layers: int,
                 d_model: int, n_heads: int, dropout: float = 0.0,
                 drop_path_rate: Sequence[float] = (0.0,),
                 attn_drop_rate: float = 0.0, channels: int = 1,
                 mlp_ratio: float = 4.0, split_ratio: int = 4,
                 n_scales: int = 4, cluster_size: int = 8,
                 nbhd_size: int = 48, layer_scale: float = 0.0,
                 min_patch_size: int = 4, upscale_ratio: float = 0.25,
                 keep_old_scale: bool = False, scale: int = 1,
                 add_image_data_to_all: bool = False,
                 first_layer: bool = False,
                 out_features: Sequence[str] = ("res5",),
                 compute_dtype=torch.float32, remat: str = ""):
        super().__init__()
        self.patch_sizes = tuple(patch_sizes)
        self.d_model = d_model
        self.channels = channels
        self.split_ratio = split_ratio
        self.n_scales = n_scales
        self.min_patch_size = min_patch_size
        self.upscale_ratio = upscale_ratio
        self.keep_old_scale = keep_old_scale
        self.add_image_data_to_all = add_image_data_to_all
        self.first_layer = first_layer
        self.out_features = tuple(out_features)
        dt = compute_dtype
        if first_layer:
            self.patch_embed = OverlapPatchEmbedding(
                self.patch_size, d_model, norm="batch", compute_dtype=dt)
        else:
            if self.do_upsample:
                self.rel_pos_emb = nn.Parameter(
                    torch.empty(1, split_ratio, channels))
                self.scale_emb = nn.Parameter(torch.empty(1, 1, channels))
                if add_image_data_to_all:
                    self.image_patch_projectors = nn.ModuleList(
                        Linear(self.patch_sizes[s] ** 2 * 3, channels, dt)
                        for s in range(scale + 1))
                else:
                    self.image_patch_projection = Linear(
                        self.patch_size ** 2 * 3, channels, dt)
                    self.image_feat_importance = nn.Parameter(torch.ones(1))
                    self.old_feat_importance = nn.Parameter(torch.ones(1))
                self.high_res_norm1 = LayerNormFp32(channels)
                self.high_res_mlp = MLPDeepNorm(channels, channels, channels,
                                                compute_dtype=dt)
                self.high_res_norm2 = LayerNormFp32(channels)
            self.token_norm = LayerNormFp32(channels)
            if channels != d_model:
                self.token_projection = Linear(channels, d_model, dt)
        self.layers = MixResBasicLayer(
            d_model, cluster_size, nbhd_size, n_layers, n_heads, mlp_ratio,
            dropout, attn_drop_rate, tuple(drop_path_rate), layer_scale, dt,
            remat)
        self.norm_out = LayerNormFp32(d_model)

    @property
    def patch_size(self) -> int:
        return self.patch_sizes[-1]

    @property
    def do_upsample(self) -> bool:
        return not (self.upscale_ratio == 0 or self.first_layer)

    # ---- token split machinery ----

    def _divide_split_keep(self, feat, pos, scores):
        """The ``int(n * upscale_ratio)`` highest-scoring tokens to split
        and the rest to keep, by a stable ascending argsort of ``scores``:
        ``(tokens_to_split, pos_to_split, tokens_to_keep, pos_to_keep)``.
        The tokens carry straight-through gates ``1 + (soft - soft.detach())``
        of the scores' softmax: exactly 1 forward, a gradient path to the
        scores backward."""
        n_ = feat.shape[1]
        k_split = int(n_ * self.upscale_ratio)
        with span("geom.split_select"):
            order = torch.argsort(scores, dim=1, stable=True)
            bottom_idx = order[:, :n_ - k_split]
            top_idx = order[:, n_ - k_split:]
            soft = torch.softmax(scores.float(), dim=1)
            ste = soft - soft.detach()  # 0 forward, gradient flows
        g_split = torch.gather(1.0 + ste, 1, top_idx)
        g_keep = torch.gather(1.0 + (-ste), 1, bottom_idx)
        tokens_to_split = (gather_rows(feat, top_idx)
                           * g_split[..., None].to(feat.dtype))
        tokens_to_keep = (gather_rows(feat, bottom_idx)
                          * g_keep[..., None].to(feat.dtype))
        return (tokens_to_split, gather_rows(pos, top_idx), tokens_to_keep,
                gather_rows(pos, bottom_idx))

    def _split_features(self, tokens):
        """Each token repeated ``split_ratio`` times plus the learned child
        and scale embeddings."""
        b, n_, c = tokens.shape
        emb = (self.rel_pos_emb[:, None] + self.scale_emb[:, None])
        x = tokens[:, :, None, :] + emb.to(tokens.dtype)  # b n_ sr c
        return x.reshape(b, n_ * self.split_ratio, c)

    def _split_pos(self, pos_to_split, curr_scale: int):
        """(scale, x, y) of the 2x2 children of each split token."""
        b, n_, _ = pos_to_split.shape
        r = 2 ** (self.n_scales - curr_scale - 1)
        x, y = pos_to_split[:, :, 1], pos_to_split[:, :, 2]
        children = torch.stack([
            torch.stack([x, y], dim=2), torch.stack([x + r, y], dim=2),
            torch.stack([x, y + r], dim=2), torch.stack([x + r, y + r], dim=2),
        ], dim=2).reshape(b, n_ * self.split_ratio, 2)
        scale_col = torch.full_like(children[:, :, :1], curr_scale)
        return torch.cat([scale_col, children], dim=2)

    def _image_mlp(self, x):
        """GELU -> LN -> MLPDeepNorm -> LN on projected pixels."""
        x = self.high_res_norm1(F.gelu(x))
        return self.high_res_norm2(self.high_res_mlp(x))

    def _add_high_res_feat(self, tokens, pos2d, im):
        """The pixels under each new token, projected and blended with the
        token by the learned importances."""
        pix = gather_image_patches(im, pos2d, self.patch_size,
                                   self.min_patch_size)
        x = self._image_mlp(self.image_patch_projection(pix))
        return (self.old_feat_importance.to(tokens.dtype) * tokens
                + self.image_feat_importance.to(x.dtype) * x)

    def _add_image_data_to_all(self, feat, pos, max_scale, im, layout):
        """Tokens re-sorted by scale, each plus its scale's projected
        pixels."""
        feats, poss, projs = [], [], []
        rem_f, rem_p = feat, pos
        for s in range(max_scale + 1):
            cnt = layout.get(s, 0)
            if cnt == 0:
                continue
            f_s, p_s, rem_f, rem_p = extract_scale(rem_f, rem_p, s, cnt)
            pix = gather_image_patches(im, p_s[:, :, 1:], self.patch_sizes[s],
                                       self.min_patch_size)
            feats.append(f_s)
            poss.append(p_s)
            projs.append(self.image_patch_projectors[s](pix))
        feat = torch.cat(feats, dim=1)
        x = self._image_mlp(torch.cat(projs, dim=1))
        return feat + x.to(feat.dtype), torch.cat(poss, dim=1)

    def _upsample(self, im, scale, features, features_pos, upsampling_mask,
                  layout):
        """Split the previous scale's tokens: ``(feat, pos, new_layout)``
        before the token norm and projection."""
        old_scale = scale - 1
        m_old = layout[old_scale]
        if upsampling_mask.shape[1] == features.shape[1]:
            feat_curr, pos_curr, feat_old, pos_old, mask_curr = extract_scale(
                features, features_pos, old_scale, m_old,
                extra=upsampling_mask)
        else:
            feat_curr, pos_curr, feat_old, pos_old = extract_scale(
                features, features_pos, old_scale, m_old)
            mask_curr = upsampling_mask
        f_split, p_split, f_keep, p_keep = self._divide_split_keep(
            feat_curr, pos_curr, mask_curr)
        k_split = f_split.shape[1]

        new_layout = dict(layout)
        all_feat = [feat_old, f_keep]
        all_pos = [pos_old, p_keep]
        if self.keep_old_scale:
            all_feat.append(f_split)
            all_pos.append(p_split)
        else:
            new_layout[old_scale] = m_old - k_split
        new_layout[scale] = (new_layout.get(scale, 0)
                             + k_split * self.split_ratio)
        up_feat = self._split_features(f_split)
        up_pos = self._split_pos(p_split, scale)
        if not self.add_image_data_to_all:
            up_feat = self._add_high_res_feat(up_feat, up_pos[:, :, 1:], im)
        feat = torch.cat(all_feat + [up_feat], dim=1)
        pos = torch.cat(all_pos + [up_pos], dim=1)
        if self.add_image_data_to_all:
            feat, pos = self._add_image_data_to_all(feat, pos, scale, im,
                                                    new_layout)
        return feat, pos, new_layout

    def forward(self, im: torch.Tensor, scale: int,
                features: Optional[torch.Tensor],
                features_pos: Optional[torch.Tensor],
                upsampling_mask: Optional[torch.Tensor],
                layout: Dict[int, int]) -> Tuple[Dict[str, Any],
                                                 Dict[int, int]]:
        """``im`` (b, H, W, 3) NHWC; ``features`` (b, n, channels),
        ``features_pos`` (b, n, 3) and ``layout`` {scale: count} of the
        incoming tokens; ``upsampling_mask`` (b, n_old) or (b, n) scores
        in upsample mode. Returns the ``res*`` dict and the new layout."""
        b, H, W, _ = im.shape
        min_patched = (H // self.min_patch_size, W // self.min_patch_size)
        if self.first_layer:
            x = self.patch_embed(im)
            grid = grid_positions(H, W, self.patch_size, self.min_patch_size,
                                  scale, im.device)
            pos = grid[None].expand(b, *grid.shape)
            x = x + sine_position_embedding(
                pos[:, :, 1:], self.d_model // 2).to(x.dtype)
            layout = {scale: grid.shape[0]}
        else:
            if self.do_upsample:
                x, pos, layout = self._upsample(
                    im, scale, features, features_pos, upsampling_mask,
                    layout)
            else:
                x, pos, layout = features, features_pos, dict(layout)
            x = self.token_norm(x)
            if self.channels != self.d_model:
                x = self.token_projection(x)

        pos, x = self.layers(pos, x, min_patched[0], min_patched[1])

        outs: Dict[str, Any] = {}
        rem_f, rem_p = x, pos
        for s in range(scale + 1):
            cnt = layout.get(s, 0)
            if cnt == 0:
                continue
            out_idx = self.n_scales - s + 1
            f_s, p_s, rem_f, rem_p = extract_scale(rem_f, rem_p, s, cnt)
            outs[f"res{out_idx}"] = self.norm_out(f_s)
            outs[f"res{out_idx}_pos"] = p_s[:, :, 1:]
            outs[f"res{out_idx}_scale"] = p_s[:, :, 0]
            outs[f"res{out_idx}_spatial_shape"] = (
                H // self.patch_sizes[s], W // self.patch_sizes[s])
        outs["min_spatial_shape"] = min_patched
        return outs, dict(layout)
