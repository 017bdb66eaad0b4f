"""MaskFiner Up-Down: a U-shaped encoder-decoder over seven MixRes backbones
(counterpart of the JAX package's ``models/maskfiner_ud.py``).

Encoder levels (scales 0..n-1) split tokens to finer scales; decoder levels
re-coarsen by taking fewer scales, with skip connections that concatenate
the matching encoder feature along the channels after its tokens are put
back in their first-recorded order (:func:`align_to_order`, an exact match
of integer position keys; :func:`find_pos_org_order` is its test oracle).
The upsampling mask is the random oracle placeholder; the max-norm and
colour-change oracles are kept for API parity.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn as nn

from ..ops.cluster_gather import gather_rows
from ..utils.profiling import span
from .layers import Linear
from .maskfiner_ot import build_backbones
from .maskfiner_ot import random_upsampling_mask as _draw_mask
from .mixres_common import init_mixres_weights

__all__ = ["find_pos_org_order", "align_to_order", "max_norm_upsampling_mask",
           "compute_color_dist", "color_change_upsampling_mask",
           "random_upsampling_mask", "UpDownBackbone", "BB_IN_FEATS",
           "build_up_down"]


def find_pos_org_order(pos_org: torch.Tensor,
                       pos_shuffled: torch.Tensor) -> torch.Tensor:
    """Index of each original position within the shuffled set, by
    Manhattan distance and argmin: the O(n^2) test oracle of
    :func:`align_to_order`."""
    d = (pos_org[:, :, None, :].float()
         - pos_shuffled[:, None, :, :].float()).abs().sum(-1)
    return torch.argmin(d, dim=2)


def _pos_key(pos: torch.Tensor) -> torch.Tensor:
    """A unique int64 key per 2-D position: coordinates are integer or
    half-integer min-patch units below 4096, doubled so they stay exact."""
    p2 = torch.round(pos.float() * 2.0).long()
    return p2[..., 1] * 32768 + p2[..., 0]


def align_to_order(pos_org: torch.Tensor,
                   pos_shuffled: torch.Tensor) -> torch.Tensor:
    """``idx`` with ``pos_shuffled[b, idx[b, t]] == pos_org[b, t]`` when
    the two sets are equal up to a permutation: a double stable argsort of
    integer keys, O(n log n)."""
    with span("geom.reorder"):
        p = torch.argsort(_pos_key(pos_shuffled), dim=1, stable=True)
        rank = torch.argsort(
            torch.argsort(_pos_key(pos_org), dim=1, stable=True),
            dim=1, stable=True)
        return torch.gather(p, 1, rank)


def max_norm_upsampling_mask(features: torch.Tensor) -> torch.Tensor:
    """Per-token feature norm."""
    return torch.linalg.vector_norm(features.float(), dim=2)


def compute_color_dist(im: torch.Tensor) -> torch.Tensor:
    """Sum of absolute RGB differences with the 4 neighbours; ``im`` NHWC,
    (b, H, W) out."""
    x = im.float()
    edge = torch.zeros(x.shape[:3], dtype=torch.float32, device=x.device)
    dy = (x[:, 1:] - x[:, :-1]).abs().sum(-1)
    dx = (x[:, :, 1:] - x[:, :, :-1]).abs().sum(-1)
    edge[:, 1:, :] += dy
    edge[:, :-1, :] += dy
    edge[:, :, 1:] += dx
    edge[:, :, :-1] += dx
    return edge


def color_change_upsampling_mask(images: torch.Tensor, pos: torch.Tensor,
                                 patch_size: int,
                                 min_patch_size: int) -> torch.Tensor:
    """Per-token colour-gradient oracle: :func:`compute_color_dist` summed
    over each token's ``patch_size``^2 pixels from ``pos * min_patch_size``
    (``pos`` (b, n, 2) as (x, y) in min-patch units; images NHWC)."""
    cd = compute_color_dist(images)  # b H W
    p0 = (pos.float() * min_patch_size).long()
    ii = torch.arange(patch_size, device=images.device)
    dy, dx = torch.meshgrid(ii, ii, indexing="ij")
    ys = p0[..., 1][..., None, None] + dy  # b n ps ps
    xs = p0[..., 0][..., None, None] + dx
    batch = torch.arange(cd.shape[0], device=cd.device)[:, None, None, None]
    return cd[batch, ys, xs].sum(dim=(-1, -2))


def random_upsampling_mask(model: nn.Module, j: int, b: int, n: int,
                           device: torch.device) -> torch.Tensor:
    """The random oracle scores (b, n) after backbone ``j``
    (:func:`maskfiner_ot.random_upsampling_mask`'s streams: fresh in
    training, fixed at eval). Module-level so tests can replay the JAX
    package's masks."""
    return _draw_mask(model, j, b, n, device)


class UpDownBackbone(nn.Module):
    """The UD classifier: NCHW images in, (b, num_classes) logits out (a
    list of one per output feature with ``aux_loss``)."""

    def __init__(self, backbones, backbone_dims, all_out_features,
                 n_scales, num_classes, bb_in_feats, aux_loss=False,
                 mask_seed: int = 0, compute_dtype=torch.float32):
        super().__init__()
        self.backbones = nn.ModuleList(backbones)
        self.n_scales = n_scales
        self.all_out_features = tuple(all_out_features)
        self.bb_in_feats = tuple(tuple(x) for x in bb_in_feats)
        self.aux_loss = aux_loss
        self.mask_seed = int(mask_seed)
        self.upsampling_masks: Dict[tuple, torch.Tensor] = {}
        self.upsample_generator: Optional[torch.Generator] = None
        if aux_loss:
            # one head per feature, on the width of its last level
            width = {f: d for bb, d in zip(self.backbones, backbone_dims)
                     for f in bb.out_features}
            self.heads = nn.ModuleList(
                Linear(width[f], num_classes, compute_dtype)
                for f in self.all_out_features)
        else:
            self.head = Linear(backbone_dims[-1], num_classes, compute_dtype)

    @property
    def final_upsampling_ratios(self) -> List[float]:
        return [bb.upscale_ratio for bb in self.backbones]

    @property
    def bb_scales(self) -> List[int]:
        scales = list(range(self.n_scales))
        return scales + scales[-2::-1]

    def _feature_scale(self, f: str) -> int:
        # res2 -> 3, ..., res5 -> 0
        return len(self.all_out_features) - 1 - self.all_out_features.index(f)

    def init_weights(self, generator: torch.Generator):
        return init_mixres_weights(self, generator)

    def forward(self, x: torch.Tensor):
        im = x.permute(0, 2, 3, 1).contiguous()  # NHWC, as the levels take it
        upsampling_mask = features = features_pos = None
        layout: Dict[int, int] = {}
        outs: Dict[str, Any] = {}
        for j, backbone in enumerate(self.backbones):
            output, layout = backbone(im, self.bb_scales[j], features,
                                      features_pos, upsampling_mask, layout)
            all_feat, all_scale, all_pos = [], [], []
            next_layout: Dict[int, int] = {}
            for f in backbone.out_features:
                feat = output[f]
                feat_pos = output[f + "_pos"]
                feat_scale = output[f + "_scale"]
                n = feat.shape[1]
                if f + "_pos" in outs:
                    # back to the first-recorded token order of f
                    idx = align_to_order(outs[f + "_pos"], feat_pos)
                    feat = gather_rows(feat, idx)
                    feat_pos = gather_rows(feat_pos, idx)
                    feat_scale = torch.gather(feat_scale, 1, idx)
                    outs[f].append(feat)
                else:
                    outs[f] = [feat]
                    outs[f + "_pos"] = feat_pos
                if (j + 1 < len(self.bb_in_feats)
                        and f in self.bb_in_feats[j + 1]):
                    if j >= self.n_scales - 1:
                        # skip connection: the matching encoder feature
                        res = outs[f][-((j - self.n_scales + 1) * 2 + 2)]
                        feat = torch.cat([feat, res], dim=2)
                    all_feat.append(feat)
                    all_pos.append(feat_pos)
                    all_scale.append(feat_scale)
                    next_layout[self._feature_scale(f)] = n
            if j < self.n_scales - 1:
                b, n, _ = all_feat[0].shape
                upsampling_mask = random_upsampling_mask(self, j, b, n,
                                                         x.device)
            if j < len(self.backbones) - 1:
                features_pos = torch.cat([torch.cat(all_scale, 1)[..., None],
                                          torch.cat(all_pos, 1)], dim=2)
                features = torch.cat(all_feat, dim=1)
                layout = next_layout

        if self.aux_loss:
            return [head(outs[f][-1].mean(dim=1))
                    for head, f in zip(self.heads, self.all_out_features)]
        return self.head(output[self.all_out_features[-1]].mean(dim=1))


BB_IN_FEATS = [
    [None], ["res5"], ["res5", "res4"], ["res5", "res4", "res3"],
    ["res5", "res4", "res3"], ["res5", "res4"], ["res5"], [None],
]


def build_up_down(config, dtype, upscale_ratios: Optional[Sequence[float]]
                  = None) -> UpDownBackbone:
    """The UD model of ``config.MODEL.MR``; ``upscale_ratios`` overrides
    the configured ratios (parameter shapes do not depend on them)."""
    import numpy as np

    mr = config.MODEL.MR
    n_scales = mr.N_RESOLUTION_SCALES
    n_total = len(mr.NAME)
    dpr_all = np.linspace(0, mr.DROP_PATH_RATE, sum(mr.DEPTHS)).tolist()

    def level_args(i):
        args = dict(
            drop_path_rate=tuple(
                dpr_all[sum(mr.DEPTHS[:i]): sum(mr.DEPTHS[: i + 1])]),
            channels=3 if i == 0 else mr.EMBED_DIM[i - 1],
            min_patch_size=mr.PATCH_SIZES[n_scales - 1],
            first_layer=i == 0, layer_scale=mr.LAYER_SCALE)
        if i >= n_scales:  # decoder: fewer scales, skip channels added
            args.update(
                scale=n_total - i - 1,
                patch_sizes=tuple(mr.PATCH_SIZES[i:]),
                out_features=tuple(mr.OUT_FEATURES[-(n_total - i):]),
                channels=mr.EMBED_DIM[i - 1] + mr.EMBED_DIM[n_total - i - 1])
        else:
            args.update(scale=i, patch_sizes=tuple(mr.PATCH_SIZES[: i + 1]),
                        out_features=tuple(mr.OUT_FEATURES[-(i + 1):]))
        return args

    return UpDownBackbone(
        build_backbones(config, dtype, upscale_ratios, level_args,
                        {"num_register_tokens": mr.NUM_REGISTER_TOKENS}),
        tuple(mr.EMBED_DIM), tuple(mr.OUT_FEATURES), n_scales,
        config.MODEL.NUM_CLASSES, BB_IN_FEATS, aux_loss=mr.AUX_LOSS,
        mask_seed=config.SEED, compute_dtype=dtype)
