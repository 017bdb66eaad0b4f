"""MaskFiner Oracle-Teacher: a coarse-to-fine cascade of MixRes backbones
(counterpart of the JAX package's ``models/maskfiner_ot.py``).

For scale 0..n-1 the scale's backbone runs on the concatenation of every
scale's features and positions so far. The upsampling mask is the random
oracle placeholder (:func:`random_upsampling_mask`). Head: LayerNorm and a
3-layer ReLU MLP over the per-scale mean-pools.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn

from ..parallel import comm
from .layers import LayerNormFp32
from .mixres_common import MLP, init_mixres_weights

__all__ = ["random_upsampling_mask", "OracleTeacherBackbone",
           "build_oracle_teacher", "build_backbones"]


def random_upsampling_mask(model: nn.Module, j: int, b: int, n: int,
                           device: torch.device) -> torch.Tensor:
    """The random oracle scores (b, n) for the mask after backbone ``j``.

    In training mode (``model.training``) a fresh draw per call, from
    ``model.upsample_generator`` (a CPU ``torch.Generator`` that the
    trainer owns; torch's global CPU generator when it is None), as the
    JAX package draws from its "upsample" rng stream in training. At eval
    a fixed mask: drawn from a ``torch.Generator`` seeded with
    ``model.mask_seed`` and ``j`` and kept on the model per (j, b, n,
    device), so every eval forward uses the same masks. Both are drawn on
    the CPU and moved to ``device``, so that the GPU and CPU forwards of
    one model (and one generator state) split the same tokens. The stream
    is the port's own, not JAX's threefry: tests replay the JAX package's
    masks by patching this module-level function. Under data parallelism
    both are the global batch's draw, sliced to this rank's rows
    (``parallel/comm.py::global_draw``)."""
    if model.training:
        return comm.global_draw(
            lambda rows: torch.randn((rows, n),
                                     generator=model.upsample_generator),
            b).to(device)
    key = (j, b, n, str(device))
    masks = model.upsampling_masks
    if key not in masks:
        gen = torch.Generator().manual_seed(model.mask_seed * 1009 + j)
        masks[key] = comm.global_draw(
            lambda rows: torch.randn((rows, n), generator=gen), b).to(device)
    return masks[key]


class OracleTeacherBackbone(nn.Module):
    """The OT classifier: NCHW images in, (b, num_classes) logits out."""

    def __init__(self, backbones, backbone_dims, n_scales, num_classes,
                 mask_seed: int = 0, compute_dtype=torch.float32):
        super().__init__()
        self.backbones = nn.ModuleList(backbones)
        self.n_scales = n_scales
        self.mask_seed = int(mask_seed)
        self.upsampling_masks: Dict[tuple, torch.Tensor] = {}
        self.upsample_generator: Optional[torch.Generator] = None
        tot = backbone_dims[-1] * n_scales
        self.head_norm = LayerNormFp32(tot)
        self.head = MLP(tot, tot, num_classes, 3, compute_dtype)

    @property
    def final_upsampling_ratios(self) -> List[float]:
        return [bb.upscale_ratio for bb in self.backbones]

    def init_weights(self, generator: torch.Generator):
        return init_mixres_weights(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        im = x.permute(0, 2, 3, 1).contiguous()  # NHWC, as the levels take it
        upsampling_mask = features = features_pos = None
        layout: Dict[int, int] = {}
        for scale, backbone in enumerate(self.backbones):
            output, layout = backbone(im, scale, features, features_pos,
                                      upsampling_mask, layout)
            bb_out_features = backbone.out_features
            all_feat = [output[f] for f in bb_out_features]
            if scale < len(self.backbones) - 1:
                b, n, _ = all_feat[0].shape
                upsampling_mask = random_upsampling_mask(self, scale, b, n,
                                                         x.device)
            features_pos = torch.cat([
                torch.cat([output[f + "_scale"] for f in bb_out_features],
                          dim=1)[..., None],
                torch.cat([output[f + "_pos"] for f in bb_out_features],
                          dim=1)], dim=2)
            features = torch.cat(all_feat, dim=1)
            # each emitted feature holds exactly the tokens of its scale
            layout = {self.n_scales - 1 - (int(f[3:]) - 2): output[f].shape[1]
                      for f in bb_out_features}
        # the last level's features, coarsest first
        vec = torch.cat([output[f].mean(dim=1)
                         for f in bb_out_features[::-1]], dim=1)
        return self.head(self.head_norm(vec))


def build_backbones(config, dtype, upscale_ratios, level_args,
                    vit_args=None):
    """The MixRes levels of ``config.MODEL.MR``. ``level_args(i)`` gives
    the arguments of level ``i`` that OT and UD set differently, its
    ``scale`` included; ``vit_args`` more arguments of every MixResViT."""
    from .mixres_neighbour import MixResNeighbour
    from .mixres_vit import MixResViT

    mr = config.MODEL.MR
    ratios = list(upscale_ratios) if upscale_ratios else list(mr.UPSCALE_RATIO)
    backbones = []
    for i, name in enumerate(mr.NAME):
        args = dict(
            n_layers=mr.DEPTHS[i], d_model=mr.EMBED_DIM[i],
            n_heads=mr.NUM_HEADS[i], mlp_ratio=mr.MLP_RATIO[i],
            dropout=mr.DROP_RATE[i], split_ratio=mr.SPLIT_RATIO[i],
            n_scales=mr.N_RESOLUTION_SCALES, upscale_ratio=ratios[i],
            compute_dtype=dtype, remat=str(config.TPU.REMAT),
            **level_args(i))
        scale = args.pop("scale")
        if name == "MixResViT":
            bb = MixResViT(**args, **(vit_args or {}))
        elif name == "MixResNeighbour":
            bb = MixResNeighbour(
                attn_drop_rate=mr.ATTN_DROP_RATE[i],
                cluster_size=mr.CLUSTER_SIZE[i], nbhd_size=mr.NBHD_SIZE[i],
                keep_old_scale=mr.KEEP_OLD_SCALE, scale=scale,
                add_image_data_to_all=mr.ADD_IMAGE_DATA_TO_ALL, **args)
        else:
            raise NotImplementedError(f"Unknown backbone: {name}")
        backbones.append(bb)
    return backbones


def build_oracle_teacher(config, dtype, upscale_ratios=None
                         ) -> OracleTeacherBackbone:
    """The OT model of ``config.MODEL.MR``; ``upscale_ratios`` overrides
    the configured ratios (parameter shapes do not depend on them)."""
    mr = config.MODEL.MR

    def level_args(i):
        dpr = mr.DROP_PATH_RATE
        dpr_i = dpr[i] if isinstance(dpr, (list, tuple)) else dpr
        return dict(
            patch_sizes=tuple(mr.PATCH_SIZES[: i + 1]),
            drop_path_rate=(float(dpr_i),) * int(mr.DEPTHS[i]),
            channels=3 if i == 0 else mr.EMBED_DIM[i - 1],
            min_patch_size=mr.PATCH_SIZES[-1],
            out_features=tuple(mr.OUT_FEATURES[-(i + 1):]), scale=i)

    return OracleTeacherBackbone(
        build_backbones(config, dtype, upscale_ratios, level_args),
        tuple(mr.EMBED_DIM), mr.N_RESOLUTION_SCALES,
        config.MODEL.NUM_CLASSES, mask_seed=config.SEED, compute_dtype=dtype)
