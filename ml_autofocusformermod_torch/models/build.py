"""Model factory: config -> ``nn.Module`` (counterpart of the JAX package's
``models/build.py``)."""

from __future__ import annotations

import torch

from .. import resolve_device
from .aff import AutoFocusFormer

__all__ = ["build_model", "DTYPES"]

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def build_model(config, device="cuda", seed=None):
    """Instantiate ``config.MODEL.TYPE`` on ``device`` in eval mode (call
    ``.train()`` for the JAX package's ``training=True``).

    ``seed`` (default ``config.SEED``) drives the random init through a
    ``torch.Generator``. The compute dtype is ``config.TPU.COMPUTE_DTYPE``;
    the dropout rates are ``MODEL.DROP_RATE``, ``MODEL.DROP_PATH_RATE`` and
    ``MODEL.ATTN_DROP_RATE`` (absent from the config tree, so 0, as the JAX
    package's ``build_model`` leaves it).
    """
    dev = resolve_device(device)
    model_type = config.MODEL.TYPE
    if model_type in ("maskfinerOT", "maskfinerUD"):
        raise NotImplementedError(
            f"MODEL.TYPE={model_type} is not ported yet (ROADMAP.md, queue A "
            "item 10: MaskFiner)")
    if model_type != "aff":
        raise NotImplementedError(f"Unknown model type: {model_type}")
    dtype_name = config.TPU.COMPUTE_DTYPE
    if dtype_name not in DTYPES:
        raise ValueError(f"TPU.COMPUTE_DTYPE={dtype_name!r}: use "
                         f"{sorted(DTYPES)}")
    aff = config.MODEL.AFF
    model = AutoFocusFormer(
        num_classes=config.MODEL.NUM_CLASSES,
        embed_dim=tuple(aff.EMBED_DIM),
        cluster_size=aff.CLUSTER_SIZE,
        nbhd_size=tuple(aff.NBHD_SIZE),
        alpha=aff.ALPHA,
        ds_rate=aff.DS_RATE,
        reserve_on=aff.RESERVE,
        depths=tuple(aff.DEPTHS),
        num_heads=tuple(aff.NUM_HEADS),
        mlp_ratio=aff.MLP_RATIO,
        patch_norm=aff.PATCH_NORM,
        layer_scale=aff.LAYER_SCALE,
        img_size=config.DATA.IMG_SIZE,
        drop_rate=config.MODEL.DROP_RATE,
        attn_drop_rate=config.MODEL.get("ATTN_DROP_RATE", 0.0),
        drop_path_rate=config.MODEL.DROP_PATH_RATE,
        compute_dtype=DTYPES[dtype_name],
    )
    gen = torch.Generator().manual_seed(config.SEED if seed is None else seed)
    model.init_weights(gen)
    return model.to(dev).eval()
