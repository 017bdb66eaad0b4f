"""Model factory: config -> ``nn.Module`` (counterpart of the JAX package's
``models/build.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from .. import resolve_device
from .aff import AutoFocusFormer
from .maskfiner_ot import build_oracle_teacher
from .maskfiner_ud import build_up_down

__all__ = ["build_model", "check_switches", "DTYPES"]

DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def check_switches(config, device, world: Optional[int] = None) -> None:
    """Refuse the JAX package's settings that the port cannot honour,
    rather than ignore them: a ``(TPU.MESH_DATA, TPU.MESH_MODEL,
    TPU.MESH_SEQ)`` mesh whose sizes do not multiply to the ``world`` of
    processes (default: the running process group's, 1 without one; a
    data size of -1 takes every rank that model x seq leave), a
    ``DATA.BATCH_SIZE`` that the data size does not divide, and
    ``TPU.USE_PALLAS: false`` on the card, which has no kernel-free route
    (the CPU path is the plain version anyway). Every mesh key is
    honoured: data and tensor parallelism, ZeRO-1 and sequence
    parallelism (``parallel/``)."""
    tpu = config.TPU
    if world is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
    data, model = int(tpu.MESH_DATA), int(tpu.MESH_MODEL)
    seq = int(tpu.MESH_SEQ)
    if model < 1 or seq < 1 or (data != -1 and data < 1):
        raise ValueError(f"TPU.MESH_DATA={data}, TPU.MESH_MODEL={model}, "
                         f"TPU.MESH_SEQ={seq}: sizes are positive (-1: "
                         "every rank left for data)")
    if data == -1:
        if world % (model * seq):
            raise ValueError(f"mesh TPU.MESH_DATA=-1 x TPU.MESH_MODEL="
                             f"{model} x TPU.MESH_SEQ={seq} != {world} "
                             "processes (model x seq does not divide them)")
        data = world // (model * seq)
    if data * model * seq != world:
        raise ValueError(f"mesh TPU.MESH_DATA={data} x TPU.MESH_MODEL="
                         f"{model} x TPU.MESH_SEQ={seq} != {world} processes")
    if config.DATA.BATCH_SIZE % data:
        raise ValueError(f"DATA.BATCH_SIZE={config.DATA.BATCH_SIZE} must be "
                         f"divisible by the data size {data}")
    if not tpu.USE_PALLAS and torch.device(device).type == "cuda":
        raise ValueError("TPU.USE_PALLAS=False: the port has no kernel-free "
                         "route on the card; run --device cpu for the plain "
                         "version")


def build_model(config, device="cuda", seed=None, upscale_ratios=None):
    """Instantiate ``config.MODEL.TYPE`` on ``device`` in eval mode (call
    ``.train()`` for the JAX package's ``training=True``): ``aff``, or the
    MaskFiner wrappers ``maskfinerOT`` and ``maskfinerUD``.

    ``seed`` (default ``config.SEED``) drives the random init through a
    ``torch.Generator``; the MaskFiner upsampling masks are seeded from
    ``config.SEED``. ``upscale_ratios`` overrides the MaskFiner upsampling
    ratios (the curriculum's rebuild; parameter shapes do not depend on
    them). The compute dtype is ``config.TPU.COMPUTE_DTYPE``; the AFF
    dropout rates are ``MODEL.DROP_RATE``, ``MODEL.DROP_PATH_RATE`` and
    ``MODEL.ATTN_DROP_RATE`` (absent from the config tree, so 0, as the JAX
    package's ``build_model`` leaves it), MaskFiner's those of
    ``MODEL.MR``; ``TPU.REMAT`` sets every block's recompute in the
    backward (``layers.remat_call``). Settings the port cannot honour raise
    (:func:`check_switches`).
    """
    dev = resolve_device(device)
    check_switches(config, dev)
    model_type = config.MODEL.TYPE
    if model_type not in ("aff", "maskfinerOT", "maskfinerUD"):
        raise NotImplementedError(f"Unknown model type: {model_type}")
    dtype_name = config.TPU.COMPUTE_DTYPE
    if dtype_name not in DTYPES:
        raise ValueError(f"TPU.COMPUTE_DTYPE={dtype_name!r}: use "
                         f"{sorted(DTYPES)}")
    dtype = DTYPES[dtype_name]
    if model_type == "maskfinerOT":
        model = build_oracle_teacher(config, dtype, upscale_ratios)
    elif model_type == "maskfinerUD":
        model = build_up_down(config, dtype, upscale_ratios)
    else:
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
            compute_dtype=dtype,
            remat=str(config.TPU.REMAT),
        )
    gen = torch.Generator().manual_seed(config.SEED if seed is None else seed)
    model.init_weights(gen)
    return model.to(dev).eval()
