"""Config tree + YAML loader with BASE inheritance and dotted overrides.

The port's own copy of the JAX package's config system (same default tree,
same ``BASE`` inheritance, ``--opts KEY VALUE`` merges and CLI overrides),
so ``ml_autofocusformermod_torch`` never imports the JAX package. The
presets it serves live in ``ml_autofocusformermod_torch/configs/`` and are
byte-equal copies of the JAX package's files (pinned by a test). The
``TPU`` node keeps its name so one YAML and one ``--opts`` list configure
both packages; the port reads ``TPU.COMPUTE_DTYPE`` for its compute dtype.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List, Optional

import yaml

__all__ = ["CfgNode", "default_config", "get_config", "load_config"]


class CfgNode(dict):
    """Dict with attribute access and freeze semantics (yacs-lite)."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init: Optional[Dict] = None):
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        self[name] = value

    def freeze(self, frozen: bool = True) -> "CfgNode":
        object.__setattr__(self, CfgNode.IMMUTABLE, frozen)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze(frozen)
        return self

    def defrost(self) -> "CfgNode":
        return self.freeze(False)

    def clone(self) -> "CfgNode":
        node = CfgNode()
        for k, v in self.items():
            node[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return node

    def merge_from_dict(self, other: Dict, prefix: str = "") -> None:
        for k, v in other.items():
            full = f"{prefix}.{k}" if prefix else k
            if k not in self:
                raise KeyError(f"unknown config key: {full}")
            if isinstance(v, dict):
                if not isinstance(self[k], CfgNode):
                    raise TypeError(f"cannot merge dict into leaf {full}")
                self[k].merge_from_dict(v, full)
            else:
                self[k] = _coerce(v, self[k], full)

    def merge_from_list(self, opts: List[str]) -> None:
        assert len(opts) % 2 == 0, "--opts must be KEY VALUE pairs"
        for key, value in zip(opts[::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"unknown config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"unknown config key: {key}")
            if isinstance(value, str):
                try:
                    value = yaml.safe_load(value)
                except yaml.YAMLError:
                    pass
            node[leaf] = _coerce(value, node[leaf], key)

    def to_dict(self) -> Dict:
        return {
            k: (v.to_dict() if isinstance(v, CfgNode) else v)
            for k, v in self.items()
        }

    def dump_yaml(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Light type checking mirroring yacs behavior."""
    if old is None or value is None:
        return value
    if isinstance(old, bool):
        if isinstance(value, bool):
            return value
        raise TypeError(f"{key}: expected bool, got {value!r}")
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    # pyyaml parses dotless exponents like "1e-5" as strings; coerce them
    if isinstance(old, float) and isinstance(value, str):
        try:
            return float(value)
        except ValueError as e:
            raise TypeError(f"{key}: expected float, got {value!r}") from e
    if isinstance(old, (list, tuple)) and isinstance(value, (list, tuple)):
        return list(value)
    if type(old) is type(value):
        return value
    if isinstance(old, (int, float)) and isinstance(value, (int, float)):
        return value
    if isinstance(old, str) or isinstance(value, str):
        if isinstance(old, str) and isinstance(value, str):
            return value
        raise TypeError(f"{key}: expected {type(old).__name__}, got {value!r}")
    raise TypeError(f"{key}: expected {type(old).__name__}, got {value!r}")


def default_config() -> CfgNode:
    """Full default tree — key-for-key with reference ``config.py:13-196``."""
    c = CfgNode()
    c.BASE = [""]

    c.DATA = CfgNode()
    c.DATA.BATCH_SIZE = 128  # per-process batch size
    c.DATA.DATA_PATH = "imagenet"
    c.DATA.DATASET = "imagenet"
    c.DATA.IMG_SIZE = 224
    c.DATA.IN_CHANS = 3
    c.DATA.INTERPOLATION = "bicubic"
    c.DATA.PIN_MEMORY = True
    c.DATA.NUM_WORKERS = 32
    # wire format of normalized train images (worker IPC + H2D payload):
    # "float16" halves it with fp16 quantization ~8-16x below bf16 compute
    # rounding; eval always ships float32 (exact parity)
    c.DATA.TRANSPORT_DTYPE = "float32"

    c.MODEL = CfgNode()
    c.MODEL.TYPE = "aff"
    c.MODEL.NAME = "aff_mini_1_4th"
    c.MODEL.RESUME = ""
    c.MODEL.PRETRAINED = ""
    c.MODEL.NUM_CLASSES = 1000
    c.MODEL.DROP_RATE = 0.0
    c.MODEL.DROP_PATH_RATE = 0.0
    c.MODEL.LABEL_SMOOTHING = 0.1

    c.MODEL.AFF = CfgNode()
    c.MODEL.AFF.DEPTHS = [2, 2, 6, 2]
    c.MODEL.AFF.NUM_HEADS = [2, 4, 8, 16]
    c.MODEL.AFF.EMBED_DIM = [32, 128, 256, 384]
    c.MODEL.AFF.MLP_RATIO = 2.0
    c.MODEL.AFF.PATCH_NORM = True
    c.MODEL.AFF.CLUSTER_SIZE = 8
    c.MODEL.AFF.NBHD_SIZE = [48, 48, 48, 49]
    c.MODEL.AFF.ALPHA = 4.0
    c.MODEL.AFF.DS_RATE = 0.25
    c.MODEL.AFF.LAYER_SCALE = 0.0
    c.MODEL.AFF.RESERVE = True
    # referenced by the reference's 22kto1k presets but undeclared there
    c.MODEL.AFF.PRETRAINED = ""

    c.MODEL.MR = CfgNode()
    c.MODEL.MR.NAME = [
        "MixResViT", "MixResNeighbour", "MixResNeighbour", "MixResNeighbour",
    ]
    c.MODEL.MR.EMBED_DIM = [512, 256, 128, 64]
    c.MODEL.MR.DEPTHS = [4, 4, 4, 4]
    c.MODEL.MR.NUM_HEADS = [32, 16, 8, 4]
    c.MODEL.MR.PATCH_SIZES = [32, 16, 8, 4]
    c.MODEL.MR.SPLIT_RATIO = [4, 4, 4, 4]
    c.MODEL.MR.MLP_RATIO = [4.0, 4.0, 4.0, 4.0]
    c.MODEL.MR.UPSCALE_RATIO = [0.25, 0.25, 0.25, 0.25]
    c.MODEL.MR.DROP_RATE = [0.0, 0.0, 0.0, 0.0]
    c.MODEL.MR.DROP_PATH_RATE = 0.3
    c.MODEL.MR.ATTN_DROP_RATE = [0.0, 0.0, 0.0, 0.0]
    c.MODEL.MR.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    c.MODEL.MR.CLUSTER_SIZE = [8, 8, 8, 8]
    c.MODEL.MR.NBHD_SIZE = [48, 48, 48, 48]
    c.MODEL.MR.KEEP_OLD_SCALE = False
    c.MODEL.MR.ADD_IMAGE_DATA_TO_ALL = False
    c.MODEL.MR.OUT_DIM = 256
    c.MODEL.MR.N_RESOLUTION_SCALES = 4
    c.MODEL.MR.NUM_REGISTER_TOKENS = 0
    c.MODEL.MR.LAYER_SCALE = 0.0
    c.MODEL.MR.AUX_LOSS = False

    c.TRAIN = CfgNode()
    c.TRAIN.START_EPOCH = 0
    c.TRAIN.EPOCHS = 300
    c.TRAIN.WARMUP_EPOCHS = 20
    c.TRAIN.COOLDOWN_EPOCHS = 0
    c.TRAIN.WEIGHT_DECAY = 0.05
    c.TRAIN.BASE_LR = 5e-4
    c.TRAIN.WARMUP_LR = 5e-7
    c.TRAIN.MIN_LR = 5e-6
    c.TRAIN.USE_EMA = False
    c.TRAIN.EMA_DECAY = 0.9998
    c.TRAIN.CLIP_GRAD = 5.0
    c.TRAIN.AUTO_RESUME = True
    c.TRAIN.ACCUMULATION_STEPS = 0

    c.TRAIN.LR_SCHEDULER = CfgNode()
    c.TRAIN.LR_SCHEDULER.NAME = "cosine"
    c.TRAIN.LR_SCHEDULER.DECAY_EPOCHS = 30
    c.TRAIN.LR_SCHEDULER.DECAY_RATE = 0.1

    c.TRAIN.OPTIMIZER = CfgNode()
    c.TRAIN.OPTIMIZER.NAME = "adamw"
    c.TRAIN.OPTIMIZER.EPS = 1e-8
    c.TRAIN.OPTIMIZER.BETAS = [0.9, 0.999]
    c.TRAIN.OPTIMIZER.MOMENTUM = 0.9

    c.AUG = CfgNode()
    c.AUG.COLOR_JITTER = 0.4
    c.AUG.AUTO_AUGMENT = "rand-m9-mstd0.5-inc1"
    c.AUG.REPROB = 0.25
    c.AUG.REMODE = "pixel"
    c.AUG.RECOUNT = 1
    c.AUG.MIXUP = 0.0
    c.AUG.CUTMIX = 0.0
    c.AUG.CUTMIX_MINMAX = None
    c.AUG.MIXUP_PROB = 1.0
    c.AUG.MIXUP_SWITCH_PROB = 0.5
    c.AUG.MIXUP_MODE = "batch"

    c.TEST = CfgNode()
    c.TEST.CROP = True

    # TPU-specific knobs (new; no reference equivalent)
    c.TPU = CfgNode()
    c.TPU.COMPUTE_DTYPE = "bfloat16"  # 'float32' for parity eval
    c.TPU.USE_PALLAS = True  # fused Pallas attention kernels on TPU
    c.TPU.MESH_DATA = -1  # data-parallel mesh size; -1 = all devices
    c.TPU.MESH_MODEL = 1  # tensor-parallel mesh axis (parallel/tp.py)
    c.TPU.MESH_SEQ = 1  # sequence-parallel mesh axis (token-axis sharding)
    c.TPU.ZERO1 = False  # shard Adam moments + EMA over `data` (parallel/zero.py)
    # rematerialize attention blocks in backward to cut activation memory:
    # '' = off, 'blocks' = full per-block remat, 'dots' = keep matmul
    # outputs, recompute elementwise interior (models/layers.py::remat_wrap)
    c.TPU.REMAT = ""
    # per-preset lowering knobs (A/B winners differ per model; see PERF.md).
    # '' keeps the code default / any MLAFF_* env override. WF_MODE: the
    # ClusterMerging WF contraction lowering ('vpu'|'ic'|'einsum') — 'ic'
    # wins on AFF-Mini (+1.2%) but loses on Small (-2%).
    c.TPU.WF_MODE = ""
    # ClusterMerging aggregation: '' = XLA one-hot gather + WF reduce,
    # 'pallas' = fused in-VMEM merge kernel (ops/merge_pallas.py v3)
    c.TPU.MERGE = ""

    c.AMP_ENABLE = True
    c.OUTPUT = ""
    c.TAG = "default"
    c.SAVE_FREQ = 5
    c.PRINT_FREQ = 20
    c.EVAL_FREQ = 1
    c.SEED = 0
    c.EVAL_MODE = False
    c.THROUGHPUT_MODE = False
    # ptflops-equivalent startup FLOPs report (reference main.py:108-111);
    # off by default: it costs one extra XLA compile of a batch-1 forward
    c.PRINT_FLOPS = False
    # jax.profiler trace output dir; when set, a window of train steps
    # (PROFILE_START..+PROFILE_STEPS) is traced for XProf/TensorBoard
    c.PROFILE = ""
    c.PROFILE_START = 10
    c.PROFILE_STEPS = 5
    c.LOCAL_RANK = 0
    return c


def _update_from_file(config: CfgNode, cfg_file: str) -> None:
    with open(cfg_file, "r") as f:
        yaml_cfg = yaml.safe_load(f) or {}
    for base in yaml_cfg.setdefault("BASE", [""]):
        if base:
            _update_from_file(
                config, os.path.join(os.path.dirname(cfg_file), base)
            )
    print(f"=> merge config from {cfg_file}")
    yaml_cfg.pop("BASE", None)
    config.merge_from_dict(yaml_cfg)


def load_config(
    cfg_file: Optional[str] = None,
    opts: Optional[List[str]] = None,
    **overrides: Any,
) -> CfgNode:
    """Build a frozen config: defaults -> BASE yamls -> cfg yaml -> opts -> kwargs.

    ``overrides`` mirror the reference CLI args (``config.py:222-241``):
    batch_size, data_path, blr, resume, accumulation_steps, output, tag,
    eval, throughput, epochs.
    """
    config = default_config()
    if cfg_file:
        _update_from_file(config, cfg_file)
    if opts:
        config.merge_from_list(list(opts))

    if overrides.get("batch_size"):
        config.DATA.BATCH_SIZE = overrides["batch_size"]
    if overrides.get("data_path"):
        config.DATA.DATA_PATH = overrides["data_path"]
    if overrides.get("blr"):
        config.TRAIN.BASE_LR = overrides["blr"]
    if overrides.get("resume"):
        config.MODEL.RESUME = overrides["resume"]
    if overrides.get("accumulation_steps"):
        config.TRAIN.ACCUMULATION_STEPS = overrides["accumulation_steps"]
    if overrides.get("output"):
        config.OUTPUT = overrides["output"]
    if overrides.get("tag"):
        config.TAG = overrides["tag"]
    if overrides.get("eval"):
        config.EVAL_MODE = True
    if overrides.get("throughput"):
        config.THROUGHPUT_MODE = True
    if overrides.get("epochs"):
        config.TRAIN.EPOCHS = overrides["epochs"]
    if overrides.get("profile"):
        config.PROFILE = overrides["profile"]

    config.OUTPUT = os.path.join(config.OUTPUT, config.MODEL.NAME, config.TAG)
    return config.freeze()


def get_config(args) -> CfgNode:
    """argparse-namespace entry point matching reference ``get_config``."""
    return load_config(
        cfg_file=getattr(args, "cfg", None),
        opts=getattr(args, "opts", None),
        batch_size=getattr(args, "batch_size", None),
        data_path=getattr(args, "data_path", None),
        blr=getattr(args, "blr", None),
        resume=getattr(args, "resume", None),
        accumulation_steps=getattr(args, "accumulation_steps", None),
        output=getattr(args, "output", None),
        tag=getattr(args, "tag", None),
        eval=getattr(args, "eval", False),
        throughput=getattr(args, "throughput", False),
        epochs=getattr(args, "epochs", None),
        profile=getattr(args, "profile", None),
    )
