"""The system under test, as the benchmark drives it: the measured
package's own entry points, and nothing else of it.

* :func:`build` loads the configuration's preset through
  ``config.load_config`` with the configuration file's ``opts``, builds
  the model with ``models/build.py::build_model``, sets a MaskFiner
  model's upsampling ratios with ``train/curriculum.py::
  set_upsample_ratios``, and loads the weights the benchmark made.
* :func:`train_step` is ``train/trainer.py::make_train_step``'s step over
  a ``create_train_state`` state whose schedule starts where the
  configuration says and whose upsampling masks the benchmark seeds.
* :func:`serve` is the eval-mode forward, as ``make_eval_step`` calls it.

This is the only module of the benchmark that imports the package.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

PACKAGE = "ml_autofocusformermod_torch"


def build_kernels() -> None:
    """Build every CUDA source of the package at once (a cache hit after
    the first run in a checkout)."""
    from ml_autofocusformermod_torch.ops import _build

    _build.build_all()


def build(cfg: dict, device: str, seed: int, weights) -> Dict[str, object]:
    """The model of ``cfg`` on ``device`` with ``weights(model)``'s state
    loaded; returns ``{"config", "model"}``."""
    from ml_autofocusformermod_torch.config import load_config
    from ml_autofocusformermod_torch.models.build import build_model
    from ml_autofocusformermod_torch.train.curriculum import (
        set_upsample_ratios)

    opts = []
    for k, v in cfg["opts"].items():
        opts += [k, str(v)]
    opts += ["SEED", str(seed)]
    config = load_config(cfg["preset"], opts=opts)
    model = build_model(config, device=device, seed=0)
    ratios = cfg["model"].get("upscale_ratios")
    if ratios is not None:
        set_upsample_ratios(model, ratios)
    missing, unexpected = model.load_state_dict(weights(model), strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise RuntimeError(f"weights: missing {missing}, unexpected "
                           f"{unexpected}")
    return {"config": config, "model": model}


def make_train_step(prog: Dict[str, object], cfg: dict, mask_seed: int):
    """``(step(images, labels) -> metrics, optimizer)`` over a
    fresh train state whose schedule starts at the configuration's
    ``train.start_step``; a MaskFiner model draws its training masks from
    a CPU generator seeded with ``mask_seed``."""
    from ml_autofocusformermod_torch.train.trainer import (
        create_train_state, make_train_step as make)

    hp = cfg["train"]
    model = prog["model"]
    state, schedule = create_train_state(
        prog["config"], model, n_steps_per_epoch=hp["steps_per_epoch"],
        seed=mask_seed)
    state.optimizer.load_state_dict({"sched_count": hp["start_step"]})
    if hasattr(model, "upsample_generator"):
        state.upsample_generator = torch.Generator().manual_seed(mask_seed)
        model.upsample_generator = state.upsample_generator
    return make(prog["config"], state, schedule), state.optimizer


def first_moments(optimizer) -> Dict[str, torch.Tensor]:
    """The optimizer's first moments, by parameter name."""
    return optimizer.state["mu"]


def serve(prog: Dict[str, object]):
    """``forward(images) -> logits``: the eval-mode forward."""
    model = prog["model"]
    model.eval()

    @torch.no_grad()
    def forward(images):
        out = model(images)
        return out[-1] if isinstance(out, (list, tuple)) else out

    return forward


# ----------------------------------------------- hooks of planted faults
def drop_path_draw(prog: Dict[str, object], b: int) -> None:
    """Spend one stochastic-depth mask's draw of the model's generator."""
    from ml_autofocusformermod_torch.models.layers import DropPath

    gen = next(m.generator for m in prog["model"].modules()
               if isinstance(m, DropPath) and m.rate > 0)
    torch.rand((b, 1, 1), generator=gen, device=gen.device)


def leave_out_layer_scale(prog: Dict[str, object]) -> None:
    """Make every block add its branches without their gammas."""
    for m in prog["model"].modules():
        if getattr(m, "use_layer_scale", False):
            m.use_layer_scale = False


@contextlib.contextmanager
def mixup_lambda(change):
    """Inside the block the package's mixup / cutmix lambda is
    ``change(lambda)``."""
    from ml_autofocusformermod_torch.train import losses

    draw = losses._beta
    losses._beta = lambda gen, alpha: change(draw(gen, alpha))
    try:
        yield
    finally:
        losses._beta = draw
