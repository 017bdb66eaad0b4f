"""Faults planted in the timed path, to show that the check catches them:
each takes the loop and its timed callable and returns the broken one.
Used by the tests and by ``calibrate.py --fault-seeds``: ``TRAINING`` and
``SERVING`` in every cell of their kind, ``FEATURES`` in a training cell
whose configuration turns the feature on (:func:`planted`)."""

from . import program
from .reference.train import accumulation, mixes


def unchanged_state(loop, step):
    """A training step that leaves the parameters and the optimizer's
    state as they were."""
    loop.optimizer.step = lambda grads: None
    return step


def half_batch(loop, step):
    """A training step over the first half of the batch, its mean taken
    over that half."""
    def half(images, labels):
        b = images.shape[0] // 2
        return step(images[:b], labels[:b])
    return half


def altered_answer(loop, forward):
    """An eval forward whose first answer's logits are rotated by one
    class."""
    def altered(images):
        out = forward(images).clone()
        out[0] = out[0].roll(1)
        return out
    return altered


TRAINING = {"unchanged_state": unchanged_state, "half_batch": half_batch}
SERVING = {"altered_answer": altered_answer}


def drop_path_late(loop, step):
    """A training step whose every stochastic-depth mask is the one the
    next call would have drawn: one mask's draw is spent before it."""
    def late(images, labels):
        program.drop_path_draw(loop.prog, images.shape[0])
        return step(images, labels)
    return late


def gamma_left_out(loop, step):
    """A training step whose blocks leave their layer-scale gammas out."""
    program.leave_out_layer_scale(loop.prog)
    return step


def mixup_lambda_changed(loop, step):
    """A training step whose mixup / cutmix lambda is 0.5 whatever was
    drawn (0.5 is no batch-flip of the true mix, as ``1 - lambda`` is)."""
    def changed(images, labels):
        with program.mixup_lambda(lambda lam: 0.5):
            return step(images, labels)
    return changed


def adamw_every_micro_step(loop, step):
    """AdamW stepped on every micro-step, not on the mean of an update's
    micro-gradients."""
    loop.optimizer.every_k = 1
    return step


def _arch(cfg):
    model = cfg["model"]
    return model.get("arch") or model.get("mr")


FEATURES = {
    "drop_path_late": (drop_path_late,
                       lambda cfg: _arch(cfg).get("drop_path_rate", 0) > 0),
    "gamma_left_out": (gamma_left_out,
                       lambda cfg: _arch(cfg).get("layer_scale", 0) > 0),
    "mixup_lambda_changed": (mixup_lambda_changed,
                             lambda cfg: mixes(cfg["train"])),
    "adamw_every_micro_step": (adamw_every_micro_step,
                               lambda cfg: accumulation(cfg["train"]) > 1),
}


def planted(cfg: dict, kind: str) -> dict:
    """The faults a cell of ``cfg`` under traffic of ``kind`` can have."""
    if kind != "train":
        return dict(SERVING)
    return {**TRAINING, **{name: fault for name, (fault, on) in
                           FEATURES.items() if on(cfg)}}
