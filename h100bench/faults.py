"""Faults planted in the timed path, to show that the check catches them:
each takes the loop and its timed callable and returns the broken one.
Used by the tests and by ``calibrate.py --fault-seeds``."""


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
