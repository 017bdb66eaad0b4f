"""Everything a run makes from its seed: weights, images and labels.

Each stream has a generator of its own, seeded from the run's seed and the
stream's number, on the device the data lives on, and draws in a few large
calls. The same seed gives the same tensors to the program and to the
reference.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch

WEIGHTS, IMAGES, LABELS, MASKS, SAMPLE = range(5)

# bare parameters the models draw from N(0, 1)
_UNIT_NORMAL = ("blank_k", "blank_v", "rel_pos_emb", "scale_emb")
# scales of a branch or a token kind, drawn as a norm's scale
_NEAR_ONE = ("importance", "gamma1", "gamma2")


def stream_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for ``stream`` of the run ``seed`` (any whole number)."""
    return (int(seed) * 1000003 + 7919 * stream + 1) % (2 ** 63)


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream))


def _scale(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    """(mean, std) of a leaf: fan-in scaled convolutions, std-0.02 products,
    unit-normal tokens and embeddings, norms and layer-scale gammas near 1
    (so a branch enters at about its own size, as in a model without layer
    scale), small biases."""
    if name.endswith(_UNIT_NORMAL):
        return 0.0, 1.0
    if name.endswith(_NEAR_ONE):
        return 1.0, 0.1
    if len(shape) == 4:
        fan_in = shape[1] * shape[2] * shape[3]
        return 0.0, fan_in ** -0.5
    if len(shape) >= 2:
        return 0.0, 0.02
    if name.endswith("weight"):
        return 1.0, 0.1
    return 0.0, 0.02


def make_weights(shapes: Iterable[Tuple[str, Tuple[int, ...]]], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """Float32 weights for every ``(name, shape)``, from one draw of
    normals clipped to two standard deviations. BatchNorm running means are
    0 and variances 1."""
    shapes = list(shapes)
    total = sum(int(torch.Size(s).numel()) for _, s in shapes)
    flat = torch.randn(total, generator=generator(seed, WEIGHTS, device),
                       device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for name, shape in shapes:
        size = int(torch.Size(shape).numel())
        z = flat[at:at + size].view(shape)
        at += size
        if name.endswith("running_mean"):
            out[name] = torch.zeros(shape, device=device)
        elif name.endswith("running_var"):
            out[name] = torch.ones(shape, device=device)
        else:
            mean, std = _scale(name, tuple(shape))
            out[name] = z * std + mean
    return out


def float_state_shapes(module: torch.nn.Module):
    """``(name, shape)`` of every floating tensor of ``module``'s state
    dict, in its order."""
    return [(k, tuple(t.shape)) for k, t in module.state_dict().items()
            if t.is_floating_point()]


def make_batches(seed: int, count: int, batch: int, img_size: int,
                 num_classes: int, device):
    """``count`` batches of ``(images (batch, 3, s, s) float32, labels
    (batch,) int64)``: standard-normal pixels, uniform labels; every image
    differs."""
    gi = generator(seed, IMAGES, device)
    gl = generator(seed, LABELS, device)
    n = count * batch
    images = torch.randn((n, 3, img_size, img_size), generator=gi,
                         device=device)
    labels = torch.randint(0, num_classes, (n,), generator=gl,
                           device=device)
    return [(images[i * batch:(i + 1) * batch].contiguous(),
             labels[i * batch:(i + 1) * batch].contiguous())
            for i in range(count)]
