"""The optimizer's multi-tensor update on the card (marker ``cuda``; skips
without an NVIDIA GPU), against the per-leaf rules of
``torch_optim_reference.py`` on the same card.

This file imports no JAX, so it runs where the card is and JAX is not,
without the suite's ``conftest.py`` (which imports JAX)::

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_optim_card.py
"""

import json
import os

import pytest
import torch

from ml_autofocusformermod_torch.config import load_config
from ml_autofocusformermod_torch.models.build import build_model
from ml_autofocusformermod_torch.train import optim

import torch_optim_reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_CFG = os.path.join(ROOT, "ml_autofocusformermod_torch", "configs",
                        "aff_mini.yaml")
# the device events of a chrome trace, as h100bench/trace.py counts them
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the multi-tensor kernels of the "
                    "update are the card's")
    return torch.device("cuda")


def _device_events(prof, path):
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def _size_one_strides(t):
    """``t`` with stride 1 in its dims of size 1."""
    return t.as_strided(t.shape, [1 if n == 1 else s
                                  for n, s in zip(t.shape, t.stride())])


@pytest.mark.cuda
def test_multi_tensor_update_matches_per_leaf_on_card(cuda_device, tmp_path):
    """AdamW at the benchmark's settings (clip 5.0, weight decay 0.05) over
    AFF-Mini's 258 parameters: an update whose gradients clip, then one
    whose gradients do not, equal the per-leaf rules with the same norm:
    ``mu`` and ``nu`` bit for bit, the parameters within rtol 1e-6 (a
    division by a Python scalar may take the reciprocal on one path and not
    on the other). One update, its global norm included, launches fewer
    than 300 device operations."""
    cfg = load_config(PORT_CFG, opts=["MODEL.NUM_CLASSES", "1000"])
    model = build_model(cfg, device=cuda_device, seed=0)
    params = dict(model.named_parameters())
    assert len(params) == 258
    opt = optim.Optimizer(params, "adamw", lambda k: 1e-3 * 0.99 ** k,
                          weight_decay=0.05, clip=5.0)
    ref = torch_optim_reference.PerLeaf(opt, norm=optim.global_norm)
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    # norms of about 26 and 0.26 (6.75 M entries); stride 1 in size-1 dims,
    # as autograd gives UD-Mini's depthwise conv weights' gradients
    grads = [{k: _size_one_strides(
                 scale * torch.randn(p.shape, device=cuda_device,
                                     generator=gen))
              for k, p in params.items()} for scale in (1e-2, 1e-4)]
    steps0 = optim.multi_tensor_update.steps
    for i, g in enumerate(grads):
        norm = opt.global_norm(g)
        assert (norm.item() > opt.clip) == (i == 0)
        opt.step(g)
        ref.step(g)
        torch.cuda.synchronize()
        for k, p in params.items():
            for moment in ("mu", "nu"):
                assert torch.equal(opt.state[moment][k],
                                   ref.state[moment][k]), (moment, k, i)
            torch.testing.assert_close(p.detach(), ref.params[k], rtol=1e-6,
                                       atol=0, msg=f"{k} at {i}")
    assert optim.multi_tensor_update.steps - steps0 == len(grads)

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        opt.global_norm(grads[0])
        opt.step(grads[0])
        torch.cuda.synchronize()
    launches = len(_device_events(prof, str(tmp_path / "update.json")))
    assert 0 < launches < 300, launches
