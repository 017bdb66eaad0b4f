"""Serving export of the port (``ckpt/export.py``), on the CPU, beside the
JAX package's ``tests/test_export.py``.

* the round trip: ``export_forward`` / ``save_exported`` /
  ``load_exported`` of a tiny AFF (JAX's test_export config) and a tiny
  Up-Down model reproduce the eager eval logits, and an eager forward
  after the export is unchanged (the trace stored no traced tensor in the
  module-level caches);
* the loaded program against JAX's exported artifact (``jax.export``) on
  the same weights (``from_jax``) and images, within 1e-5;
* weights are arguments: a second weight set gives that model's logits;
* loading in a fresh process imports none of the port's model code.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from ml_autofocusformermod_torch.ckpt import export as pexport
from ml_autofocusformermod_torch.ckpt.from_jax import state_dict_from_flax
from ml_autofocusformermod_torch.models.aff import AutoFocusFormer
from ml_autofocusformermod_torch.models.build import build_model
from ml_autofocusformermod_tpu.ckpt import export as jexport
from ml_autofocusformermod_tpu.models.aff import AutoFocusFormer as JaxAFF
from test_torch_maskfiner import port_tiny_mr

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(num_classes=10, embed_dim=(16, 32, 48, 64), depths=(1, 1, 1, 1),
           num_heads=(2, 2, 4, 4), img_size=56, drop_path_rate=0.0)


def _aff(seed):
    model = AutoFocusFormer(**CFG)
    return model.init_weights(torch.Generator().manual_seed(seed)).eval()


def _ud(seed):
    return build_model(port_tiny_mr("maskfiner_up_down_mini.yaml"), "cpu",
                       seed=seed)


def _images(size, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.standard_normal((2, 3, size, size)).astype(np.float32))


@pytest.mark.parametrize("name,make,size", [("aff", _aff, 56),
                                            ("ud", _ud, 64)])
def test_export_roundtrip(tmp_path, name, make, size):
    model = make(0)
    x = _images(size)
    with torch.no_grad():
        want = model(x)
    data = pexport.export_forward(model, 2, size, "cpu")
    path = str(tmp_path / f"{name}.pt2")
    pexport.save_exported(path, data)
    fn = pexport.load_exported(path)
    assert torch.equal(fn(model.state_dict(), x), want)
    with torch.no_grad():
        assert torch.equal(model(x), want)  # eager, after the export
    # weights are arguments: another seed's weights give that model's
    # logits from the same artifact
    other = make(1)
    with torch.no_grad():
        want_other = other(x)
    assert not torch.equal(want_other, want)
    assert torch.equal(fn(other.state_dict(), x), want_other)


def test_export_matches_jax_exported_forward():
    jmodel = JaxAFF(**CFG)
    images = np.array(jax.random.normal(jax.random.PRNGKey(1),
                                        (2, 56, 56, 3)))
    variables = jmodel.init(jax.random.PRNGKey(0), images, training=False)
    jfn = jexport.load_exported(jexport.export_forward(jmodel, variables, 2,
                                                       56))
    want = np.asarray(jfn(variables, images))

    state = state_dict_from_flax(jax.tree_util.tree_map(np.asarray,
                                                        variables))
    model = AutoFocusFormer(**CFG)
    model.load_state_dict(state)
    fn = pexport.load_exported(pexport.export_forward(model, 2, 56, "cpu"))
    x = torch.from_numpy(images).permute(0, 3, 1, 2).contiguous()
    got = fn(state, x).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_load_in_a_fresh_process_needs_no_model_code(tmp_path):
    model = _aff(0)
    x = _images(56)
    with torch.no_grad():
        want = model(x)
    pexport.save_exported(str(tmp_path / "aff.pt2"),
                          pexport.export_forward(model, 2, 56, "cpu"))
    torch.save({"state": model.state_dict(), "x": x}, tmp_path / "in.pt")
    script = (
        "import sys, torch\n"
        "from ml_autofocusformermod_torch.ckpt.export import load_exported\n"
        f"d = torch.load({str(tmp_path / 'in.pt')!r})\n"
        f"fn = load_exported({str(tmp_path / 'aff.pt2')!r})\n"
        f"torch.save(fn(d['state'], d['x']), {str(tmp_path / 'out.pt')!r})\n"
        "bad = [m for m in sys.modules\n"
        "       if m.startswith('ml_autofocusformermod_torch.models')\n"
        "       or m.startswith('ml_autofocusformermod_tpu') or m == 'jax']\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert torch.equal(torch.load(tmp_path / "out.pt"), want)
