"""``utils/flops.py`` of the port (the JAX package's ``PRINT_FLOPS``
report), on the CPU.

* ``count_params`` equals the size of the JAX param tree of the same
  tiny AFF, and AFF-Mini's rounds to the published 6.75 M;
* ``model_complexity`` on a tiny AFF equals a hand count of every product
  of its forward (convolutions, linears, the fused kernels' formulas, the
  dense attention of the global stages, the geometry's small products);
* ``main --opts PRINT_FLOPS True`` logs the GFLOPs line before the
  throughput.
"""

import math
import os

import jax
import numpy as np
import torch

from ml_autofocusformermod_torch import main as port_main
from ml_autofocusformermod_torch.config import load_config
from ml_autofocusformermod_torch.models.aff import AutoFocusFormer
from ml_autofocusformermod_torch.models.build import build_model
from ml_autofocusformermod_torch.utils.flops import (
    count_params, model_complexity,
)
from ml_autofocusformermod_tpu.models.aff import AutoFocusFormer as JaxAFF
from test_torch_entry import PORT_CFG, TINY_OPTS

torch.set_num_threads(1)
CFG = dict(num_classes=10, embed_dim=(16, 32, 48, 64), depths=(1, 1, 1, 1),
           num_heads=(2, 2, 4, 4), img_size=56)


def _hand_count():
    """Flops of one 56^2 image through the tiny AFF: tokens 196 -> 49 ->
    12 -> 3, clusters of 8, neighbourhood 48 (stages 1-2 local with 6
    clusters of 8, stages 3-4 global), two flops per multiply-add."""
    total = 2 * 28 * 28 * 8 * 3 * 9 + 2 * 14 * 14 * 16 * 8 * 9  # the convs
    dims, heads = CFG["embed_dim"], CFG["num_heads"]
    n = 196
    for i, (d, h) in enumerate(zip(dims, heads)):
        total += 2 * n * d * d * 8  # q, kv, proj, fc1, fc2 (mlp ratio 2)
        k = -(-n // 8)
        if n > 48:  # local: the attention op's formula
            m = min(6, k) * 8
            total += 2 * n * (5 * h * m + 2 * d * m + d)
            if i > 0:
                total += 2 * n * k * 2  # the kNN's cross term
        else:  # global: rel-pos bias, q.k and attn.v
            m = n
            total += 2 * n * n * 5 * h + 2 * 2 * n * n * d
        if i < 3:
            n_ = n // 4
            total += 2 * n * d  # prob_net
            if i > 0:
                total += 2 * n * n * 2  # the adaptive stride's distances
            total += (2 * n_ * m * 5 * 4  # weight_net
                      + 2 * n_ * m * 4 * d  # the merge contraction
                      + 2 * n_ * 4 * d * dims[i + 1])  # linear
            n = n_
    return total + 2 * dims[-1] * 10  # the head


def test_count_params_matches_the_jax_tree():
    jmodel = JaxAFF(**CFG)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jax.numpy.zeros((1, 56, 56, 3)))
    want = sum(int(np.prod(p.shape))
               for p in jax.tree_util.tree_leaves(shapes["params"]))
    model = AutoFocusFormer(**CFG)
    assert count_params(model) == want
    mini = build_model(load_config(os.path.join(PORT_CFG, "aff_mini.yaml")),
                       "cpu")
    assert round(count_params(mini) / 1e6, 2) == 6.75  # BASELINE.md


def test_model_complexity_matches_the_hand_count():
    model = AutoFocusFormer(**CFG).init_weights(
        torch.Generator().manual_seed(0))
    cost = model_complexity(model, 56)
    assert cost["flops"] == _hand_count() == 5244904
    assert math.isnan(cost["bytes_accessed"]) and math.isnan(
        cost["peak_bytes"])
    assert cost["params"] == count_params(model)
    # per image: a batch of 2 counts twice the work
    assert model_complexity(model, 56, batch=2)["flops"] == cost["flops"]


def test_main_prints_flops(tmp_path, capsys):
    result = port_main.main([
        "--cfg", os.path.join(PORT_CFG, "aff_mini.yaml"), "--throughput",
        "--device", "cpu", "--batch-size", "4",
        "--data-path", str(tmp_path / "no_dataset"),
        "--opts", *TINY_OPTS, "PRINT_FLOPS", "True"])
    printed = capsys.readouterr().out
    line = next(ln for ln in printed.splitlines()
                if ln.startswith("number of GFLOPs: "))
    assert line.endswith("(torch FlopCounterMode, fwd per image)")
    assert printed.index(line) < printed.index("throughput averaged")
    assert float(line.split()[3]) == round(
        result["complexity"]["flops"] / 1e9, 2) > 0
