"""The yardstick's frozen arithmetic: each kernel's least time at the main
path's shapes (the kernel table's "Bound ms"), the sizes the configurations
state, and the model FLOP formulas against the port's own counter
(``launch/cost.CostCounter``) at small sizes on the CPU."""
from __future__ import annotations

import json
import math

import pytest
import torch
from conftest import BENCH

from harness import datagen, roofline

D_CNN = 206_922          # the paper's F-MNIST CNN (the kernel table's row)
N_GRANITE_2L = 838_881_280


def _ms(cost, peak=roofline.F32_FLOPS_PER_S):
    return 1e3 * roofline.bound_s(*cost, peak)


@pytest.mark.parametrize("cost, want_ms", [
    (roofline.gram_cost(10, D_CNN, 4), 0.0052),
    (roofline.gram_cost(10, N_GRANITE_2L, 2), 11.02),
])
def test_kernel_bounds_match_the_table(cost, want_ms):
    assert _ms(cost) == pytest.approx(want_ms, rel=5e-3)
    assert cost[0] / roofline.HBM_BYTES_PER_S > cost[1] / roofline.F32_FLOPS_PER_S


def _config(name):
    return json.loads((BENCH / "configs" / name).read_text())


def test_config_sizes():
    g = _config("granite-8b-2L.json")
    assert sum(math.prod(s) for _, s, _ in datagen.lm_param_shapes(g)) == N_GRANITE_2L


def _counted(fn) -> float:
    from repro_torch.launch.cost import CostCounter

    with CostCounter() as c:
        fn()
    return c.summary()["flops_local"]


def test_train_step_flops_against_the_counter():
    """The port's loss and gradient on a smoke decoder: the counter sees
    6 N a token for the matmul weights plus the attention's products, which
    the plain chunked path computes over the whole square (twice the
    causal count the formula takes)."""
    from repro_torch.configs.base import get
    from repro_torch.models import model as zoo

    cfg = dict(_config("granite-8b-2L.json"), hidden_size=64, num_attention_heads=4,
               num_key_value_heads=2, head_dim=16, intermediate_size=128,
               vocab_size=256)
    arch = get("granite-8b").replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=256, dtype="float32", remat=False)
    params = datagen.lm_params(cfg, 5, "cpu", torch.float32)
    B, S = 2, 64
    tokens = torch.randint(0, 256, (B, S), dtype=torch.int32)

    def step():
        leaves = [t.requires_grad_() for t in _leaves(params)]
        loss, _ = zoo.loss_fn(params, arch, {"tokens": tokens})
        torch.autograd.grad(loss, leaves)

    counted = _counted(step)
    h, hd = cfg["num_attention_heads"], cfg["head_dim"]
    causal = 3.0 * 2.0 * S * S * h * hd * B * cfg["num_hidden_layers"]
    want = roofline.train_step_flops(cfg, B, S) + causal
    assert counted == pytest.approx(want, rel=0.03)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]
