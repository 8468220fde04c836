"""The frozen FLOP and byte arithmetic against the port's (bench_lib) and
chip_smoke.py's bounds, at small sizes."""

import math
from types import SimpleNamespace

import pytest

from perfbench.lib import costs
from perfbench.reference import memexqa
from perfbench.tests.conftest import TINY

D = SimpleNamespace(**TINY["config"]["data"])
M = SimpleNamespace(**{"keep_prob": 0.9, "forget_bias": 1.0, **TINY["config"]["model"]})


def _cfg():
    from fvta_memexqa_torch.config import Config, DataConfig, ModelConfig

    return Config(data=DataConfig(**TINY["config"]["data"]),
                  model=ModelConfig(**TINY["config"]["model"]))


@pytest.mark.parametrize("train", [False, True])
def test_step_cost_equals_bench_lib(train):
    from fvta_memexqa_torch import bench_lib

    params = sum(math.prod(s) for _, s, _ in memexqa.param_spec(D, M))
    ours = costs.step_cost(D, M, 6, params, train=train)
    port = bench_lib.step_cost(_cfg(), 6, train=train)
    for k in ("flops", "bytes", "product_flops"):
        assert ours[k] == pytest.approx(port[k], rel=1e-12), k


def test_kernel_bounds_equal_chip_smoke():
    import chip_smoke

    n, t, d, h = 24, 10, 200, 100
    bounds = chip_smoke.k1_bounds(n, t, d, h, n * t, True)
    for key, (flops, nbytes) in (("proj", costs.k1_proj(n, t, d, h)),
                                 ("rec", costs.k1_rec(n, t, h, True, False))):
        b_ms, o_ms = bounds[key]
        assert nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3 == pytest.approx(b_ms, rel=1e-12)
        assert flops / chip_smoke.FP32_FLOPS * 1e3 == pytest.approx(o_ms, rel=1e-12)
    # under grad the recurrence also writes the cells and the pre-activations
    assert costs.k1_rec(n, t, h, True, True)[1] == pytest.approx(
        costs.k1_rec(n, t, h, True, False)[1] + 4 * n * t * 10 * h)


def test_eval_calls_and_least_time():
    calls = costs.eval_lstm_calls(D, M, 32, 11, 4, 8)
    assert len(calls) == 3 * 7 + 4 * 2
    assert [c[0] for c in calls[14:21]] == [3 * D.max_photos] + [3] * 6   # the last block
    least, bound = costs.least_seconds([(67.0, 0.0), (0.0, 6.7)], 67.0, 3.35)
    assert least == pytest.approx(3.0) and bound == "bytes"
    # the tables once, the encode per album row, the answers per question
    f = lambda q, r: costs.eval_cost(D, M, q, r, 21)["flops"]
    assert f(64, 11) - f(32, 11) == pytest.approx(f(32, 11) - f(0, 11))
    assert f(32, 22) - f(32, 11) == pytest.approx(f(32, 11) - f(32, 0))
    assert f(0, 0) == pytest.approx(sum(costs._layer(**x)["flops"] for x in (
        {"flops": costs._char_cnn(D.word_vocab_size, D, M)["flops"]},
        {"flops": costs._highway(D.word_vocab_size, costs.demb(D, M))["flops"]},
        {"flops": costs._dense(21, D.image_feat_dim, costs.demb(D, M))["flops"]})))
