"""The seeded inputs: deterministic, equal to the port's generators they were
copied from, the same sizes for every seed."""

from types import SimpleNamespace

import numpy as np
import pytest

from perfbench.lib import gen
from perfbench.tests.conftest import TINY

D = SimpleNamespace(**TINY["config"]["data"])


def _cfg():
    from fvta_memexqa_torch.config import Config, DataConfig

    return Config(data=DataConfig(**TINY["config"]["data"]))


def test_shared_and_batches_equal_bench_lib():
    from fvta_memexqa_torch import bench_lib

    shared = gen.synth_shared(D, 10, 20, seed=5)
    port = bench_lib.synth_shared(_cfg(), num_albums=10, num_photos=20, seed=5, device="cpu")
    for k, v in shared.items():
        np.testing.assert_array_equal(v, getattr(port, k).numpy(), err_msg=k)
    batch = gen.synth_batch(D, 7, 10, seed=6)
    port = bench_lib.synth_batch(_cfg(), 7, num_albums=10, seed=6, device="cpu")
    for k, v in batch.items():
        np.testing.assert_array_equal(v, getattr(port, k).numpy(), err_msg=k)


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3])
def test_seeded_and_same_sizes(seed):
    a, b = gen.synth_batch(D, 9, 10, seed), gen.synth_batch(D, 9, 10, seed)
    other = gen.synth_batch(D, 9, 10, seed + 1)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert a[k].shape == other[k].shape and a[k].dtype == other[k].dtype
    assert not np.array_equal(a["q_words"], other["q_words"])
    s1, s2 = gen.seed_for(seed, 1), gen.seed_for(seed, 2)
    assert s1 == gen.seed_for(seed, 1) and s1 != s2 and 0 <= s1 < 2**63


def test_split_order_is_the_loaders():
    from fvta_memexqa_torch.data.pipeline import Dataset

    arrays = gen.synth_batch(D, 24, 10, seed=3)
    ds = Dataset(SimpleNamespace(splits={"train": arrays}), "train")
    seed = gen.seed_for(2**33, 4)
    for epoch in (0, 1):
        order = gen.split_order(24, seed, epoch)
        got = [b.q_words for b in ds.get_batches(8, shuffle=True, seed=seed, epoch=epoch)]
        for i, q in enumerate(got):
            np.testing.assert_array_equal(q.numpy(), arrays["q_words"][order[i * 8:(i + 1) * 8]])
