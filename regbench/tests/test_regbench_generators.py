"""The generators draw the same inputs from the same seed, problem by
problem, and other inputs from another seed."""

import numpy as np
import pytest

from regbench.run import HERE, load_json, load_module

CONFIGS = sorted(p.stem for p in (HERE / "configs").glob("*.json"))

SEED = 2 ** 31 + 12345  # seeds may pass 32 bits


@pytest.mark.parametrize("config", CONFIGS)
def test_same_seed_same_problems(config):
    cfg = load_json("configs", config)
    problem = dict(cfg["problem"], n=min(cfg["problem"]["n"], 500))
    if "outlier_draws" in problem:
        problem["outlier_draws"] = 450
    gen = load_module("generators", cfg["generator"])
    a = gen.make(problem, SEED, range(4))
    b = gen.make(problem, SEED, range(4))
    c = gen.make(problem, SEED + 1, range(4))
    part = gen.make(problem, SEED, [2, 3])
    for x, y, z, p in zip(a, b, c, part):
        assert x.dtype == np.float32 and x.shape == (4, 3, problem["n"])
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x[2:], p)  # problem i depends on (seed, i) alone
        assert not np.array_equal(x, z)
    assert not np.array_equal(a[1][0], a[1][1])  # every problem draws its own inputs


def test_bunny_problems_follow_the_example():
    cfg = load_json("configs", "bunny1889")
    gen = load_module("generators", "bunny_box")
    src, dst = gen.make(cfg["problem"], SEED, range(2))
    t = gen.transform(cfg["problem"])
    np.testing.assert_allclose(t[:3, :3] @ t[:3, :3].T, np.eye(3), atol=1e-12)
    resid = dst - (t[:3, :3] @ src.astype(np.float64) + t[:3, 3:4])
    inlier = np.abs(resid).max(axis=1) <= cfg["problem"]["noise_bound"] / 2 + 1e-6
    share = 1 - inlier.mean()
    assert 0.55 < share < 0.63  # ~59% outliers from 1700 draws with replacement
    shift = np.round(resid[0][:, ~inlier[0]])  # one integer on all three axes
    assert np.all(shift[0] == shift[1]) and np.all(shift[0] == shift[2])
    assert np.all((shift >= 5) & (shift <= 20))  # a point drawn twice moves twice
