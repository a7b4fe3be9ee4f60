"""The traffic is the same for one seed and different for another."""
import torch

from h100_bench import harness
from h100_bench.traffic import rhs_stream

from .helpers import SEED, small


def ctx(cell, seed):
    c = harness.cell(cell)
    ov = small(cell)
    config = {**c.config, "mgconfig": {**c.config["mgconfig"],
                                       **ov.pop("mgconfig")}}
    return harness.Context(config, {**c.traffic, **ov}, seed, "cpu")


def test_sources_follow_the_seed():
    a, b, c = (rhs_stream.sources(ctx("flagship_rhs", s), 64)
               for s in (SEED, SEED, SEED + 1))
    assert a == b and a != c
    assert [s[2] for s in a[:4]] == [0, 1, 0, 1]
    assert a[0][:2] == a[1][:2]


def test_gauge_pools_follow_the_seed():
    for cell in ("flagship_configs", "ensemble8_stream", "large_rhs"):
        p1, p2, p3 = (ctx(cell, s).phases(3, "gauge")
                      for s in (SEED, SEED, 12))
        assert torch.equal(p1, p2) and not torch.equal(p1, p3)
        assert p1.shape == (3, 2, 16, 16) and p1.dtype == torch.float64


def test_streams_differ_and_large_seeds_work():
    c = ctx("flagship_rhs", 2 ** 63 + 5)
    assert c.seed_of("gauge") != c.seed_of("sources")
    assert 0 <= c.seed_of("gauge") < 2 ** 63
    assert ctx("flagship_rhs", -3).seed_of("x") >= 0


def test_reservoir_is_uniform_and_seeded():
    import numpy as np
    counts = np.zeros(20)
    for rep in range(2000):
        r = harness.Reservoir(4, np.random.default_rng(rep))
        for i in range(20):
            r.offer(i)
        for i in r.items:
            counts[i] += 1
    assert counts.min() > 0.7 * counts.mean()
    r1, r2 = (harness.Reservoir(3, np.random.default_rng(1)) for _ in "ab")
    for i in range(50):
        r1.offer(i)
        r2.offer(i)
    assert r1.items == r2.items


def test_sources_are_the_instance_in_another_order():
    a, c = (rhs_stream.sources(ctx("flagship_rhs", s), 64)
            for s in (SEED, SEED + 1))
    assert sorted(a) == sorted(c) and a != c


def test_every_seed_solves_the_instance_in_another_gauge():
    """Two seeds' links are the instance's under two gauge
    transformations: g D g^-1 for the reference operator, and the level-0
    near-null starts turned by the same g, the coarser ones the same."""
    from h100_bench.reference import wilson
    c = ctx("flagship_rhs", SEED)
    base = c.phases(1, "gauge", seed=c.params["instance"])[0]
    assert not torch.equal(base, c.phases(1, "gauge")[0])
    L = c.cfg.L
    thetas = [6.283 * torch.rand((L, L), dtype=torch.float64,
                                 generator=torch.Generator().manual_seed(s))
              for s in (1, 2)]
    x = torch.randn((2, L, L), dtype=torch.complex128,
                    generator=torch.Generator().manual_seed(3))
    D_x = wilson.apply(wilson.links(base), c.cfg.m, x)
    starts = []
    for th in thetas:
        g = torch.polar(torch.ones_like(th), th)
        U = wilson.links(rhs_stream.gauge_transform(base, th))
        assert torch.allclose(wilson.apply(U, c.cfg.m, g * x), g * D_x,
                              atol=1e-13)
        st = rhs_stream.near_null_starts(c, th)
        assert [tuple(s.shape) for s in st] == [(2, 2, 16, 16), (2, 4, 8, 8)]
        starts.append((g, st))
    (g1, s1), (g2, s2) = starts
    assert torch.allclose(s1[0] / g1, s2[0] / g2, atol=1e-13)
    assert torch.equal(s1[1], s2[1])
    assert s1[0].abs().max() <= 3.1416
