"""The port's self-test suite (tpu_multigrid_torch.testing) against the
JAX package's: tests 1-4 give JAX's violations to 1e-12 on the same
inputs (on a JAX-built hierarchy carried over by
utils.convert.hierarchy_from_numpy, and on operators that break each
identity, so the violations compared are O(1)); run_mg_tests gives JAX's
check names, every value below EPSILON; the gauge-invariance solve holds
to 1e-8."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_port_helpers import (C128_BAR, crandn, jax_hierarchy_leaves,  # noqa: E402
                                phases, t_of)

import tpu_multigrid as mg  # noqa: E402
from tpu_multigrid import testing as jtesting  # noqa: E402
import tpu_multigrid_torch as mgt  # noqa: E402
from tpu_multigrid_torch import testing as ttesting  # noqa: E402
from tpu_multigrid_torch.utils.convert import (config_from_dict,  # noqa: E402
                                               hierarchy_from_numpy)


@pytest.fixture(scope="module")
def carried():
    """A Wilson NTL hierarchy built by JAX (L=16, 2 levels, c128), and the
    port's copy of it."""
    jcfg = mg.MGConfig(L=16, stencil="wilson", m=0.1, nlevels=2, ntl=True,
                       num_iters=4, null_iters=40)
    rng = np.random.default_rng(21)
    U = mg.models.gauge.gauge_from_phases(phases(rng, 16, 0.3))
    jh = mg.build_hierarchy(mg.models.operators.assemble("wilson", U, 0.1),
                            jcfg)
    th = hierarchy_from_numpy(*jax_hierarchy_leaves(jh))
    return jcfg, config_from_dict(dataclasses.asdict(jcfg)), jh, th


def _close(got, want):
    got, want = float(got), float(want)
    assert abs(got - want) <= C128_BAR * max(1.0, abs(want)), (got, want)


@pytest.mark.parametrize("broken", [False, True])
def test_self_tests_match_jax(carried, broken):
    """test1-test4 at level 1 of the carried hierarchy; `broken` replaces
    the near-nulls and the coarse operator by random ones, so every
    identity fails by O(1) and the two packages' violations are held to
    each other, not to 0."""
    jcfg, _, jh, th = carried
    rng = np.random.default_rng(22)
    pn, Dc = np.asarray(jh.levels[0].phi_null), np.asarray(jh.levels[1].D)
    if broken:
        pn, Dc = crandn(rng, pn.shape), crandn(rng, Dc.shape)
    Df = np.asarray(jh.levels[0].D)
    vec = crandn(rng, (4, 8, 8))
    for j, t in ((jtesting.test1_restriction_prolongation(
                      jnp.asarray(pn), jnp.asarray(vec), 1, 2, 2),
                  ttesting.test1_restriction_prolongation(
                      t_of(pn), t_of(vec), 1, 2, 2)),
                 (jtesting.test2_galerkin(jnp.asarray(Dc), jnp.asarray(Df),
                                          jnp.asarray(pn), jnp.asarray(vec),
                                          1, 2, 2),
                  ttesting.test2_galerkin(t_of(Dc), t_of(Df), t_of(pn),
                                          t_of(vec), 1, 2, 2))):
        _close(t, j)
    for stencil in ("wilson", "laplace"):
        _close(ttesting.test3_hermiticity(t_of(Dc), stencil),
               jtesting.test3_hermiticity(jnp.asarray(Dc), stencil))
        _close(ttesting.test4_hermiticity_full(t_of(Dc), t_of(vec), stencil),
               jtesting.test4_hermiticity_full(jnp.asarray(Dc),
                                               jnp.asarray(vec), stencil))
    if broken:
        assert float(ttesting.test1_restriction_prolongation(
            t_of(pn), t_of(vec), 1, 2, 2)) > 1e-2


@pytest.mark.parametrize("ntl", [True, False])
def test_run_mg_tests_keys_and_bar(carried, ntl):
    jcfg, tcfg, jh, th = carried
    jcfg, tcfg = jcfg.replace(ntl=ntl), tcfg.replace(ntl=ntl)
    want = jtesting.run_mg_tests(jh, jcfg)
    got = ttesting.run_mg_tests(th, tcfg)
    assert list(got) == list(want)
    assert len(got) == (2 + 4 + 4 * 4 if ntl else 2 + 4 + 4)
    assert max(got.values()) < ttesting.EPSILON
    assert ttesting.epsilon_for(tcfg) == jtesting.epsilon_for(jcfg)
    assert ttesting.epsilon_for(tcfg.replace(dtype="complex64")) == 1e-4
    # the port's own hierarchy, built by the port, passes too
    U = mgt.models.gauge.gauge_from_phases(
        phases(np.random.default_rng(21), 16, 0.3))
    own = mgt.build_hierarchy(mgt.models.operators.assemble("wilson", U, 0.1),
                              tcfg)
    assert max(ttesting.run_mg_tests(own, tcfg).values()) < ttesting.EPSILON


def test_gauge_invariance_solve():
    """JAX's test_analysis.py:53-61 case, in the port: < 1e-8."""
    rng = np.random.default_rng(4302529)
    cfg = mgt.MGConfig(L=16, stencil="wilson", m=0.1, nlevels=2, num_iters=8,
                       null_iters=60, res_threshold=1e-10, smoother="rbgs")
    U = mgt.models.gauge.gauge_from_phases(0.3 * rng.normal(size=(2, 16, 16)),
                                           cfg.cdtype)
    omega = torch.from_numpy(np.exp(1j * rng.uniform(-np.pi, np.pi,
                                                     (16, 16))))
    viol = ttesting.test_gauge_invariance_solve(cfg, U, omega)
    assert viol < 1e-8, viol
