"""The port's ensemble workflow (solver/ensemble.py) against the JAX
package's, which vmaps setup and solve over a leading configuration axis:
complex128 on the CPU at test_ensemble's configuration (Wilson L=16,
m=0.2, 2 levels, NTL, 3 gauge configurations), with JAX's near-null starts
(its per-level, per-configuration jax.random.split chain) injected into
the port's setup.

Every level of the port's batched hierarchy matches JAX's to 1e-10, and
the 15-cycle solve_ensemble's phi and residuals to 1e-9; JAX's batched
hierarchy carried across by utils.convert solves to the same phi;
`mesh=` (sharding the batch over devices, ROADMAP A12) is refused.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from torch_port_helpers import jax_hierarchy_leaves, phases, rel_err, t_of  # noqa: E402

import tpu_multigrid as mg  # noqa: E402
from tpu_multigrid.ops.nearnull import random_starts as jax_random_starts  # noqa: E402
from tpu_multigrid.solver import ensemble as jens  # noqa: E402
import tpu_multigrid_torch as mgt  # noqa: E402
from tpu_multigrid_torch.utils.convert import (config_from_dict,  # noqa: E402
                                               hierarchy_from_numpy)

B = 3
HIER_BAR, SOLVE_BAR = 1e-10, 1e-9


def _jax_starts(cfg, batch):
    """The starts jens.build_hierarchies_batched draws: per level a split
    of the key, then one subkey per configuration."""
    key = jax.random.PRNGKey(cfg.seed)
    out = []
    for lvl in range(cfg.nlevels):
        key, sub = jax.random.split(key)
        k = cfg.n_dof[lvl + 1] // 2
        subs = jax.random.split(sub, batch)
        out.append(np.array(jax.vmap(lambda kk: jax_random_starts(
            kk, k, cfg.n_dof[lvl], cfg.sizes[lvl], cfg.cdtype))(subs)))
    return out


@pytest.fixture(scope="module")
def both():
    jcfg = mg.MGConfig(L=16, stencil="wilson", m=0.2, nlevels=2, ntl=True,
                       num_iters=6, null_iters=60, res_threshold=1e-8)
    rng = np.random.default_rng(0)
    ph = np.stack([phases(rng, 16) for _ in range(B)])
    jUs = jnp.stack([mg.models.gauge.gauge_from_phases(p, jcfg.cdtype)
                     for p in ph])
    jhier = jens.build_hierarchies_batched(jUs, jcfg)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    tUs = mgt.models.gauge.gauge_from_phases(t_of(ph), tcfg.cdtype)
    thier = mgt.build_hierarchies_batched(tUs, tcfg,
                                          starts=_jax_starts(jcfg, B))
    b = mg.point_source(jcfg)
    bs = np.asarray(jnp.stack([b, b * 2.0, b * (1 + 1j)]))
    return jcfg, tcfg, jhier, thier, bs


def test_batched_setup_matches_jax(both):
    jcfg, tcfg, jhier, thier, _ = both
    assert thier.gauge is None and thier.levels[0].D.shape[0] == B
    assert tuple(thier.ntl.D.shape[:2]) == (B, 4)
    for jl, tl in zip(jhier.levels, thier.levels):
        assert rel_err(tl.D, jl.D) < HIER_BAR
        assert rel_err(tl.D0inv, jl.D0inv) < HIER_BAR
        if jl.phi_null is not None:
            assert rel_err(tl.phi_null, jl.phi_null) < HIER_BAR
    for name in ("phi_null", "D", "D0inv"):
        assert rel_err(getattr(thier.ntl, name),
                       getattr(jhier.ntl, name)) < HIER_BAR


def test_solve_ensemble_matches_jax(both):
    jcfg, tcfg, jhier, thier, bs = both
    jphi, jres = jens.solve_ensemble(jhier, jnp.asarray(bs), jcfg,
                                     n_cycles=15)
    phi, res = mgt.solve_ensemble(thier, t_of(bs), tcfg, n_cycles=15)
    assert phi.shape == (B, 2, 16, 16) and res.shape == (B,)
    assert (res < 1e-7).all()
    assert rel_err(phi, jphi) < SOLVE_BAR
    # 15 cycles reach complex128 rounding: the residuals are rounding
    # alike (the 2-cycle residuals are compared below)
    np.testing.assert_allclose(res, jres, rtol=0, atol=1e-14)
    # configuration 1 alone: its own hierarchy, its own right-hand side
    h1 = mgt.solver.ensemble.unstack_hierarchy(thier, 1)
    assert h1.ntl.D.shape == thier.ntl.D.shape[1:]
    phis = mgt.zero_fields(tcfg)
    for _ in range(15):
        phis, _ = mgt.cycle(h1, phis, t_of(bs[1]), tcfg)
    assert rel_err(phi[1], phis[0]) < SOLVE_BAR


def test_converted_batched_hierarchy_round_trip(both):
    """JAX's batched hierarchy through utils.convert: the port's own
    setup's tensors, and the same 2-cycle solve and residuals as JAX's."""
    jcfg, tcfg, jhier, thier, bs = both
    conv = hierarchy_from_numpy(*jax_hierarchy_leaves(jhier))
    assert conv.gauge is None
    for cl, tl in zip(conv.levels, thier.levels):
        assert cl.D.shape == tl.D.shape and rel_err(cl.D, tl.D) < HIER_BAR
    assert conv.ntl.D.shape == thier.ntl.D.shape
    phi, res = mgt.solve_ensemble(conv, t_of(bs), tcfg, n_cycles=2)
    phi2, res2 = mgt.solve_ensemble(thier, t_of(bs), tcfg, n_cycles=2)
    assert rel_err(phi, phi2) < SOLVE_BAR
    jphi, jres = jens.solve_ensemble(jhier, jnp.asarray(bs), jcfg,
                                     n_cycles=2)
    assert rel_err(phi, jphi) < SOLVE_BAR
    assert (res > 1e-10).all()
    np.testing.assert_allclose(res, jres, rtol=SOLVE_BAR)


def test_sharding_is_refused(both):
    _, tcfg, _, thier, bs = both
    with pytest.raises(NotImplementedError, match="A12"):
        mgt.solve_ensemble(thier, t_of(bs), tcfg, n_cycles=1, mesh=object())
    with pytest.raises(NotImplementedError, match="A12"):
        mgt.solver.ensemble.shard_ensemble(thier, object())
