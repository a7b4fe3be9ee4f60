"""The port's 1D solvers (solver/one_d.py) against the JAX package's,
float64 on the CPU: each function to 1e-12, solve_1d's count and
residual."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from torch_port_helpers import C128_BAR, rel_err, t_of  # noqa: E402

from tpu_multigrid.solver import one_d as j1  # noqa: E402
from tpu_multigrid_torch.solver import one_d as t1  # noqa: E402


@pytest.mark.parametrize("smoother", ["jacobi", "rbgs", "gs_lex"])
def test_pieces_match_jax(smoother):
    jcfg = j1.Geo1DConfig(L=64, m=0.3, nlevels=3, num_iters=5,
                          smoother=smoother)
    tcfg = t1.Geo1DConfig(L=64, m=0.3, nlevels=3, num_iters=5,
                          smoother=smoother)
    rng = np.random.default_rng(len(smoother))
    phi, r = rng.normal(size=64), rng.normal(size=64)
    for lvl in (0, 1):
        assert rel_err(t1.residual_1d(t_of(phi), t_of(r), lvl, tcfg),
                       j1.residual_1d(jnp.asarray(phi), jnp.asarray(r), lvl,
                                      jcfg)) < C128_BAR
        assert rel_err(t1.smooth_1d(t_of(phi), t_of(r), lvl, 5, tcfg),
                       j1.smooth_1d(jnp.asarray(phi), jnp.asarray(r), lvl, 5,
                                    jcfg)) < C128_BAR
    assert rel_err(t1.restrict_1d(t_of(r)),
                   j1.restrict_1d(jnp.asarray(r))) < C128_BAR
    assert rel_err(t1.prolong_1d(t_of(r)),
                   j1.prolong_1d(jnp.asarray(r))) < C128_BAR
    phis = [rng.normal(size=s) for s in jcfg.sizes]
    got = t1.vcycle_1d(tuple(map(t_of, phis)), t_of(r), tcfg)
    want = j1.vcycle_1d(tuple(map(jnp.asarray, phis)), jnp.asarray(r), jcfg)
    assert rel_err(got[0], want[0]) < C128_BAR


def test_solve_1d_matches_jax():
    kw = dict(L=128, m=0.5, nlevels=4, num_iters=20, res_threshold=1e-13)
    b = np.zeros(128)
    b[0], b[5] = 1.0, 2.5
    jphi, jit, jres = j1.solve_1d(jnp.asarray(b), j1.Geo1DConfig(**kw),
                                  max_iters=500)
    phi, it, res = t1.solve_1d(t_of(b), t1.Geo1DConfig(**kw), max_iters=500)
    assert it == jit and res < 1e-13
    assert rel_err(phi, jphi) < C128_BAR


def test_jacobi_and_gauss_seidel_1d_match_jax():
    L, m = 64, 0.05
    b = np.zeros(L)
    b[L // 2] = 1.0
    assert rel_err(t1.jacobi_1d(t_of(b), m, 200, L),
                   j1.jacobi_1d(jnp.asarray(b), m, 200, L)) < C128_BAR
    assert rel_err(t1.gauss_seidel_1d(t_of(b), m, 200, L),
                   j1.gauss_seidel_1d(jnp.asarray(b), m, 200, L)) < C128_BAR
