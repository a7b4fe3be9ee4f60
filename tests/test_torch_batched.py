"""The port's batched multi-RHS solve (solver.driver.solve_batched) and the
batch axis of its pieces against the JAX package, which vmaps them.

complex128 on the CPU: JAX's test_batched configuration (laplace L=16, 3
right-hand sides, 12 cycles) and a Wilson NTL case with the links on the
hierarchy, each through both packages' solve_batched on the same
hierarchy (JAX's, carried by utils.convert), to 1e-12; the batched plain
links smoother and residual (the plain versions of the batched links
kernels) equal to a loop of unbatched calls bit for bit; the batched
restrict / prolong against JAX's vmap.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_port_helpers import (C128_BAR, crandn, jax_hierarchy_leaves,  # noqa: E402
                                phases, rel_err, t_of)

import tpu_multigrid as mg  # noqa: E402
from tpu_multigrid.ops import transfer as jtr  # noqa: E402
from tpu_multigrid.solver.driver import solve_batched as jax_solve_batched  # noqa: E402
import tpu_multigrid_torch as mgt  # noqa: E402
from tpu_multigrid_torch.ops import dispatch  # noqa: E402
from tpu_multigrid_torch.ops import gauge_stencil as tgs  # noqa: E402
from tpu_multigrid_torch.ops import transfer as ttr  # noqa: E402
from tpu_multigrid_torch.utils.convert import (config_from_dict,  # noqa: E402
                                               hierarchy_from_numpy)


def _both(jcfg, U=None):
    D = mg.models.operators.assemble(
        jcfg.stencil, U if U is not None
        else mg.models.gauge.identity_gauge(jcfg.L, jcfg.cdtype), jcfg.m)
    jhier = mg.build_hierarchy(D, jcfg, check=False, U=U)
    thier = hierarchy_from_numpy(*jax_hierarchy_leaves(jhier))
    return jhier, thier, config_from_dict(dataclasses.asdict(jcfg))


def test_solve_batched_laplace_matches_jax():
    """tests/test_batched.py's configuration through both packages."""
    jcfg = mg.MGConfig(L=16, stencil="laplace", m=0.2, nlevels=2,
                       num_iters=6, null_iters=60, res_threshold=1e-10)
    jhier, thier, tcfg = _both(jcfg)
    bs = np.random.default_rng(0).normal(size=(3, 1, 16, 16)) + 0j
    jphi, jres = jax_solve_batched(jhier, jnp.asarray(bs), jcfg, n_cycles=12)
    phi, res = mgt.solve_batched(thier, t_of(bs), tcfg, n_cycles=12)
    assert phi.shape == (3, 1, 16, 16) and res.shape == (3,)
    assert rel_err(phi, jphi) < C128_BAR
    assert (res < 1e-8).all()
    np.testing.assert_allclose(res, jres, rtol=1e-5)
    # each right-hand side equals its own unbatched solve
    one = mgt.solve(thier, t_of(bs[1]), tcfg.replace(res_threshold=0.0),
                    max_iters=12)
    assert one.iters == 12 and rel_err(phi[1], one.phi) < C128_BAR


def test_solve_batched_wilson_ntl_links_matches_jax():
    """Wilson NTL (4 copies, min-res) with the links on the hierarchy
    (links='on'): the batched level-0 links smoother and residual, the
    copies of the batch smoothed as one batch, min-res per right-hand
    side."""
    jcfg = mg.MGConfig(L=16, stencil="wilson", m=0.1, nlevels=2, ntl=True,
                       num_iters=4, null_iters=40, links="on",
                       res_threshold=1e-10)
    rng = np.random.default_rng(5)
    U = mg.models.gauge.gauge_from_phases(phases(rng, 16), jcfg.cdtype)
    jhier, thier, tcfg = _both(jcfg, U)
    assert thier.gauge is not None
    bs = crandn(rng, (3, 2, 16, 16))
    jphi, jres = jax_solve_batched(jhier, jnp.asarray(bs), jcfg, n_cycles=8)
    phi, res = mgt.solve_batched(thier, t_of(bs), tcfg, n_cycles=8)
    assert rel_err(phi, jphi) < C128_BAR
    np.testing.assert_allclose(res, jres, rtol=1e-6)
    phis = mgt.zero_fields(tcfg)
    for _ in range(8):
        phis, _ = mgt.cycle(thier, phis, t_of(bs[2]), tcfg)
    assert rel_err(phi[2], phis[0]) < C128_BAR


@pytest.mark.parametrize("kind", ["rbgs", "jacobi"])
@pytest.mark.parametrize("shared_r", [False, True])
def test_batched_plain_links_equal_a_loop(kind, shared_r):
    """gauge_stencil.smooth_u / residual_u on [3, 2, L, L] with the links
    shared: the unbatched calls' results bit for bit (the plain versions
    of the batched links kernels), also through the dispatchers on the
    CPU."""
    rng = np.random.default_rng(11)
    L, m = 8, -0.005
    U = t_of(np.exp(1j * phases(rng, L)))
    phi = t_of(crandn(rng, (3, 2, L, L)))
    r = t_of(crandn(rng, (2, L, L) if shared_r else (3, 2, L, L)))

    def r_of(i):
        return r if shared_r else r[i]

    got = tgs.smooth_u("wilson", U, m, phi, r, 3, kind, 0.8)
    res = tgs.residual_u("wilson", U, m, phi, r)
    for i in range(3):
        assert torch.equal(got[i], tgs.smooth_u("wilson", U, m, phi[i],
                                                r_of(i), 3, kind, 0.8))
        assert torch.equal(res[i], tgs.residual_u("wilson", U, m, phi[i],
                                                  r_of(i)))
    assert torch.equal(dispatch.links_smooth(U, m, phi, r, 3, kind, 0.8),
                       got)
    assert torch.equal(dispatch.links_residual(U, m, phi, r), res)


@pytest.mark.parametrize("quad", [1, 2, 3, 4])
@pytest.mark.parametrize("shared", [True, False])
def test_batched_transfers_match_jax_vmap(quad, shared):
    """restrict / prolong / block_dot on a batch of fields, with phi_null
    shared (one hierarchy) or batched (an ensemble), against jax.vmap of
    the JAX package's functions."""
    rng = np.random.default_rng(20 + quad)
    B, nc, nf, L = 3, 4, 2, 8
    pn = crandn(rng, (nc, nf, L, L) if shared else (B, nc, nf, L, L))
    vf, vc = crandn(rng, (B, nf, L, L)), crandn(rng, (B, nc, L // 2, L // 2))
    axis = None if shared else 0
    jr = jax.vmap(lambda p, v: jtr.restrict(p, v, quad, 2, 2),
                  in_axes=(axis, 0))(pn, vf)
    jp = jax.vmap(lambda p, v: jtr.prolong(p, v, quad, 2, 2),
                  in_axes=(axis, 0))(pn, vc)
    jd = jax.vmap(lambda u, v: jtr.block_dot(u, v, quad, 2, 2))(vf, 2 * vf)
    assert rel_err(dispatch.restrict(t_of(pn), t_of(vf), quad, 2, 2),
                   jr) < C128_BAR
    assert rel_err(dispatch.prolong(t_of(pn), t_of(vc), quad, 2, 2),
                   jp) < C128_BAR
    assert rel_err(ttr.block_dot(t_of(vf), t_of(2 * vf), quad, 2, 2),
                   jd) < C128_BAR
