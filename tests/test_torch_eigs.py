"""The port's spectral estimators (solver/eigs.py) and Chebyshev smoother
(ops/smoothers.chebyshev_smooth, the cycles' three Chebyshev branches)
against the JAX package's, complex128 on the CPU.

test_eigs.py's operators: spectral_interval and power_extreme to 1e-10
(the same seeded numpy starts in both packages; only the k x k
tridiagonal eigenproblem runs on the host), jacobi_operator_lmax to
1e-12; chebyshev_smooth to 1e-12; a Chebyshev-smoothed solve at JAX's
cycle count on a hierarchy both packages share (JAX's, carried by
utils.convert); one Chebyshev NTL cycle and fmg_init to 1e-12.
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
from tpu_multigrid.ops import smoothers as jsm  # noqa: E402
from tpu_multigrid.ops.stencil import apply_D as japply_D  # noqa: E402
from tpu_multigrid.solver import eigs as jeigs  # noqa: E402
import tpu_multigrid_torch as mgt  # noqa: E402
from tpu_multigrid_torch.ops import dispatch  # noqa: E402
from tpu_multigrid_torch.ops import smoothers as tsm  # noqa: E402
from tpu_multigrid_torch.ops.stencil import apply_D as tapply_D  # noqa: E402
from tpu_multigrid_torch.solver import eigs as teigs  # noqa: E402
from tpu_multigrid_torch.utils.convert import (config_from_dict,  # noqa: E402
                                               hierarchy_from_numpy)

EIG_BAR = 1e-10


def _op(stencil, L, m, seed=0):
    """test_eigs._op's operator, assembled by JAX, and the port's copy."""
    cfg = mg.MGConfig(L=L, stencil=stencil, m=m, nlevels=1)
    U = mg.models.gauge.gauge_from_phases(
        phases(np.random.default_rng(seed), L, 0.3), cfg.cdtype)
    D = mg.models.operators.assemble(stencil, U, m)
    return D, t_of(D)


@pytest.mark.parametrize("stencil,k", [("laplace", 80), ("wilson", 80),
                                       ("wilson", 48)])
def test_spectral_interval_matches_jax(stencil, k):
    jD, tD = _op(stencil, 8, 0.1)
    got = teigs.spectral_interval(tD, stencil, k=k)
    want = jeigs.spectral_interval(jD, stencil, k=k)
    for g, w in zip(got, want):
        assert abs(g - w) < EIG_BAR * max(1.0, abs(w))
    # the Lanczos coefficients themselves, and the Hermitian form
    v0 = crandn(np.random.default_rng(2), (2 if stencil == "wilson" else 1,
                                            8, 8))
    ta, tb = teigs.lanczos_tridiag(teigs.hermitian_form(tD, stencil),
                                   t_of(v0), 12)
    ja, jb = jeigs.lanczos_tridiag(jeigs.hermitian_form(jD, stencil),
                                   jnp.asarray(v0), 12)
    assert rel_err(ta, ja) < EIG_BAR and rel_err(tb, jb) < EIG_BAR
    assert rel_err(teigs.hermitian_form(tD, stencil)(t_of(v0)),
                   jeigs.hermitian_form(jD, stencil)(jnp.asarray(v0))) \
        < C128_BAR


def test_power_extreme_matches_jax():
    """test_power_extreme_matches_dense's case."""
    jD, tD = _op("laplace", 8, 0.2)
    rng = np.random.default_rng(1)
    v0 = rng.normal(size=(1, 8, 8)) + 1j * rng.normal(size=(1, 8, 8))
    lam, v = teigs.power_extreme(lambda x: tapply_D(tD, x), t_of(v0),
                                 iters=300)
    jlam, jv = jeigs.power_extreme(lambda x: japply_D(jD, x),
                                   jnp.asarray(v0), iters=300)
    assert abs(float(lam) / float(jlam) - 1) < EIG_BAR
    assert rel_err(v, jv) < EIG_BAR


@pytest.mark.parametrize("stencil", ["laplace", "wilson"])
def test_jacobi_operator_lmax_matches_jax(stencil):
    jD, tD = _op(stencil, 8, 0.1)
    from tpu_multigrid.ops.stencil import site_inverse as jinv
    jDinv = jinv(jD[0])
    got = teigs.jacobi_operator_lmax(tD, t_of(jDinv), iters=40)
    want = jeigs.jacobi_operator_lmax(jD, jDinv, iters=40)
    assert isinstance(got, float)
    assert abs(got / want - 1) < C128_BAR


@pytest.mark.parametrize("batched", [False, True])
def test_chebyshev_smooth_matches_jax(batched):
    """One degree-5 polynomial on [0.4, 2.1], a batch of three fields
    through one call against jax.vmap; dispatch.smooth(kind='chebyshev')
    on CPU tensors is the same call, pallas 'auto' and 'off' alike, and
    needs its interval."""
    jD, tD = _op("wilson", 8, 0.1)
    from tpu_multigrid.ops.stencil import site_inverse as jinv
    jDinv = jinv(jD[0])
    rng = np.random.default_rng(4)
    shape = (3, 2, 8, 8) if batched else (2, 8, 8)
    phi, r = crandn(rng, shape), crandn(rng, shape)
    got = tsm.chebyshev_smooth(tD, t_of(jDinv), t_of(phi), t_of(r), 5,
                               0.4, 2.1)

    def one(p, q):
        return jsm.chebyshev_smooth(jD, jDinv, p, q, 5, 0.4, 2.1)

    want = (jax.vmap(one) if batched else one)(jnp.asarray(phi),
                                               jnp.asarray(r))
    assert rel_err(got, want) < C128_BAR
    for pallas in ("auto", "off"):
        assert torch.equal(dispatch.smooth(
            tD, t_of(jDinv), t_of(phi), t_of(r), 5, "chebyshev",
            pallas=pallas, cheby_interval=(0.4, 2.1)), got)
    with pytest.raises(ValueError, match="cheby_interval"):
        dispatch.smooth(tD, t_of(jDinv), t_of(phi), t_of(r), 5, "chebyshev")


def _shared(jcfg, U=None):
    D = mg.models.operators.assemble(
        jcfg.stencil, U if U is not None
        else mg.models.gauge.identity_gauge(jcfg.L, jcfg.cdtype), jcfg.m)
    jhier = mg.build_hierarchy(D, jcfg, check=False, U=U)
    thier = hierarchy_from_numpy(*jax_hierarchy_leaves(jhier))
    return jhier, thier, config_from_dict(dataclasses.asdict(jcfg))


def test_chebyshev_solve_matches_jax():
    """test_chebyshev_smoother_converges_faster_than_jacobi's problem at
    L=16: both packages' chebyshev_config on the shared hierarchy give
    the same intervals, and the Chebyshev-smoothed solves take the same
    cycles, no more than Jacobi's."""
    jcfg = mg.MGConfig(L=16, stencil="laplace", m=0.05, nlevels=2,
                       num_iters=4, null_iters=80, smoother="jacobi",
                       res_threshold=1e-10)
    U = mg.models.gauge.gauge_from_phases(
        phases(np.random.default_rng(3), 16, 0.3), jcfg.cdtype)
    jhier, thier, tcfg = _shared(jcfg, U)
    jcc = jeigs.chebyshev_config(jcfg, jhier)
    tcc = teigs.chebyshev_config(tcfg, thier)
    assert tcc.smoother == "chebyshev" and len(tcc.cheby_lmax) == 3
    np.testing.assert_allclose(tcc.cheby_lmax, jcc.cheby_lmax, rtol=1e-12)
    jb = mg.point_source(jcfg)
    jout = mg.solve(jhier, jb, jcc, max_iters=200)
    out = mgt.solve(thier, t_of(jb), tcc, max_iters=200)
    assert out.converged and jout.converged
    assert out.iters == jout.iters
    assert out.iters <= mgt.solve(thier, t_of(jb), tcfg,
                                  max_iters=200).iters
    assert rel_err(out.phi, jout.phi) < 1e-9


def test_chebyshev_ntl_cycle_and_fmg_match_jax():
    """Wilson NTL (4 copies, min-res), Chebyshev at every level and on the
    copies: one cycle from zero (phi and the NTL weights) and the
    full-multigrid start, to 1e-12."""
    jcfg = mg.MGConfig(L=16, stencil="wilson", m=0.1, nlevels=2, ntl=True,
                       num_iters=4, null_iters=40)
    U = mg.models.gauge.gauge_from_phases(
        phases(np.random.default_rng(6), 16), jcfg.cdtype)
    jhier, thier, tcfg = _shared(jcfg, U)
    lmax = (3.1, 2.2, 1.7)
    jcc = dataclasses.replace(jcfg, smoother="chebyshev", cheby_lmax=lmax)
    tcc = tcfg.replace(smoother="chebyshev", cheby_lmax=lmax)
    jb = mg.point_source(jcfg)
    jphis, ja = mg.cycle(jhier, mg.zero_fields(jcfg), jb, jcc)
    phis, a = mgt.cycle(thier, mgt.zero_fields(tcfg), t_of(jb), tcc)
    assert rel_err(phis[0], jphis[0]) < C128_BAR
    assert rel_err(a, ja) < C128_BAR
    from tpu_multigrid.solver.cycles import fmg_init as jfmg
    jf = jfmg(jhier, jb, jcc)
    tf = mgt.fmg_init(thier, t_of(jb), tcc)
    assert rel_err(tf[0], jf[0]) < C128_BAR


def test_chebyshev_needs_its_intervals():
    with pytest.raises(ValueError, match="chebyshev"):
        mgt.MGConfig(L=16, smoother="chebyshev", nlevels=2)
