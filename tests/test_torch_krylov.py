"""The port's Krylov and minimal-residual solvers against the JAX package's
on the same numpy-made inputs, in complex128 at L <= 16: mr_solve,
eo_mr_solve and cgnr_solve (the same iteration count, x within 1e-9
relative), cgnr_solve_ir with complex64 inner solves (the same outer steps
and inner iterations) and fgmres_solve on a JAX-built hierarchy carried
across with utils/convert (the same iteration count, the residual within
1e-9). On CPU tensors every operator application is the plain
stencil.apply_D."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_port_helpers import (crandn, jax_hierarchy_leaves, np_of,  # noqa: E402
                                phases, rel_err, t_of)

import tpu_multigrid as mg  # noqa: E402
from tpu_multigrid.models import gauge as jgauge  # noqa: E402
from tpu_multigrid.models import operators as jops  # noqa: E402
from tpu_multigrid.ops import stencil as jst  # noqa: E402
from tpu_multigrid.solver import krylov as jkr  # noqa: E402
import tpu_multigrid_torch as mgt  # noqa: E402
from tpu_multigrid_torch.models import gauge as tgauge  # noqa: E402
from tpu_multigrid_torch.ops import stencil as tst  # noqa: E402
from tpu_multigrid_torch.utils import convert  # noqa: E402

X_BAR = 1e-9


def _system(stencil, L, m, seed):
    """D (JAX, torch) from Gaussian phases and b = D x for a random x."""
    rng = np.random.default_rng(seed)
    ph = phases(rng, L, 0.3)
    D = np.asarray(jops.assemble(stencil, jgauge.gauge_from_phases(ph), m))
    n = D.shape[1]
    b = np.asarray(jst.apply_D(jnp.asarray(D), jnp.asarray(
        crandn(rng, (n, L, L)))))
    return D, b


def _indefinite(L, sweeps=60, dtype=np.complex128):
    """Wilson m=-0.07 on a beta=32 heat-bath ensemble (NumPy chain, so both
    packages see the same phases) and the point source 5 at (0, 2, 2)."""
    th = tgauge.heatbath_ensemble(L, 32.0, sweeps, 7, prefer_native=False)
    D = np.asarray(jops.assemble("wilson", jgauge.gauge_from_phases(th),
                                 -0.07))
    b = np.zeros((2, L, L), np.complex128)
    b[0, 2, 2] = 5.0
    return D.astype(dtype), b


@pytest.mark.parametrize("stencil,m", [("laplace", 0.05), ("wilson", 0.05)])
def test_mr_and_eo_mr_match_jax(stencil, m):
    D, b = _system(stencil, 16, m, 60)
    for jfn, tfn in ((mg.mr_solve, mgt.mr_solve),
                     (mg.eo_mr_solve, mgt.eo_mr_solve)):
        xj, itj, relj = jfn(jnp.asarray(D), jnp.asarray(b), tol=1e-8,
                            max_iters=20000, chunk=50)
        xt, itt, relt = tfn(t_of(D), t_of(b), tol=1e-8, max_iters=20000,
                            chunk=50)
        assert isinstance(xt, torch.Tensor) and xt.dtype == torch.complex128
        assert itt == itj, (tfn.__name__, itt, itj)
        assert relt < 1e-8
        # x agrees to ~1e-15: the residuals to rounding of |b|
        assert abs(relt - relj) < 1e-13
        assert rel_err(xt, xj) < X_BAR


def test_cgnr_matches_jax_on_indefinite_wilson():
    D, b = _indefinite(12)
    xj, itj, relj = jkr.cgnr_solve(jnp.asarray(D), jnp.asarray(b), tol=1e-10,
                                   max_iters=20000, chunk=100)
    xt, itt, relt = mgt.cgnr_solve(t_of(D), t_of(b), tol=1e-10,
                                   max_iters=20000, chunk=100)
    assert itt == itj and relt < 1e-10
    assert rel_err(xt, xj) < X_BAR
    true = tst.residual(t_of(D), xt, t_of(b)).norm() / t_of(b).norm()
    assert float(true) < 1e-9


def test_cgnr_ir_matches_jax():
    """complex64 inner CGNR, complex128 outer residual (JAX: float64
    planes): the same outer steps and inner iterations, both below tol."""
    D128, b = _indefinite(12)
    D64 = D128.astype(np.complex64)
    kw = dict(tol=1e-10, inner_tol=1e-4, inner_max=4000, max_outer=8,
              chunk=200)
    want = jkr.cgnr_solve_ir(jnp.asarray(D64), D128, b, **kw)
    got = mgt.cgnr_solve_ir(t_of(D64), D128, b, **kw)
    assert (got["outer"], got["inner_iters"]) == (want["outer"],
                                                  want["inner_iters"])
    assert got["rel"] < 1e-10 and want["rel"] < 1e-10
    re, im = got["phi_planes"]
    assert re.dtype == torch.float64 and re.shape == (2, 12, 12)
    x = torch.complex(re, im)
    true = tst.residual(t_of(D128), x, t_of(b)).norm() / t_of(b).norm()
    assert abs(float(true) - got["rel"]) < 1e-3 * got["rel"]


def _fgmres_case(stencil, L, m, theta, **cfg_kw):
    cfg = mg.MGConfig(L=L, stencil=stencil, m=m, nlevels=2, **cfg_kw)
    U = jgauge.gauge_from_phases(theta, cfg.cdtype)
    D = jops.assemble(stencil, U, cfg.m)
    hier = mg.build_hierarchy(D, cfg, check=False)
    levels, ntl, gauge = jax_hierarchy_leaves(hier)
    th = convert.hierarchy_from_numpy(levels, ntl, gauge)
    tcfg = convert.config_from_dict(dataclasses.asdict(cfg))
    return cfg, hier, tcfg, th


@pytest.mark.parametrize("case", ["laplace easy", "wilson near-critical"])
def test_fgmres_matches_jax(case):
    if case == "laplace easy":
        cfg, hier, tcfg, th = _fgmres_case(
            "laplace", 16, 0.2, np.zeros((2, 16, 16)), num_iters=6,
            null_iters=60, res_threshold=1e-9)
        kw = dict(tol=1e-9)
    else:
        theta = tgauge.heatbath_ensemble(16, 32.0, 60, 7,
                                         prefer_native=False)
        cfg, hier, tcfg, th = _fgmres_case(
            "wilson", 16, -0.02, theta, num_iters=6, null_iters=150,
            res_threshold=1e-8)
        kw = dict(tol=1e-8, restart=15, max_restarts=20)
    b = mg.point_source(cfg)
    xj, itj, relj = mg.fgmres_solve(hier, b, cfg, **kw)
    xt, itt, relt = mgt.fgmres_solve(th, t_of(b), tcfg, **kw)
    assert itt == itj
    assert relt < kw["tol"]
    assert abs(relt - relj) < 1e-9 * max(relj, 1e-3)
    assert rel_err(xt, xj) < X_BAR


def test_solvers_return_tensors_on_the_device_of_b():
    D, b = _system("wilson", 8, 0.1, 61)
    Dt, bt = t_of(D), t_of(b)
    for fn in (mgt.mr_solve, mgt.eo_mr_solve, mgt.cgnr_solve):
        x, it, rel = fn(Dt, bt, tol=1e-6, chunk=20)
        assert x.device == bt.device and x.shape == bt.shape
        assert isinstance(it, int) and isinstance(rel, float)
        assert np.isfinite(np_of(x)).all()
