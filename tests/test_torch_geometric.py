"""The port's generation-1 / generation-2 geometric programs
(solver/geometric.py) against the JAX package's, float64 on the CPU, at
L <= 64: every function to 1e-12, and the solves' histories and cycle
counts at test_golden_gen1's and test_geo2's configurations."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_port_helpers import C128_BAR, rel_err, t_of  # noqa: E402

from tpu_multigrid.solver import geometric as jgeo  # noqa: E402
from tpu_multigrid_torch.solver import geometric as tgeo  # noqa: E402
from tpu_multigrid_torch.utils.convert import geo_config_from_dict  # noqa: E402


def _cfgs(cls="GeoConfig", **kw):
    jcfg = getattr(jgeo, cls)(**kw)
    tcfg = geo_config_from_dict(dataclasses.asdict(jcfg))
    assert type(tcfg).__name__ == cls
    return jcfg, tcfg


def test_config_crosses_and_derives_alike():
    for cls in ("GeoConfig", "Geo2Config"):
        jcfg, tcfg = _cfgs(cls, L=64, m=0.1, nlevels=3)
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert (jcfg.sizes, jcfg.spacings, jcfg.scales) == (
            tcfg.sizes, tcfg.spacings, tcfg.scales)


@pytest.mark.parametrize("smoother", ["jacobi", "rbgs", "gs_lex"])
@pytest.mark.parametrize("level", [0, 2])
def test_pieces_match_jax(smoother, level):
    """residual, sum|r|, its rounding floor, one smooth call (jacobi with
    omega 0.8), restrict, prolong and the quadrant transfers."""
    jcfg, tcfg = _cfgs(L=32, m=0.3, nlevels=3, smoother=smoother,
                       omega=0.8 if smoother == "jacobi" else 1.0)
    rng = np.random.default_rng(level + len(smoother))
    S = 32 >> level
    phi, r = rng.normal(size=(S, S)), rng.normal(size=(S, S))
    jp, jr = jnp.asarray(phi), jnp.asarray(r)
    tp, tr = t_of(phi), t_of(r)
    assert rel_err(tgeo.geo_residual(tp, tr, level, tcfg),
                   jgeo.geo_residual(jp, jr, level, jcfg)) < C128_BAR
    assert rel_err(tgeo.geo_smooth(tp, tr, level, 3, tcfg),
                   jgeo.geo_smooth(jp, jr, level, 3, jcfg)) < C128_BAR
    assert abs(float(tgeo.geo_residue_l1(tp, tr, tcfg))
               / float(jgeo.geo_residue_l1(jp, jr, jcfg)) - 1) < C128_BAR
    assert abs(tgeo.geo_residual_floor(tp, tr, tcfg)
               / jgeo.geo_residual_floor(jp, jr, jcfg) - 1) < C128_BAR
    assert rel_err(tgeo.geo_restrict(tp), jgeo.geo_restrict(jp)) < C128_BAR
    assert rel_err(tgeo.geo_prolong(tp), jgeo.geo_prolong(jp)) < C128_BAR
    for q in (1, 2, 3, 4):
        assert rel_err(tgeo.quad_restrict(tp, q),
                       jgeo.quad_restrict(jp, q)) < C128_BAR
        assert rel_err(tgeo.quad_prolong(tp, q),
                       jgeo.quad_prolong(jp, q)) < C128_BAR


def test_cycles_and_sources_match_jax():
    jcfg, tcfg = _cfgs(L=32, m=0.5, nlevels=3, num_iters=4, smoother="rbgs")
    assert torch.equal(tgeo.geo_source(tcfg), t_of(jgeo.geo_source(jcfg)))
    j2, t2 = _cfgs("Geo2Config", L=32, m=0.5, nlevels=3, num_iters=4,
                   smoother="rbgs", n_copies=4)
    assert torch.equal(tgeo.geo2_source(t2), t_of(jgeo.geo2_source(j2)))
    rng = np.random.default_rng(3)
    phis = [rng.normal(size=(s, s)) for s in jcfg.sizes]
    b = rng.normal(size=(32, 32))
    jout = jgeo.geo_vcycle(tuple(map(jnp.asarray, phis)), jnp.asarray(b),
                           jcfg)
    tout = tgeo.geo_vcycle(tuple(map(t_of, phis)), t_of(b), tcfg)
    assert rel_err(tout[0], jout[0]) < C128_BAR
    for combine in ("divide", "single"):
        c2j = dataclasses.replace(j2, combine=combine, n_single=2)
        c2t = dataclasses.replace(t2, combine=combine, n_single=2)
        jout = jgeo.geo2_vcycle(tuple(map(jnp.asarray, phis)),
                                jnp.asarray(b), c2j)
        tout = tgeo.geo2_vcycle(tuple(map(t_of, phis)), t_of(b), c2t)
        assert rel_err(tout[0], jout[0]) < C128_BAR


@pytest.mark.parametrize("L,m,nl,ni,thr", [(32, 0.5, 3, 4, 1e-12),
                                           (64, 0.05, 4, 10, 1e-10)])
def test_geo_solve_gs_lex_matches_jax(L, m, nl, ni, thr):
    """test_golden_gen1's configurations: the exact lexicographic
    smoother, one cycle a host check; the same history and count."""
    jcfg, tcfg = _cfgs(L=L, m=m, nlevels=nl, num_iters=ni,
                       res_threshold=thr, smoother="gs_lex")
    _, jit, jres, jhist = jgeo.geo_solve(jgeo.geo_source(jcfg), jcfg,
                                         max_iters=200, chunk=1)
    b = tgeo.geo_source(tcfg)
    phi, it, res, hist = tgeo.geo_solve(b, tcfg, max_iters=200, chunk=1)
    assert it == jit and res < thr
    # every entry to the summation-order rounding of sum|r| (~1e-14 here)
    np.testing.assert_allclose(
        hist, jhist, rtol=0, atol=10 * tgeo.geo_residual_floor(phi, b, tcfg))


@pytest.mark.parametrize("t_flag", [False, True])
def test_geo2_solve_matches_jax(t_flag):
    """test_geo2's configuration (L=32, m=0.5, 3 levels, 4 sweeps,
    gs_lex), telescoping and not: the same history and count."""
    jcfg, tcfg = _cfgs("Geo2Config", L=32, m=0.5, nlevels=3, num_iters=4,
                       smoother="gs_lex", t_flag=t_flag,
                       res_threshold=1e-12)
    _, jit, jres, jhist = jgeo.geo2_solve(jgeo.geo2_source(jcfg), jcfg,
                                          max_iters=100, chunk=1)
    b = tgeo.geo2_source(tcfg)
    phi, it, res, hist = tgeo.geo2_solve(b, tcfg, max_iters=100, chunk=1)
    assert it == jit and res < 1e-12
    np.testing.assert_allclose(
        hist, jhist, rtol=0, atol=10 * tgeo.geo_residual_floor(phi, b, tcfg))


def test_geo_solve_ir_matches_jax():
    """float32 V-cycles inside the float64 defect correction: the same
    count; each history entry within the float32 rounding of the inner
    cycles' correction (1e-6 of the residual it corrects) and the float64
    rounding floor of sum|r|."""
    jcfg, tcfg = _cfgs(L=64, m=0.064, nlevels=4, res_threshold=1e-10,
                       num_iters=10)
    jphi, jit, jres, jhist = jgeo.geo_solve_ir(jgeo.geo_source(jcfg), jcfg,
                                               max_iters=40)
    phi, it, res, hist = tgeo.geo_solve_ir(tgeo.geo_source(tcfg), tcfg,
                                           max_iters=40)
    assert phi.dtype == torch.float64
    assert it == jit and res < 1e-10
    assert rel_err(phi, jphi) < 1e-9
    before = np.concatenate([[float(np.abs(jgeo.geo_source(jcfg)).sum())],
                             jhist[:-1]])
    assert len(hist) == len(jhist)
    floor = tgeo.geo_residual_floor(phi, tgeo.geo_source(tcfg), tcfg)
    assert (np.abs(hist - jhist) <= 1e-6 * before + 10 * floor).all()


@pytest.mark.parametrize("m,t_flag,cycles", [(0.05, False, 12),
                                             (0.05, True, 15),
                                             (0.1, False, 7), (0.1, True, 8),
                                             (0.3, False, 6), (0.3, True, 6)])
def test_geo2_counts_of_the_compiled_reference(m, t_flag, cycles):
    """bench_rungs/scans.json G (gen 2, L=64, 4 levels, 4 lexicographic
    sweeps, sum|r| < 1e-10, one cycle a host check): the port takes the
    compiled telescoping_2d_laplace_Mgrid.cpp's cycle counts."""
    cfg = tgeo.Geo2Config(L=64, m=m, nlevels=4, num_iters=4,
                          smoother="gs_lex", t_flag=t_flag,
                          res_threshold=1e-10)
    _, it, res, _ = tgeo.geo2_solve(tgeo.geo2_source(cfg), cfg,
                                    max_iters=100, chunk=1)
    assert it == cycles and res < 1e-10
