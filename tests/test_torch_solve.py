"""The port's slice end to end against the JAX package, at
__graft_entry__._flagship's small size: Wilson NTL (4 copies, min-res),
L=32, 2 levels, rbgs x4, 16 near-null sweeps, the gauge links carried on
the hierarchy. JAX's near-null starts (the per-level jax.random.split
chain of hierarchy.build_hierarchy) are injected into the port.

complex128 (links on and off): the same cycle count to 1e-8, phi within
1e-9, and the per-cycle NTL weights within 1e-9 (see
torch_port_helpers.weights_bar).
complex64 (links auto): both converge to 1e-6 within one cycle of each
other. Plus one ntl_cycle on a JAX-built
hierarchy carried over by utils.convert.hierarchy_from_numpy.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from torch_port_helpers import (C128_BAR, jax_hierarchy_leaves, np_of,  # noqa: E402
                                rel_err, t_of, weights_bar)

import tpu_multigrid as mg  # noqa: E402
from tpu_multigrid.ops.nearnull import random_starts as jax_random_starts  # noqa: E402
import tpu_multigrid_torch as mgt  # noqa: E402
from tpu_multigrid_torch.solver.cycles import residual_norm_ratio0  # noqa: E402
from tpu_multigrid_torch.utils.convert import (config_from_dict,  # noqa: E402
                                               hierarchy_from_numpy)

SLICE_BAR = 1e-9


def _cfgs(dtype, links, res_threshold=1e-8):
    jcfg = mg.MGConfig(L=32, stencil="wilson", m=-0.005, nlevels=2,
                       ntl=True, n_copies=4, num_iters=4, null_iters=16,
                       dtype=dtype, smoother="rbgs",
                       res_threshold=res_threshold, links=links)
    return jcfg, config_from_dict(dataclasses.asdict(jcfg))


def _jax_starts(cfg):
    key = jax.random.PRNGKey(cfg.seed)
    out = []
    for lvl in range(cfg.nlevels):
        key, sub = jax.random.split(key)
        k = cfg.n_dof[lvl + 1] // 2
        out.append(np.array(jax_random_starts(
            sub, k, cfg.n_dof[lvl], cfg.sizes[lvl], cfg.cdtype)))
    return out


def _build_both(jcfg, tcfg):
    rng = np.random.default_rng(jcfg.seed)
    ph = 0.2 * rng.normal(size=(2, jcfg.L, jcfg.L))
    jU = mg.models.gauge.gauge_from_phases(ph, jcfg.cdtype)
    jD = mg.models.operators.assemble(jcfg.stencil, jU, jcfg.m)
    jhier = mg.build_hierarchy(jD, jcfg, U=jU)
    tU = mgt.models.gauge.gauge_from_phases(ph, tcfg.cdtype)
    tD = mgt.models.operators.assemble(tcfg.stencil, tU, tcfg.m)
    thier = mgt.build_hierarchy(tD, tcfg, U=tU, starts=_jax_starts(jcfg))
    return jhier, thier


def _port_history(hier, b, cfg, max_iters):
    """Per-cycle residuals and NTL weights of the port (the loop of
    solve, recorded)."""
    phis = mgt.zero_fields(cfg)
    hist, weights = [], []
    for _ in range(max_iters):
        phis, a = mgt.cycle(hier, phis, b, cfg)
        hist.append(float(residual_norm_ratio0(hier, phis[0], b, cfg)))
        weights.append(np_of(a))
        if hist[-1] < cfg.res_threshold:
            break
    return phis[0], np.asarray(hist), np.asarray(weights)


@pytest.fixture(scope="module")
def c128_pair():
    jcfg, tcfg = _cfgs("complex128", "on")
    return jcfg, tcfg, _build_both(jcfg, tcfg)


def test_c128_hierarchy_matches(c128_pair):
    jcfg, _, (jhier, thier) = c128_pair
    for jl, tl in zip(jhier.levels, thier.levels):
        assert rel_err(tl.D, jl.D) < SLICE_BAR
        if jl.phi_null is not None:
            assert rel_err(tl.phi_null, jl.phi_null) < SLICE_BAR
    assert rel_err(thier.ntl.D, jhier.ntl.D) < SLICE_BAR
    assert rel_err(thier.gauge, jhier.gauge) < C128_BAR


@pytest.mark.parametrize("links", ["on", "off"])
def test_c128_solve_matches_jax(c128_pair, links):
    jcfg, tcfg, (jhier, thier) = c128_pair
    jcfg, tcfg = jcfg.replace(links=links), tcfg.replace(links=links)
    b_j = mg.point_source(jcfg)
    b_t = mgt.point_source(tcfg)
    ref = mg.solve_with_history(jhier, b_j, jcfg, max_iters=40)
    assert ref.converged
    phi, hist, weights = _port_history(thier, b_t, tcfg, 40)
    assert len(hist) == ref.iters
    assert hist[-1] < tcfg.res_threshold
    np.testing.assert_allclose(hist, ref.history, rtol=1e-6)
    res_in = np.concatenate([[1.0], ref.history[:-1]])
    for k in range(ref.iters):
        assert (rel_err(weights[k], ref.ntl_weights[k])
                < weights_bar(res_in[k], SLICE_BAR))
    assert rel_err(weights[:10], ref.ntl_weights[:10]) < SLICE_BAR
    assert rel_err(phi, ref.phi) < SLICE_BAR
    out = mgt.solve(thier, b_t, tcfg, max_iters=40)
    assert out.converged and out.iters == ref.iters
    assert rel_err(out.phi, ref.phi) < SLICE_BAR


def test_c64_links_auto_converges_like_jax():
    jcfg, tcfg = _cfgs("complex64", "auto", res_threshold=1e-6)
    jhier, thier = _build_both(jcfg, tcfg)
    ref = mg.solve(jhier, mg.point_source(jcfg), jcfg, max_iters=40)
    out = mgt.solve(thier, mgt.point_source(tcfg), tcfg, max_iters=40)
    assert ref.converged and out.converged
    assert abs(out.iters - ref.iters) <= 1, (out.iters, ref.iters)
    assert out.phi.dtype == torch.complex64
    assert np.isfinite(np_of(out.phi)).all()
    chunked = mgt.solve_chunked(thier, mgt.point_source(tcfg), tcfg,
                                max_iters=40, chunk=1)
    assert chunked.converged and chunked.iters == out.iters


@pytest.mark.parametrize("ntl", [True, False])
def test_cycle_on_jax_hierarchy(c128_pair, ntl):
    """One cycle of the port (ntl_cycle, or the telescoping v_cycle) on the
    JAX-built hierarchy carried over as numpy == the JAX cycle, complex128
    at 1e-12."""
    jcfg, tcfg, (jhier, _) = c128_pair
    jcfg, tcfg = jcfg.replace(ntl=ntl), tcfg.replace(ntl=ntl)
    thier = hierarchy_from_numpy(*jax_hierarchy_leaves(jhier),
                                 dtype=torch.complex128)
    b = mg.point_source(jcfg)
    jphis, ja = mg.cycle(jhier, mg.zero_fields(jcfg), b, jcfg)
    tphis, ta = mgt.cycle(thier, mgt.zero_fields(tcfg), t_of(b), tcfg)
    if ntl:
        assert rel_err(ta, ja) < C128_BAR
    assert rel_err(tphis[0], jphis[0]) < C128_BAR
    for tp, jp in zip(tphis, jphis):
        if np.any(np.asarray(jp)):
            assert rel_err(tp, jp) < C128_BAR


# ---- W-cycle, FMG, joint-QR setup, the writer (the CLI's algorithms) ----


def test_gamma_cycle_and_fmg_init_match_jax(c128_pair):
    """cycle() with cycle_gamma=2 (the W-cycle) and fmg_init on the
    JAX-built hierarchy carried over == JAX's, complex128 at 1e-12."""
    jcfg, tcfg, (jhier, _) = c128_pair
    jcfg = jcfg.replace(ntl=False, cycle_gamma=2)
    tcfg = tcfg.replace(ntl=False, cycle_gamma=2)
    thier = hierarchy_from_numpy(*jax_hierarchy_leaves(jhier),
                                 dtype=torch.complex128)
    b = mg.point_source(jcfg)
    jphis, _ = mg.cycle(jhier, mg.zero_fields(jcfg), b, jcfg)
    tphis, _ = mgt.cycle(thier, mgt.zero_fields(tcfg), t_of(b), tcfg)
    assert rel_err(tphis[0], jphis[0]) < C128_BAR
    v_phis, _ = mgt.cycle(thier, mgt.zero_fields(tcfg), t_of(b),
                          tcfg.replace(cycle_gamma=1))
    assert rel_err(v_phis[0], tphis[0]) > 1e-6      # the W-cycle differs
    from tpu_multigrid.solver.cycles import fmg_init as jfmg
    for n_v in (1, 2):
        want = jfmg(jhier, b, jcfg, n_v)
        got = mgt.fmg_init(thier, t_of(b), tcfg, n_v)
        assert len(got) == len(want)
        assert rel_err(got[0], want[0]) < C128_BAR
        assert not any(bool(p.abs().max()) for p in got[1:])


def test_solve_fmg_matches_jax_count(c128_pair):
    jcfg, tcfg, (jhier, _) = c128_pair
    thier = hierarchy_from_numpy(*jax_hierarchy_leaves(jhier),
                                 dtype=torch.complex128)
    want = mg.solve_fmg(jhier, mg.point_source(jcfg), jcfg, max_iters=40,
                        chunk=1)
    got = mgt.solve_fmg(thier, mgt.point_source(tcfg), tcfg, max_iters=40,
                        chunk=1)
    assert want.converged and got.converged
    assert got.iters == want.iters
    assert rel_err(got.phi, want.phi) < SLICE_BAR
    plain = mgt.solve_chunked(thier, mgt.point_source(tcfg), tcfg,
                              max_iters=40, chunk=1)
    assert got.iters <= plain.iters + 1


def test_joint_qr_relaxation_matches_jax():
    """relax_null_vectors(joint_qr=True) from injected starts == JAX's:
    global modified Gram-Schmidt over the candidates at every
    renormalization, c128 at 1e-12; the candidates come out orthonormal."""
    from tpu_multigrid.ops import nearnull as jnn
    from tpu_multigrid_torch.ops import nearnull as tnn
    rng = np.random.default_rng(40)
    L = 8
    D = np.asarray(mg.models.operators.assemble(
        "wilson", mg.models.gauge.gauge_from_phases(
            0.3 * rng.normal(size=(2, L, L))), 0.05))
    Dinv = np.asarray(mg.ops.stencil.site_inverse(D[0]))
    starts = rng.uniform(-np.pi, np.pi, (3, 2, L, L)).astype(complex)
    for kind in ("rbgs", "gs_lex"):
        want = jnn.relax_null_vectors(D, Dinv, starts, 8, 4, kind,
                                      joint_qr=True)
        got = tnn.relax_null_vectors(t_of(D), t_of(Dinv), t_of(starts), 8, 4,
                                     kind, joint_qr=True)
        assert rel_err(got, want) < C128_BAR
        G = torch.einsum("ainm,binm->ab", torch.conj(got), got)
        assert float((G - torch.eye(3, dtype=G.dtype)).abs().max()) < 1e-12
    indep = tnn.relax_null_vectors(t_of(D), t_of(Dinv), t_of(starts), 8, 4,
                                   "rbgs")
    assert rel_err(indep, jnn.relax_null_vectors(D, Dinv, starts, 8, 4,
                                                 "rbgs")) < C128_BAR


def test_solve_with_history_writer_matches_jax(c128_pair, tmp_path):
    """solve_with_history(writer=ResultsWriter) on the carried hierarchy:
    JAX's cycles, one line per cycle in every results file, values within
    1e-9 of JAX's files (of each line's largest value, or of 1e-4)."""
    from tpu_multigrid.utils import io as jio
    from tpu_multigrid_torch.utils import io as tio
    from torch_port_helpers import read_results
    jcfg, tcfg, (jhier, _) = c128_pair
    thier = hierarchy_from_numpy(*jax_hierarchy_leaves(jhier),
                                 dtype=torch.complex128)
    outs = {}
    for name, pkg, io, cfg, hier in (("jax", mg, jio, jcfg, jhier),
                                     ("port", mgt, tio, tcfg, thier)):
        w = io.ResultsWriter(cfg, str(tmp_path / name))
        outs[name] = pkg.solve_with_history(hier, pkg.point_source(cfg), cfg,
                                            max_iters=40, writer=w)
        w.close()
    assert outs["port"].iters == outs["jax"].iters
    for f in ("results_phi.txt", "results_res_lvl-0.txt",
              "results_res_lvl-2.txt", "results_NTL_weights.txt"):
        jits, jrows = read_results(tmp_path / "jax" / f)
        tits, trows = read_results(tmp_path / "port" / f)
        assert tits == jits == list(range(1, outs["jax"].iters + 1))
        if f == "results_NTL_weights.txt":
            continue            # printed to 4 digits
        for t, j in zip(trows, jrows):
            assert t.shape == j.shape == ((2 if "phi" in f or "-0" in f
                                           else 4) * (32 if "-0" in f or
                                                      "phi" in f else 8) ** 2,)
            # late residual fields carry rounding of ~eps |b| (|b| = 5)
            assert (np.max(np.abs(t - j))
                    <= SLICE_BAR * max(np.max(np.abs(j)), 1e-4))
