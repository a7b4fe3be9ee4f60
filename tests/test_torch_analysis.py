"""The port's analysis.py against the JAX package's on the same inputs, in
complex128 at 1e-12 (tests/test_analysis.py's cases are the oracle):
the dense operator and its spectrum, the analytic free-field spectra, the
dense staggered and naive operators, the FFT mode error, the
mode-resolved convergence history on JAX's hierarchy, and the results
files and metrics.jsonl of each package's ResultsWriter read back."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_port_helpers import (C128_BAR, crandn, jax_hierarchy_leaves,  # noqa: E402
                                phases, rel_err, t_of)

from tpu_multigrid import analysis as jan  # noqa: E402
from tpu_multigrid.config import MGConfig as JConfig  # noqa: E402
from tpu_multigrid.models import gauge as jg, operators as jo  # noqa: E402
from tpu_multigrid.solver.hierarchy import (build_hierarchy as jbuild,  # noqa: E402
                                            point_source as jsource)
from tpu_multigrid_torch import analysis as tan  # noqa: E402
import tpu_multigrid_torch as mgt  # noqa: E402
from tpu_multigrid_torch.utils.convert import (config_from_dict,  # noqa: E402
                                               hierarchy_from_numpy)


def _operator(stencil, L, m, rng):
    D = np.asarray(jo.assemble(stencil, jg.gauge_from_phases(phases(rng, L)),
                               m))
    return D, t_of(D)


@pytest.mark.parametrize("stencil,L", [("laplace", 6), ("wilson", 4)])
def test_dense_operator_and_spectrum_match_jax(stencil, L, rng):
    D, tD = _operator(stencil, L, 0.3, rng)
    A = tan.dense_operator(tD)
    assert A.shape == (D.shape[1] * L * L,) * 2
    assert rel_err(A, jan.dense_operator(jnp.asarray(D))) < C128_BAR
    ev, jev = np.sort_complex(tan.spectrum(tD)), np.sort_complex(
        jan.spectrum(jnp.asarray(D)))
    assert rel_err(ev, jev) < 1e-10    # eigvals of matrices 1e-12 apart


def test_laplace_spectrum_matches_analytic():
    """test_analysis.py:13-18, in the port."""
    L, m = 8, 0.3
    D = mgt.models.operators.assemble_laplace(
        mgt.models.gauge.identity_gauge(L), m)
    ev = np.sort(tan.spectrum(D).real)
    want = np.sort(tan.laplace_free_spectrum(L, m))
    np.testing.assert_allclose(ev, want, atol=1e-10)
    np.testing.assert_array_equal(tan.laplace_free_spectrum(L, m),
                                  jan.laplace_free_spectrum(L, m))


@pytest.mark.parametrize("convention", ["solver", "notebook"])
def test_wilson_free_spectrum_matches_jax(convention):
    got = tan.wilson_free_spectrum(8, 0.1, convention=convention)
    want = jan.wilson_free_spectrum(8, 0.1, convention=convention)
    assert got.shape == want.shape
    assert rel_err(np.sort_complex(got), np.sort_complex(want)) < C128_BAR
    with pytest.raises(ValueError):
        tan.wilson_free_spectrum(8, 0.1, convention="other")


@pytest.mark.parametrize("which", ["staggered_dense", "naive_dense"])
def test_free_fermion_operators_match_jax(which):
    """test_analysis.py:64-88's operators: the same matrices, and their
    spectra m + i * (imaginary)."""
    got = getattr(tan, which)(6, 0.1)
    np.testing.assert_array_equal(got, getattr(jan, which)(6, 0.1))
    assert np.allclose(np.linalg.eigvals(got).real, 0.1, atol=1e-10)


def test_mode_error_spectrum_matches_jax(rng):
    phi, exact = crandn(rng, (2, 8, 8)), crandn(rng, (2, 8, 8))
    got = tan.mode_error_spectrum(t_of(phi), exact)
    assert got.shape == (8, 8)
    assert rel_err(got, jan.mode_error_spectrum(phi, exact)) < C128_BAR


def test_mode_resolved_convergence_matches_jax():
    """test_analysis.py:21-32's case on JAX's hierarchy: the same modes
    and history (each cycle's row to 1e-12 of its own size), and every
    tracked mode's error down by orders of magnitude."""
    jcfg = JConfig(L=16, stencil="laplace", m=0.1, nlevels=2, num_iters=6,
                   null_iters=60, smoother="rbgs")
    D = jo.assemble("laplace", jg.identity_gauge(16, jcfg.cdtype), jcfg.m)
    jhier = jbuild(D, jcfg, check=False)
    b = jsource(jcfg)
    jmodes, jhist = jan.mode_resolved_convergence(jhier, b, jcfg, n_iters=8)
    import dataclasses
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    hier = hierarchy_from_numpy(*jax_hierarchy_leaves(jhier))
    modes, hist = tan.mode_resolved_convergence(hier, t_of(b), cfg,
                                                n_iters=8)
    assert modes == jmodes and hist.shape == jhist.shape == (8, 6)
    for row, jrow in zip(hist, jhist):
        assert rel_err(row, jrow) < C128_BAR
    assert (hist[-1] < 1e-3 * hist[0] + 1e-12).all()


@pytest.fixture
def results_dirs(tmp_path, rng):
    """One recorded cycle of the same fields by each package's
    ResultsWriter (test_analysis.py:35-50's case)."""
    from tpu_multigrid.solver.hierarchy import zero_fields
    from tpu_multigrid.utils.io import ResultsWriter as JWriter
    jcfg = JConfig(L=8, stencil="laplace", m=0.2, nlevels=1, null_iters=40)
    D = jo.assemble("laplace", jg.identity_gauge(8, jcfg.cdtype), jcfg.m)
    jhier = jbuild(D, jcfg, check=False)
    b = jsource(jcfg)
    phis = [crandn(rng, p.shape) for p in zero_fields(jcfg)]
    w = np.array([0.25 + 0.5j, 0.25, 0.25, 0.25])
    jw = JWriter(jcfg, str(tmp_path / "jax"))
    jw.record(1, jhier, tuple(jnp.asarray(p) for p in phis), b, w)
    jw.close()
    import dataclasses
    cfg = config_from_dict(dataclasses.asdict(jcfg))
    hier = hierarchy_from_numpy(*jax_hierarchy_leaves(jhier))
    tw = mgt.utils.io.ResultsWriter(cfg, str(tmp_path / "port"))
    tw.record(1, hier, tuple(t_of(p) for p in phis), t_of(b), w)
    tw.close()
    return tmp_path, phis


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("name", ["results_phi.txt", "results_res_lvl-0.txt"])
def test_load_results_phi_reads_both_packages(results_dirs, writer, name):
    tmp, phis = results_dirs
    path = str(tmp / writer / name)
    iters, fields = tan.load_results_phi(path, 8, 1)
    jiters, jfields = jan.load_results_phi(path, 8, 1)
    assert iters.tolist() == jiters.tolist() == [1]
    np.testing.assert_array_equal(fields, jfields)
    if name == "results_phi.txt":
        np.testing.assert_allclose(fields[0], phis[0], rtol=1e-12)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_metrics_jsonl_reads_both_packages(results_dirs, writer):
    tmp, _ = results_dirs
    path = str(tmp / writer / "metrics.jsonl")
    rows = tan.load_metrics_jsonl(path)
    assert rows == jan.load_metrics_jsonl(path)
    assert [r["iter"] for r in rows] == [1]
    other = tan.load_metrics_jsonl(
        str(tmp / ("port" if writer == "jax" else "jax") / "metrics.jsonl"))
    assert abs(rows[0]["rel_residual"] - other[0]["rel_residual"]) \
        < C128_BAR * other[0]["rel_residual"]
    assert rows[0]["ntl_weights_re"] == [0.25] * 4


def test_dense_operator_batches_the_basis_on_the_device_of_D(rng):
    """The basis goes through apply_D as one batch, on D's device, and
    the matrix's column j is D applied to basis vector j."""
    _, tD = _operator("wilson", 4, 0.1, rng)
    A = tan.dense_operator(tD)
    e = torch.zeros(2, 4, 4, dtype=tD.dtype)
    e[1, 2, 3] = 1.0
    j = 1 * 16 + 2 * 4 + 3
    col = mgt.ops.stencil.apply_D(tD, e).reshape(-1).numpy()
    np.testing.assert_array_equal(A[:, j], col)
