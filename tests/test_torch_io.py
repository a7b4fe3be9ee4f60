"""The port's I/O surface against the JAX package's: the reference's text
formats byte for byte (_fmt_c, the ResultsWriter files, the native and the
Python writer), gauge and near-null files written by either package and
read back in the other, the solver-state npz crossing between them, and
the gauge helpers random_gauge / wilson_free_spectrum."""
import dataclasses
import os
import shutil

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_port_helpers import C128_BAR, crandn, np_of, rel_err  # noqa: E402

import tpu_multigrid as mg  # noqa: E402
from tpu_multigrid.models import gauge as jgauge, operators as jops  # noqa: E402
from tpu_multigrid.solver.hierarchy import Hierarchy as JHierarchy  # noqa: E402
from tpu_multigrid.solver.hierarchy import LevelOps as JLevelOps  # noqa: E402
from tpu_multigrid.utils import checkpoint as jck, io as jio  # noqa: E402
import tpu_multigrid_torch as mgt  # noqa: E402
from tpu_multigrid_torch.models import gauge as tgauge  # noqa: E402
from tpu_multigrid_torch.models import operators as tops  # noqa: E402
from tpu_multigrid_torch.utils import checkpoint as tck, io as tio  # noqa: E402
from tpu_multigrid_torch.utils import native as tnative  # noqa: E402
from tpu_multigrid_torch.utils.convert import (config_from_dict,  # noqa: E402
                                               hierarchy_from_numpy)


def _special_values(rng):
    vals = np.concatenate([rng.normal(size=16), -rng.normal(size=16),
                           [0.0, -0.0, 1e-300, -1e-300, 1e300, 5.0,
                            -3.14159e-7, np.float32(0.1), 2.0 ** -1074]])
    return vals[: len(vals) // 2 * 2].reshape(-1, 2) @ np.array([1, 1j])


def test_fmt_c_byte_identical_to_jax(rng):
    zs = _special_values(rng)
    assert [tio._fmt_c(z) for z in zs] == [jio._fmt_c(z) for z in zs]
    # the one-shot line formatter of ResultsWriter == _fmt_c per value
    v = zs[:18].reshape(2, 3, 3)
    want = "7," + "".join(jio._fmt_c(z) + ","
                          for z in jio._field_to_ref_order(v)) + "\n"
    assert tio._field_line(7, v) == want
    v32 = v.astype(np.complex64)
    assert tio._field_line(3, v32) == "3," + "".join(
        jio._fmt_c(z) + "," for z in jio._field_to_ref_order(v32)) + "\n"


def _dyadic(rng, shape, scale=1.0):
    """Complex values with small dyadic parts: every sum and product the
    writer takes of them is exact, so both packages round nothing."""
    return (scale * (rng.integers(-4, 5, size=shape)
                     + 1j * rng.integers(-4, 5, size=shape)) / 2.0)


def _writer_case(rng):
    """A laplace hierarchy with nlevels=2 and fields of dyadic values,
    as a JAX Hierarchy and the port's."""
    jcfg = mg.MGConfig(L=8, stencil="laplace", m=0.0, nlevels=2)
    S, n = jcfg.sizes, jcfg.n_dof
    levels = []
    for l in range(jcfg.nlevels + 1):
        D = _dyadic(rng, (5, n[l], n[l], S[l], S[l]))
        pn = (_dyadic(rng, (n[l + 1], n[l], S[l], S[l]), 0.5)
              if l < jcfg.nlevels else None)
        levels.append((D, np.zeros_like(D[0]), pn))
    jh = JHierarchy(levels=tuple(
        JLevelOps(D=jnp.asarray(D), D0inv=jnp.asarray(Di),
                  phi_null=None if pn is None else jnp.asarray(pn))
        for D, Di, pn in levels), ntl=None)
    th = hierarchy_from_numpy(levels, None, None)
    phis = [_dyadic(rng, (n[l], S[l], S[l])) for l in range(len(S))]
    b = _dyadic(rng, (n[0], S[0], S[0]))
    return jcfg, jh, th, phis, b


def test_results_writer_files_byte_identical_to_jax(tmp_path, rng):
    jcfg, jh, th, phis, b = _writer_case(rng)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    jw = jio.ResultsWriter(jcfg, str(tmp_path / "jax"))
    tw = tio.ResultsWriter(tcfg, str(tmp_path / "port"))
    for it in (1, 2):
        w = crandn(rng, 4)
        jw.record(it, jh, tuple(jnp.asarray(p) for p in phis),
                  jnp.asarray(b), w)
        tw.record(it, th, tuple(torch.from_numpy(p) for p in phis),
                  torch.from_numpy(b), torch.from_numpy(w))
        phis = [2.0 * p for p in phis]
    for w in (jw, tw):
        w.write_scaling_summary(17)
        w.close()
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert len(names) == 7          # phi, weights, 3 residual levels, ...
    for name in names:
        got = (tmp_path / "port" / name).read_bytes()
        assert got == (tmp_path / "jax" / name).read_bytes(), name
        assert got


@pytest.mark.skipif(not tnative.available(), reason="no C++ compiler")
def test_native_writer_matches_python_formatter(tmp_path, rng):
    vals = _special_values(rng)
    tnative.write_complex_text(str(tmp_path / "n.txt"), vals)
    with open(tmp_path / "p.txt", "w") as f:
        for z in vals:
            f.write(jio._fmt_c(z) + "\n")
    assert (tmp_path / "n.txt").read_bytes() == (tmp_path / "p.txt").read_bytes()
    back = tnative.read_complex_text(str(tmp_path / "n.txt"), len(vals) + 5)
    np.testing.assert_array_equal(back, vals)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_gauge_files_cross_packages(tmp_path, rng, writer):
    """Heat-bath phase files and complex link files written by one package
    read back in the other exactly."""
    L = 8
    th = rng.uniform(-np.pi, np.pi, (2, L, L))
    p1, p2 = str(tmp_path / "phase_8_b32.0.dat"), str(tmp_path / "U.txt")
    if writer == "jax":
        jgauge.write_heatbath_file(p1, th)
        jgauge.write_gauge_text(p2, jgauge.gauge_from_phases(th))
        U = tgauge.read_heatbath_file(p1, L)
        U2 = tgauge.read_gauge_text(p2, L)
        ref = np.asarray(jgauge.read_heatbath_file(p1, L))
    else:
        tgauge.write_heatbath_file(p1, th)
        tgauge.write_gauge_text(p2, tgauge.gauge_from_phases(th))
        U = jgauge.read_heatbath_file(p1, L)
        U2 = jgauge.read_gauge_text(p2, L)
        ref = np_of(tgauge.read_heatbath_file(p1, L))
    np.testing.assert_array_equal(np_of(U), ref)
    np.testing.assert_allclose(np_of(U), np.exp(1j * th), atol=1e-14)
    if writer == "jax":             # the kernels take contiguous links only
        assert U.is_contiguous() and U2.is_contiguous()
    np.testing.assert_array_equal(np_of(U2), ref)
    assert open(p1).read() == "".join(f"{x:.18e}\n" for x in
                                      np.transpose(th, (1, 2, 0)).ravel())
    if tnative.available():
        np.testing.assert_array_equal(tnative.read_phase_text(p1, 2 * L * L),
                                      np.loadtxt(p1))


def _near_nulls(rng, cfg):
    return [crandn(rng, (cfg.n_dof[l + 1], cfg.n_dof[l], cfg.sizes[l],
                         cfg.sizes[l])) for l in range(cfg.nlevels)]


@pytest.mark.parametrize("fmt", ["txt", "npz"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_near_null_files_cross_packages(tmp_path, rng, fmt, writer):
    jcfg = mg.MGConfig(L=8, stencil="wilson", m=0.1, nlevels=2)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    arrs = _near_nulls(rng, jcfg)
    assert tio.near_null_filename(tcfg) == jio.near_null_filename(jcfg)
    path = str(tmp_path / (tio.near_null_filename(tcfg) if fmt == "txt"
                           else "nn.npz"))
    if writer == "jax":
        (jio.save_near_null_text if fmt == "txt"
         else jio.save_near_null_npz)(path, arrs)
        back = (tio.load_near_null_text(path, tcfg) if fmt == "txt"
                else tio.load_near_null_npz(path))
    else:
        (tio.save_near_null_text if fmt == "txt"
         else tio.save_near_null_npz)(path, [torch.from_numpy(a)
                                             for a in arrs])
        back = (jio.load_near_null_text(path, jcfg) if fmt == "txt"
                else jio.load_near_null_npz(path))
    assert len(back) == len(arrs)
    for a, b in zip(arrs, back):
        np.testing.assert_array_equal(np.asarray(b), a)


def _solver_state_case():
    jcfg = mg.MGConfig(L=16, stencil="laplace", m=0.1, nlevels=2, ntl=True,
                       num_iters=4, null_iters=40, res_threshold=1e-10,
                       max_iters=60)
    rng = np.random.default_rng(5)
    U = jgauge.gauge_from_phases(0.3 * rng.normal(size=(2, 16, 16)))
    jD = jops.assemble(jcfg.stencil, U, jcfg.m)
    return jcfg, mg.build_hierarchy(jD, jcfg, U=U)


def test_solver_state_crosses_and_resumes(tmp_path):
    """A JAX save_solver_state npz loads in the port (every array equal),
    continues by solve_resumable and takes JAX's cycle count; a state the
    port writes loads in JAX."""
    jcfg, jh = _solver_state_case()
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    b = mg.point_source(jcfg)
    # 5 cycles, saved, then the rest of the solve in each package
    jck.solve_resumable(jh, b, jcfg, jpath, checkpoint_every=5, max_iters=5)
    shutil.copy(jpath, tpath)
    th, tphis, it, res = tck.load_solver_state(tpath, tcfg)
    jh2, jphis, jit, jres = jck.load_solver_state(jpath, jcfg)
    assert (it, res) == (jit, jres) == (5, res)
    assert rel_err(th.ntl.D, jh2.ntl.D) == 0.0
    for tl, jl in zip(th.levels, jh2.levels):
        assert rel_err(tl.D, jl.D) == 0.0
    for tp, jp in zip(tphis, jphis):
        np.testing.assert_array_equal(np_of(tp), np.asarray(jp))

    want = jck.solve_resumable(jh, b, jcfg, jpath, checkpoint_every=5)
    got = tck.solve_resumable(None, torch.from_numpy(np.array(b)), tcfg,
                              tpath, checkpoint_every=5)
    assert want.converged and got.converged
    assert got.iters == want.iters
    # rounding: ~1e-16 of |b|, a large share of a residual near 1e-11
    assert abs(got.resmag - want.resmag) < 1e-14
    assert rel_err(got.phi, want.phi) < 1e-9

    # the port's file, read by JAX
    tck.save_solver_state(tpath, tcfg, th, tphis, 5, res)
    jh3, jphis3, it3, res3 = jck.load_solver_state(tpath, jcfg)
    assert (it3, res3) == (5, res)
    assert rel_err(jh3.levels[1].phi_null, th.levels[1].phi_null) == 0.0
    assert rel_err(jphis3[0], tphis[0]) == 0.0


def test_random_gauge_and_free_spectrum():
    g = torch.Generator().manual_seed(3)
    U = tgauge.random_gauge(8, g, 0.2, torch.complex64)
    assert U.shape == (2, 8, 8) and U.dtype == torch.complex64
    np.testing.assert_allclose(np.abs(np_of(U)), 1.0, atol=1e-6)
    again = tgauge.random_gauge(8, torch.Generator().manual_seed(3), 0.2,
                                torch.complex64)
    assert torch.equal(U, again)
    assert torch.equal(tgauge.random_gauge(8, g, 0.0),
                       tgauge.identity_gauge(8))
    for L, m in ((4, 0.1), (6, -0.07)):
        np.testing.assert_array_equal(tops.wilson_free_spectrum(L, m),
                                      jops.wilson_free_spectrum(L, m))
    # the spectrum is the free Wilson operator's
    L, m = 4, 0.1
    D = np_of(tops.assemble("wilson", tgauge.identity_gauge(L), m))
    M = np.zeros((2 * L * L, 2 * L * L), complex)
    for k in range(2 * L * L):
        e = np.zeros(2 * L * L, complex)
        e[k] = 1.0
        M[:, k] = np_of(mgt.ops.stencil.apply_D(
            torch.from_numpy(D), torch.from_numpy(e.reshape(2, L, L)))).ravel()
    ev = np.sort_complex(np.linalg.eigvals(M).round(10))
    assert np.allclose(ev, np.sort_complex(
        tops.wilson_free_spectrum(L, m).round(10)), atol=C128_BAR * 1e3)
