"""solve_ir and solve_with_history of the port against the JAX package's,
on one JAX-built complex128 hierarchy carried over as numpy
(utils.convert.hierarchy_from_numpy): the configuration of
tests/test_solve.py's IR test (Wilson L=32, m=-0.005, 2 levels, NTL with 4
copies, rbgs x4, 60 near-null sweeps) with the gauge links on the hierarchy
and the exact complex128 level-0 operator as D_outer, to 1e-12.

Inner cycles in complex128: the same outer steps and history as JAX's
solve_ir(planes=False), phi within 1e-9. Inner cycles in complex64 (the
links path at level 0): both reach 1e-12 within one outer step of each
other, phi within 1e-10.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_port_helpers import (jax_hierarchy_leaves, rel_err, t_of,  # noqa: E402
                                weights_bar)

import tpu_multigrid as mg  # noqa: E402
from tpu_multigrid.solver.driver import solve_ir as jax_solve_ir  # noqa: E402
import tpu_multigrid_torch as mgt  # noqa: E402
from tpu_multigrid_torch.utils.convert import (config_from_dict,  # noqa: E402
                                               hierarchy_from_numpy)

INNER = 2
MAX_ITERS = 100


@pytest.fixture(scope="module")
def problem():
    L = 32
    jcfg = mg.MGConfig(L=L, stencil="wilson", m=-0.005, nlevels=2, ntl=True,
                       num_iters=4, null_iters=60, dtype="complex128",
                       smoother="rbgs", res_threshold=1e-12)
    rng = np.random.default_rng(jcfg.seed)
    jU = mg.models.gauge.gauge_from_phases(0.2 * rng.normal(size=(2, L, L)),
                                           jcfg.cdtype)
    jD = mg.models.operators.assemble(jcfg.stencil, jU, jcfg.m)
    jhier = mg.build_hierarchy(jD, jcfg, check=False, U=jU)
    thier = hierarchy_from_numpy(*jax_hierarchy_leaves(jhier),
                                 dtype=torch.complex128)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    b = np.zeros((2, L, L), np.complex128)
    b[0, 2, 2] = 5.0
    return jcfg, tcfg, jhier, thier, np.asarray(jD), b


def _both(problem, inner_dtype):
    jcfg, tcfg, jhier, thier, D, b = problem
    ref = jax_solve_ir(jhier, jnp.asarray(b), jcfg, inner_cycles=INNER,
                       max_iters=MAX_ITERS, inner_dtype=inner_dtype,
                       D_outer=jnp.asarray(D), planes=False)
    out = mgt.solve_ir(thier, t_of(b), tcfg, inner_cycles=INNER,
                       max_iters=MAX_ITERS, inner_dtype=inner_dtype,
                       D_outer=D)
    return ref, out


def test_solve_ir_c128_inner_matches_jax(problem):
    """Same outer steps; the histories agree to 1e-15 absolute (relative to
    |b|): their difference is the rounding of |b - D phi|, ~eps |b|, so
    relative to a residual of 1e-12 it grows to ~1e-5."""
    ref, out = _both(problem, "complex128")
    assert ref.converged and out.converged
    assert out.iters == ref.iters
    assert out.history_stride == ref.history_stride == INNER
    assert len(out.history) * INNER == out.iters
    np.testing.assert_allclose(out.history, ref.history, rtol=1e-12,
                               atol=1e-15)
    assert out.phi.dtype == torch.complex128
    assert rel_err(out.phi, ref.phi) < 1e-9


def test_solve_ir_c64_inner_matches_jax(problem):
    ref, out = _both(problem, "complex64")
    assert ref.converged and out.converged
    assert ref.resmag < 1e-12 and out.resmag < 1e-12
    assert abs(out.iters - ref.iters) <= INNER
    assert rel_err(out.phi, ref.phi) < 1e-10


def test_solve_ir_outer_chunk(problem):
    """Two outer steps between host read-backs: one history entry per
    chunk, the same solution as one step at a time."""
    _, tcfg, _, thier, D, b = problem
    one = mgt.solve_ir(thier, t_of(b), tcfg, inner_cycles=INNER,
                       max_iters=MAX_ITERS, inner_dtype="complex64",
                       D_outer=D)
    two = mgt.solve_ir(thier, t_of(b), tcfg, inner_cycles=INNER,
                       max_iters=MAX_ITERS, inner_dtype="complex64",
                       D_outer=D, outer_chunk=2)
    assert two.converged and two.history_stride == 2 * INNER
    assert len(two.history) * 2 * INNER == two.iters
    assert two.iters in (one.iters, one.iters + INNER)
    n = len(one.history) // 2
    np.testing.assert_allclose(two.history[:n], one.history[1::2][:n],
                               rtol=1e-12)


def test_solve_with_history_matches_jax(problem):
    """Per-cycle residuals and NTL weights of the plain cycle loop, to 1e-8
    (weights under torch_port_helpers.weights_bar)."""
    jcfg, tcfg, jhier, thier, _, b = problem
    jcfg, tcfg = (c.replace(res_threshold=1e-8) for c in (jcfg, tcfg))
    ref = mg.solve_with_history(jhier, jnp.asarray(b), jcfg, max_iters=60)
    out = mgt.solve_with_history(thier, t_of(b), tcfg, max_iters=60)
    assert ref.converged and out.converged
    assert out.iters == ref.iters == len(out.history)
    assert out.history_stride == 1
    np.testing.assert_allclose(out.history, ref.history, rtol=1e-6)
    assert out.ntl_weights.shape == ref.ntl_weights.shape == (
        ref.iters, tcfg.n_copies)
    res_in = np.concatenate([[1.0], ref.history[:-1]])
    for k in range(ref.iters):
        assert (rel_err(out.ntl_weights[k], ref.ntl_weights[k])
                < weights_bar(res_in[k]))
    assert rel_err(out.phi, ref.phi) < 1e-9
    with pytest.raises(NotImplementedError):
        mgt.solve_with_history(thier, t_of(b), tcfg, max_iters=1,
                               writer=object())
