"""Singular solves in the port against the JAX package, on the CPU in
complex128.

jnp.linalg.solve and jnp.linalg.inv return non-finite values for a
singular system and raise nothing; a vmapped solve marks only the singular
entry. The port's min-res weights (solver.cycles.min_res_weights) and
site inverse (ops.stencil.site_inverse, n=4) do the same: no exception,
non-finite values where JAX has them, and the other entries of a batch
untouched. A batched solve whose one right-hand side is zero (its NTL
corrections are zero, so its min-res system is A = 0) marks that entry
non-finite in both packages and agrees on the others at 1e-12.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_port_helpers import (C128_BAR, crandn, jax_hierarchy_leaves,  # noqa: E402
                                np_of, phases, rel_err, t_of)

import tpu_multigrid as mg  # noqa: E402
from tpu_multigrid.ops import stencil as jst  # noqa: E402
from tpu_multigrid.solver import cycles as jcyc  # noqa: E402
from tpu_multigrid.solver import ensemble as jens  # noqa: E402
import tpu_multigrid_torch as mgt  # noqa: E402
from tpu_multigrid_torch.ops import stencil as tst  # noqa: E402
from tpu_multigrid_torch.solver import cycles as tcyc  # noqa: E402
from tpu_multigrid_torch.utils.convert import (config_from_dict,  # noqa: E402
                                               hierarchy_from_numpy)

L = 8


def _cfg(stencil):
    return mg.MGConfig(L=L, stencil=stencil, m=0.1, nlevels=2, ntl=True,
                       num_iters=4, null_iters=20, null_joint_qr=True,
                       res_threshold=1e-10)


def _singular_xs(rng, kind, nf):
    """n_copies = 4 corrections whose Gram matrix A_pq = <x_p, D x_q> is
    zero (every x zero) or of rank 1 (every x the same field)."""
    if kind == "zero":
        return np.zeros((4, nf, L, L), np.complex128)
    x = crandn(rng, (nf, L, L))
    return np.stack([x] * 4)


@pytest.mark.parametrize("stencil", ["wilson", "laplace"])
@pytest.mark.parametrize("kind", ["zero", "rank1"])
def test_min_res_weights_singular_gives_non_finite(stencil, kind):
    jcfg = _cfg(stencil)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    nf = jcfg.n_dof[0]
    rng = np.random.default_rng(11)
    U = mg.models.gauge.gauge_from_phases(phases(rng, L), jcfg.cdtype)
    D = np.asarray(mg.models.operators.assemble(stencil, U, jcfg.m))
    r = crandn(rng, (nf, L, L))
    xs = _singular_xs(rng, kind, nf)
    jw = np.asarray(jcyc.min_res_weights(jnp.asarray(D), jnp.asarray(r),
                                         jnp.asarray(xs), jcfg))
    tw = np_of(tcyc.min_res_weights(t_of(D), t_of(r), t_of(xs), tcfg))
    assert tw.shape == jw.shape == (4,)
    assert not np.isfinite(jw).all()
    assert not np.isfinite(tw).all()


def test_min_res_weights_batch_marks_only_the_singular_entry():
    """A batch of three systems, the middle one singular: JAX's vmapped
    solve and the port's batched one give non-finite weights there alone
    and agree on the other two."""
    jcfg = _cfg("wilson")
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(12)
    U = mg.models.gauge.gauge_from_phases(phases(rng, L), jcfg.cdtype)
    D = np.asarray(mg.models.operators.assemble("wilson", U, jcfg.m))
    r = crandn(rng, (3, 2, L, L))
    xs = crandn(rng, (3, 4, 2, L, L))
    xs[1] = 0.0
    jw = np.asarray(jax.vmap(lambda rr, xx: jcyc.min_res_weights(
        jnp.asarray(D), rr, xx, jcfg))(jnp.asarray(r), jnp.asarray(xs)))
    tw = np_of(tcyc.min_res_weights(t_of(D), t_of(r), t_of(xs), tcfg))
    for w in (jw, tw):
        assert not np.isfinite(w[1]).any()
        assert np.isfinite(w[[0, 2]]).all()
    assert rel_err(tw[[0, 2]], jw[[0, 2]]) < C128_BAR


@pytest.mark.parametrize("kind", ["zero", "rank1"])
def test_site_inverse_n4_singular_block_gives_non_finite(kind):
    """One singular 4 x 4 site block among invertible ones: non-finite
    there in both packages, the same inverse elsewhere."""
    rng = np.random.default_rng(13)
    M = crandn(rng, (4, 4, L, L)) + 4.0 * np.eye(4)[:, :, None, None]
    # rank 1: four equal rows, which elimination cancels exactly
    M[:, :, 2, 3] = (0.0 if kind == "zero"
                     else np.outer(np.ones(4), crandn(rng, 4)))
    jinv = np.asarray(jst.site_inverse(jnp.asarray(M)))
    tinv = np_of(tst.site_inverse(t_of(M)))
    for inv in (jinv, tinv):
        assert not np.isfinite(inv[:, :, 2, 3]).all()
    keep = np.ones((L, L), bool)
    keep[2, 3] = False
    assert np.isfinite(tinv[:, :, keep]).all()
    assert rel_err(tinv[:, :, keep], jinv[:, :, keep]) < C128_BAR


def test_batched_solve_with_a_zero_rhs_matches_jax():
    """Three right-hand sides on one Wilson NTL hierarchy, the second one
    zero: JAX's vmapped solve_ensemble (the hierarchy stacked three times)
    and the port's solve_batched both mark it non-finite, raise nothing,
    and agree on the other two at 1e-12."""
    jcfg = _cfg("wilson")
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    rng = np.random.default_rng(14)
    U = mg.models.gauge.gauge_from_phases(phases(rng, L), jcfg.cdtype)
    jhier = mg.build_hierarchy(
        mg.models.operators.assemble("wilson", U, jcfg.m), jcfg, check=False)
    bs = crandn(rng, (3, 2, L, L))
    bs[1] = 0.0
    jhier_b = jax.tree.map(lambda x: jnp.stack([x] * 3), jhier)
    jphi, jres = jens.solve_ensemble(jhier_b, jnp.asarray(bs), jcfg,
                                     n_cycles=5)
    thier = hierarchy_from_numpy(*jax_hierarchy_leaves(jhier))
    tphi, tres = mgt.solve_batched(thier, t_of(bs), tcfg, n_cycles=5)
    tphi, jphi = np_of(tphi), np.asarray(jphi)
    for phi, res in ((jphi, np.asarray(jres)), (tphi, tres)):
        assert not np.isfinite(phi[1]).all() and not np.isfinite(res[1])
        assert np.isfinite(phi[[0, 2]]).all()
        assert np.isfinite(res[[0, 2]]).all()
    for i in (0, 2):
        assert rel_err(tphi[i], jphi[i]) < C128_BAR
    np.testing.assert_allclose(tres[[0, 2]], np.asarray(jres)[[0, 2]],
                               rtol=1e-6)
    # the same hierarchy through the port's ensemble path
    tphi_e, tres_e = mgt.solve_ensemble(
        mgt.solver.ensemble.stack_hierarchies([thier] * 3), t_of(bs), tcfg,
        n_cycles=5)
    assert not np.isfinite(np_of(tphi_e)[1]).all()
    for i in (0, 2):
        assert rel_err(tphi_e[i], jphi[i]) < C128_BAR
