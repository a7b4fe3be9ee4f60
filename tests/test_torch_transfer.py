"""Setup and transfer modules of the port against the JAX package,
complex128 at 1e-12: restrict / prolong / ortho_pass / coarse_operator in
each blocking quadrant, near-null relaxation from injected starts, and the
NTL min-res weights."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from torch_port_helpers import C128_BAR, crandn, phases, rel_err, t_of  # noqa: E402

import tpu_multigrid as mg  # noqa: E402
from tpu_multigrid.models import gauge as jgauge, operators as jops  # noqa: E402
from tpu_multigrid.ops import galerkin as jgal, nearnull as jnn  # noqa: E402
from tpu_multigrid.ops import stencil as jst, transfer as jtr  # noqa: E402
from tpu_multigrid.solver import cycles as jcy  # noqa: E402
import tpu_multigrid_torch as mgt  # noqa: E402
from tpu_multigrid_torch.ops import galerkin as tgal, nearnull as tnn  # noqa: E402
from tpu_multigrid_torch.ops import stencil as tst, transfer as ttr  # noqa: E402
from tpu_multigrid_torch.solver import cycles as tcy  # noqa: E402

L, NC, NF, B = 16, 4, 2, 2


def _wilson_D(seed, L=L, m=-0.005):
    ph = phases(np.random.default_rng(seed), L)
    return jops.assemble("wilson", jgauge.gauge_from_phases(ph), m)


@pytest.mark.parametrize("quad", [1, 2, 3, 4])
def test_restrict_prolong_ortho(quad):
    rng = np.random.default_rng(20 + quad)
    pn = crandn(rng, (NC, NF, L, L))
    vf = crandn(rng, (NF, L, L))
    vc = crandn(rng, (NC, L // B, L // B))
    assert rel_err(ttr.restrict(t_of(pn), t_of(vf), quad, B, B),
                   jtr.restrict(pn, vf, quad, B, B)) < C128_BAR
    assert rel_err(ttr.prolong(t_of(pn), t_of(vc), quad, B, B),
                   jtr.prolong(pn, vc, quad, B, B)) < C128_BAR
    assert rel_err(ttr.block_norms(t_of(vf), quad, B, B),
                   jtr.block_norms(vf, quad, B, B)) < C128_BAR
    tp = ttr.normalize_rows(t_of(pn), quad, B, B)
    jp = jtr.normalize_rows(pn, quad, B, B)
    assert rel_err(tp, jp) < C128_BAR
    for _ in range(2):
        tp = ttr.ortho_pass(tp, quad, B, B)
        jp = jtr.ortho_pass(jp, quad, B, B)
    assert rel_err(tp, jp) < C128_BAR
    assert float(ttr.check_ortho(tp, quad, B, B)) < C128_BAR
    # restriction then prolongation with orthonormal rows is the identity
    # on the coarse space (reference self-test 1)
    back = ttr.restrict(tp, ttr.prolong(tp, t_of(vc), quad, B, B), quad, B, B)
    assert rel_err(back, vc) < C128_BAR


@pytest.mark.parametrize("quad", [1, 2, 3, 4])
def test_coarse_operator(quad):
    rng = np.random.default_rng(30 + quad)
    jD = _wilson_D(31)
    pn = jtr.ortho_pass(jtr.normalize_rows(crandn(rng, (NC, NF, L, L)),
                                           quad, B, B), quad, B, B)
    want = jgal.coarse_operator(jD, pn, quad, B, B)
    got = tgal.coarse_operator(t_of(jD), t_of(pn), quad, B, B)
    assert tuple(got.shape) == (5, NC, NC, L // B, L // B)
    assert rel_err(got, want) < C128_BAR


@pytest.mark.parametrize("smoother", ["rbgs", "jacobi"])
def test_relax_null_vectors_from_injected_starts(smoother):
    """The k candidates relax as one batch through smooth == JAX's vmap."""
    jD = _wilson_D(40)
    jDinv = jst.site_inverse(jD[0])
    starts = jnn.random_starts(jax.random.PRNGKey(41), NC // 2, NF, L,
                               jnp.complex128)
    want = jnn.relax_null_vectors(jD, jDinv, starts, 16, 4, smoother)
    got = tnn.relax_null_vectors(t_of(jD), t_of(jDinv), t_of(starts), 16, 4,
                                 smoother)
    assert rel_err(got, want) < C128_BAR
    assert rel_err(tnn.candidates_to_phi_null(got, "wilson", NC),
                   jnn.candidates_to_phi_null(want, "wilson", NC)) < C128_BAR


def test_random_starts_shape_and_range():
    import torch
    g = torch.Generator().manual_seed(7)
    s = tnn.random_starts(g, 2, NF, 8, torch.complex64)
    assert tuple(s.shape) == (2, NF, 8, 8) and s.dtype == torch.complex64
    assert float(s.real.abs().max()) <= np.pi and float(s.imag.abs().max()) == 0
    again = tnn.random_starts(torch.Generator().manual_seed(7), 2, NF, 8,
                              torch.complex64)
    assert torch.equal(s, again)


@pytest.mark.parametrize("stencil", ["wilson", "laplace"])
def test_min_res_weights(stencil):
    """Both min-res sources, including the reference's wilson/laplace
    asymmetry (cfg.minres_src='auto')."""
    rng = np.random.default_rng(50)
    n = 2 if stencil == "wilson" else 1
    ph = phases(rng, L)
    jD = jops.assemble(stencil, jgauge.gauge_from_phases(ph), 0.05)
    xs, r = crandn(rng, (4, n, L, L)), crandn(rng, (n, L, L))
    for src in ("auto", "x_dot_r", "r_dot_dx"):
        jcfg = mg.MGConfig(L=L, stencil=stencil, minres_src=src)
        tcfg = mgt.MGConfig(L=L, stencil=stencil, minres_src=src)
        want = jcy.min_res_weights(jD, r, xs, jcfg)
        got = tcy.min_res_weights(t_of(jD), t_of(r), t_of(xs), tcfg)
        assert rel_err(got, want) < C128_BAR


def test_apply_D_batched_matches_per_copy():
    """min_res_weights applies D to all copies at once (JAX vmaps)."""
    rng = np.random.default_rng(51)
    jD = _wilson_D(52)
    xs = crandn(rng, (3, NF, L, L))
    got = tst.apply_D(t_of(jD), t_of(xs))
    for q in range(3):
        assert rel_err(got[q], jst.apply_D(jD, xs[q])) < C128_BAR
