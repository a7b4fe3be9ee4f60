"""Smoothers of the port against the JAX package: the plain torch sweeps
(the kernels' plain versions, which ops/dispatch runs on CPU tensors) in
complex128 at 1e-12, with a batch axis and shared or batched stencils;
and the Pallas TPU kernels they replace (B1 links smoother, B2 links
residual, B3/B4 dense smoothers), run in interpret mode, in complex64 at
2e-5."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from torch_port_helpers import (C64_BAR, C128_BAR, crandn, phases,  # noqa: E402
                                rel_err, t_of)

from tpu_multigrid.models import gauge as jgauge, operators as jops  # noqa: E402
from tpu_multigrid.ops import pallas_stencil as ps  # noqa: E402
from tpu_multigrid.ops import smoothers as jsm, stencil as jst  # noqa: E402
from tpu_multigrid_torch.ops import cuda_stencil as cs  # noqa: E402
from tpu_multigrid_torch.ops import dispatch  # noqa: E402
from tpu_multigrid_torch.ops import smoothers as tsm, stencil as tst  # noqa: E402


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _dense(rng, B, n, L):
    """Random diagonally dominant 5-point block stencils [B, 5, n, n, L, L]."""
    D = 0.25 * crandn(rng, (B, 5, n, n, L, L))
    D[:, 0] += 4.0 * np.eye(n)[:, :, None, None]
    return D


@pytest.mark.parametrize("kind", ["jacobi", "rbgs"])
@pytest.mark.parametrize("n,shared", [(4, False), (4, True), (2, True),
                                      (1, False)])
def test_smooth_batched(kind, n, shared):
    """Batched phi/r with per-copy stencils (the NTL coarse copies) or one
    shared stencil (the near-null candidates) == JAX's vmapped smooth."""
    rng = np.random.default_rng(10 + n)
    B, L = 3, 8
    D = _dense(rng, 1 if shared else B, n, L)
    Dinv = np.stack([np.asarray(jst.site_inverse(jnp.asarray(d[0])))
                     for d in D])
    phi, r = crandn(rng, (B, n, L, L)), crandn(rng, (B, n, L, L))
    tD, tDinv = t_of(D), t_of(Dinv)
    if shared:
        tD, tDinv = tD[0], tDinv[0]
    got = dispatch.smooth(tD, tDinv, t_of(phi), t_of(r), 3, kind)
    for b in range(B):
        i = 0 if shared else b
        want = jsm.smooth(D[i], Dinv[i], phi[b], r[b], 3, kind)
        assert rel_err(got[b], want) < C128_BAR


@pytest.mark.parametrize("kind", ["jacobi", "rbgs"])
def test_smooth_unbatched_wilson(kind):
    rng = np.random.default_rng(11)
    L, m = 16, -0.005
    ph = phases(rng, L)
    jD = jops.assemble("wilson", jgauge.gauge_from_phases(ph), m)
    tD = t_of(jD)
    phi, r = crandn(rng, (2, L, L)), crandn(rng, (2, L, L))
    jDinv = jst.site_inverse(jD[0])
    got = dispatch.smooth(tD, tst.site_inverse(tD[0]), t_of(phi), t_of(r),
                          4, kind, omega=0.9)
    want = jsm.smooth(jD, jDinv, phi, r, 4, kind, omega=0.9)
    assert rel_err(got, want) < C128_BAR


@pytest.mark.parametrize("omega", [1.0, 0.8])
@pytest.mark.parametrize("n,B,shared", [(1, None, True), (2, None, True),
                                        (4, 3, False), (2, 3, True)])
def test_gs_lex_matches_jax(n, B, shared, omega):
    """gs_lex_sweep (2L-1 anti-diagonal steps) == JAX's wavefront, in
    c128 at 1e-12: unbatched, and with a batch axis (per-copy stencils as
    the NTL copies, or one shared stencil as the setup candidates)."""
    rng = np.random.default_rng(30 + n)
    L = 6
    D = _dense(rng, 1 if shared else B, n, L)
    Dinv = np.stack([np.asarray(jst.site_inverse(jnp.asarray(d[0])))
                     for d in D])
    lead = (B,) if B else ()
    phi, r = crandn(rng, lead + (n, L, L)), crandn(rng, lead + (n, L, L))
    tD, tDinv = t_of(D), t_of(Dinv)
    if shared:
        tD, tDinv = tD[0], tDinv[0]
    got = dispatch.smooth(tD, tDinv, t_of(phi), t_of(r), 2, "gs_lex", omega)
    for b in range(B or 1):
        i = 0 if shared else b
        want = jsm.smooth(D[i], Dinv[i], phi[b] if B else phi,
                          r[b] if B else r, 2, "gs_lex", omega)
        assert rel_err(got[b] if B else got, want) < C128_BAR
    # one sweep == the lexicographic site loop, done by hand
    ref = t_of(phi[0] if B else phi).clone()
    rr = t_of(r[0] if B else r)
    Dq, Dq0 = t_of(D[0]), t_of(Dinv[0])
    for x in range(L):
        for y in range(L):
            upd = tsm._local_solve(Dq0, tst.apply_hop(Dq, ref), rr)
            ref[:, x, y] = ref[:, x, y] + omega * (upd[:, x, y] - ref[:, x, y])
    one = tsm.gs_lex_sweep(Dq, Dq0, t_of(phi[0] if B else phi), rr, omega)
    assert rel_err(one, ref) < C128_BAR
    with pytest.raises(NotImplementedError):     # no kernel takes gs_lex
        cs._check_lattice(8, "gs_lex")


# ---- the Pallas TPU kernels (interpret mode) vs the port's plain versions


def _c64_case(L=16, seed=3):
    rng = np.random.default_rng(seed)
    m = -0.07
    ph = phases(rng, L)
    jU = jgauge.gauge_from_phases(ph, jnp.complex64)
    v = crandn(rng, (2, L, L), np.complex64)
    r = np.zeros_like(v)
    r[0, 2, 2] = 5.0
    return m, jU, v, r


@pytest.mark.parametrize("kind", ["jacobi", "rbgs"])
def test_links_smoother_vs_pallas_B1(interpret_pallas, kind):
    m, jU, v, r = _c64_case()
    want = ps.wilson_u_smooth_pallas(jU, m, jnp.asarray(v), jnp.asarray(r),
                                     2, kind)
    got = dispatch.links_smooth(t_of(jU), m, t_of(v), t_of(r), 2, kind)
    assert got.dtype == torch.complex64
    assert rel_err(got, want) < C64_BAR


def test_links_residual_vs_pallas_B2(interpret_pallas):
    m, jU, v, r = _c64_case()
    want = ps.wilson_u_residual_pallas(jU, m, jnp.asarray(v), jnp.asarray(r),
                                       "vmem")
    got = dispatch.links_residual(t_of(jU), m, t_of(v), t_of(r))
    assert rel_err(got, want) < C64_BAR


@pytest.mark.parametrize("kind", ["rbgs", "jacobi"])
def test_dense_smoother_vs_pallas_B3_B4(interpret_pallas, kind):
    """n=4 coarse-level shapes, as levels 1-2 of the flagship; one sweep
    (red then black) keeps interpret mode's unrolled n=4 graph cheap."""
    rng = np.random.default_rng(13)
    n, L = 4, 8
    D = _dense(rng, 1, n, L)[0].astype(np.complex64)
    Dinv = np.asarray(jst.site_inverse(jnp.asarray(D[0])))
    phi = crandn(rng, (n, L, L), np.complex64)
    r = crandn(rng, (n, L, L), np.complex64)
    fn = ps.rbgs_smooth_pallas if kind == "rbgs" else ps.jacobi_smooth_pallas
    want = fn(jnp.asarray(D), jnp.asarray(Dinv), jnp.asarray(phi),
              jnp.asarray(r), 1)
    got = dispatch.smooth(t_of(D), t_of(Dinv), t_of(phi), t_of(r), 1, kind)
    assert rel_err(got, want) < C64_BAR
