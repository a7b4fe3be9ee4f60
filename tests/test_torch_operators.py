"""Per-module parity of the port's level-0 operator modules against the
JAX package, complex128, at the reference's self-test bar (1e-12):
models.operators, ops.stencil, ops.norms and ops.gauge_stencil."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_port_helpers import C128_BAR, crandn, phases, rel_err, t_of  # noqa: E402

from tpu_multigrid.models import gauge as jgauge, operators as jops  # noqa: E402
from tpu_multigrid.ops import gauge_stencil as jgs, norms as jnorms  # noqa: E402
from tpu_multigrid.ops import stencil as jst  # noqa: E402
from tpu_multigrid_torch.models import gauge as tgauge, operators as tops  # noqa: E402
from tpu_multigrid_torch.ops import gauge_stencil as tgs, norms as tnorms  # noqa: E402
from tpu_multigrid_torch.ops import stencil as tst  # noqa: E402

L = 16


def _links(seed, L=L):
    ph = phases(np.random.default_rng(seed), L)
    return (jgauge.gauge_from_phases(ph, jnp.complex128),
            tgauge.gauge_from_phases(ph, torch.complex128))


@pytest.mark.parametrize("stencil,m", [("wilson", -0.005), ("laplace", 0.05)])
def test_assemble(stencil, m):
    ju, tu = _links(1)
    assert rel_err(tu, ju) < C128_BAR
    jD = jops.assemble(stencil, ju, m)
    tD = tops.assemble(stencil, tu, m)
    assert tuple(tD.shape) == jD.shape and tD.dtype == torch.complex128
    assert rel_err(tD, jD) < C128_BAR


@pytest.mark.parametrize("stencil,m", [("wilson", -0.005), ("laplace", 0.05)])
def test_apply_D_and_residual(stencil, m):
    ju, tu = _links(2)
    rng = np.random.default_rng(3)
    n = 2 if stencil == "wilson" else 1
    v, r = crandn(rng, (n, L, L)), crandn(rng, (n, L, L))
    jD = jops.assemble(stencil, ju, m)
    tD = tops.assemble(stencil, tu, m)
    assert rel_err(tst.apply_D(tD, t_of(v)), jst.apply_D(jD, v)) < C128_BAR
    assert rel_err(tst.apply_hop(tD, t_of(v)), jst.apply_hop(jD, v)) < C128_BAR
    assert rel_err(tst.residual(tD, t_of(v), t_of(r)),
                   jst.residual(jD, v, r)) < C128_BAR
    ratio_t = float(tst.residual_norm_ratio(tD, t_of(v), t_of(r)))
    ratio_j = float(jst.residual_norm_ratio(jD, v, r))
    assert abs(ratio_t - ratio_j) / ratio_j < C128_BAR


@pytest.mark.parametrize("n", [1, 2, 4])
def test_site_inverse(n):
    rng = np.random.default_rng(4 + n)
    M = crandn(rng, (n, n, L, L)) + 3.0 * np.eye(n)[:, :, None, None]
    jinv = jst.site_inverse(jnp.asarray(M))
    tinv = tst.site_inverse(t_of(M))
    assert tinv.is_contiguous()
    assert rel_err(tinv, jinv) < C128_BAR


def test_site_inverse_batched():
    """The NTL copies invert a stack of coarse diagonals in one call."""
    rng = np.random.default_rng(9)
    M = crandn(rng, (3, 4, 4, 8, 8)) + 3.0 * np.eye(4)[:, :, None, None]
    tinv = tst.site_inverse(t_of(M))
    for q in range(3):
        assert rel_err(tinv[q], jst.site_inverse(jnp.asarray(M[q]))) < C128_BAR


def test_norms():
    rng = np.random.default_rng(5)
    u, v = crandn(rng, (2, L, L)), crandn(rng, (2, L, L))
    assert rel_err(tnorms.global_norm(t_of(v)), jnorms.global_norm(v)) < C128_BAR
    tv, tn = tnorms.normalize(t_of(v))
    jv, jn = jnorms.normalize(jnp.asarray(v))
    assert rel_err(tv, jv) < C128_BAR and rel_err(tn, jn) < C128_BAR
    assert rel_err(tnorms.cdot(t_of(u), t_of(v)), jnorms.cdot(u, v)) < C128_BAR


def test_wilson_hop_and_residual_u():
    ju, tu = _links(6)
    m = -0.005
    rng = np.random.default_rng(7)
    v, r = crandn(rng, (2, L, L)), crandn(rng, (2, L, L))
    assert rel_err(tgs.wilson_hop_u(tu, t_of(v)),
                   jgs.wilson_hop_u(ju, v)) < C128_BAR
    assert rel_err(tgs.residual_u("wilson", tu, m, t_of(v), t_of(r)),
                   jgs.residual_u("wilson", ju, m, v, r)) < C128_BAR
    assert rel_err(tgs.residual_u("laplace", tu, m, t_of(v[:1]), t_of(r[:1])),
                   jgs.residual_u("laplace", ju, m, v[:1], r[:1])) < C128_BAR
    # the links-only form is the assembled dense stencil's math
    tD = tops.assemble("wilson", tu, m)
    assert rel_err(tgs.residual_u("wilson", tu, m, t_of(v), t_of(r)),
                   tst.residual(tD, t_of(v), t_of(r))) < C128_BAR


@pytest.mark.parametrize("kind", ["jacobi", "rbgs"])
@pytest.mark.parametrize("omega", [1.0, 0.8])
def test_smooth_u(kind, omega):
    ju, tu = _links(8)
    m = -0.005
    rng = np.random.default_rng(9)
    v, r = crandn(rng, (2, L, L)), crandn(rng, (2, L, L))
    got = tgs.smooth_u("wilson", tu, m, t_of(v), t_of(r), 3, kind, omega)
    want = jgs.smooth_u("wilson", ju, m, v, r, 3, kind, omega)
    assert rel_err(got, want) < C128_BAR
