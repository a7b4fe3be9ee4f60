"""The JAX package's Pallas TPU SpMV kernels, run in interpret mode,
against the port's dispatched SpMV, which runs the plain versions on CPU
tensors: B7a (dense apply), B7b (x-tiled dense apply), B8 (links apply)
and B5c (x-tiled links apply), in complex64 at 2e-5. The port's kernels
themselves are held against the plain versions on the card
(tests/test_torch_cuda.py).

Also: adjoint_stencil and apply_D_unrolled against JAX in complex128, the
L2 rule of the SpMV (apply_mode) at the shapes the card runs, and the
x-tiled wrappers' refusal of a bad tile."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from torch_port_helpers import (C128_BAR, C64_BAR, crandn, phases,  # noqa: E402
                                rel_err, t_of)

from tpu_multigrid.models import gauge as jgauge  # noqa: E402
from tpu_multigrid.models import operators as jops  # noqa: E402
from tpu_multigrid.ops import pallas_stencil as ps  # noqa: E402
from tpu_multigrid.ops import stencil as jst  # noqa: E402
from tpu_multigrid_torch.models import operators as tops  # noqa: E402
from tpu_multigrid_torch.ops import cuda_stencil as cs  # noqa: E402
from tpu_multigrid_torch.ops import dispatch  # noqa: E402
from tpu_multigrid_torch.ops import stencil as tst  # noqa: E402


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _dense(rng, n, L, dtype=np.complex64, lead=()):
    D = 0.25 * crandn(rng, lead + (5, n, n, L, L))
    D[..., 0, :, :, :, :] += 4.0 * np.eye(n)[:, :, None, None]
    return D.astype(dtype)


def _links_case(L, seed):
    rng = np.random.default_rng(seed)
    jU = jgauge.gauge_from_phases(phases(rng, L), jnp.complex64)
    return -0.005, jU, crandn(rng, (2, L, L), np.complex64)


# ---- the kernels' math against the Pallas kernels (interpret mode)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dense_apply_vs_pallas_B7a(interpret_pallas, n):
    rng = np.random.default_rng(30 + n)
    L = 8
    D, v = _dense(rng, n, L), crandn(rng, (n, L, L), np.complex64)
    want = ps.apply_D_pallas(jnp.asarray(D), jnp.asarray(v))
    got = dispatch.apply_D(t_of(D), t_of(v))
    assert got.dtype == torch.complex64
    assert rel_err(got, want) < C64_BAR
    assert rel_err(tst.apply_D(t_of(D), t_of(v)), want) < C64_BAR


@pytest.mark.parametrize("n,L", [(4, 16), (2, 32)])
def test_dense_apply_vs_pallas_tiled_B7b(interpret_pallas, n, L):
    """x-tiles of 8 rows: every tile reads its x+-1 halo rows across the
    tile edge, the first and last with the periodic wrap."""
    rng = np.random.default_rng(40 + n)
    D, v = _dense(rng, n, L), crandn(rng, (n, L, L), np.complex64)
    want = ps.apply_D_pallas_tiled(jnp.asarray(D), jnp.asarray(v), TX=8)
    got = dispatch.apply_D(t_of(D), t_of(v))
    assert rel_err(got, want) < C64_BAR


def test_links_apply_vs_pallas_B8(interpret_pallas):
    """D_U v = (2+m) v + hop_U(v): the same as the kernel on the half-scaled
    link planes, and as the dense apply of the assembled Wilson stencil."""
    m, jU, v = _links_case(16, 50)
    want = ps.apply_wilson_u_pallas_vmem(jU, m, jnp.asarray(v))
    got = dispatch.links_apply(t_of(jU), m, t_of(v))
    assert rel_err(got, want) < C64_BAR
    dense = jst.apply_D(jops.assemble("wilson", jU, m), jnp.asarray(v))
    assert rel_err(got, dense) < C64_BAR


def test_links_apply_vs_pallas_tiled_B5c(interpret_pallas):
    """4 x-tiles of 8 rows at L=32, with the wrapped x-1 link row."""
    m, jU, v = _links_case(32, 51)
    want = ps.apply_wilson_u_pallas(jU, m, jnp.asarray(v), TX=8)
    got = dispatch.links_apply(t_of(jU), m, t_of(v))
    assert rel_err(got, want) < C64_BAR
    U = t_of(jU)
    dense = tst.apply_D(tops.assemble_wilson(U, m), t_of(v))
    assert rel_err(got, dense) < C64_BAR


# ---- the plain helpers against JAX in complex128


@pytest.mark.parametrize("stencil", ["laplace", "wilson", "random n=4"])
def test_adjoint_stencil_matches_jax(stencil):
    rng = np.random.default_rng(52)
    L = 8
    if stencil == "random n=4":
        D = _dense(rng, 4, L, np.complex128)
    else:
        U = jgauge.gauge_from_phases(phases(rng, L, 0.3), jnp.complex128)
        D = np.asarray(jops.assemble(stencil, U, -0.03))
    want = jst.adjoint_stencil(jnp.asarray(D))
    got = tst.adjoint_stencil(t_of(D))
    assert rel_err(got, want) < C128_BAR
    n = D.shape[1]
    v, w = crandn(rng, (n, L, L)), crandn(rng, (n, L, L))
    # <w, D v> == <D^H w, v>
    lhs = torch.vdot(t_of(w).ravel(), tst.apply_D(t_of(D), t_of(v)).ravel())
    rhs = torch.vdot(tst.apply_D(got, t_of(w)).ravel(), t_of(v).ravel())
    assert abs(complex(lhs - rhs)) < 1e-11 * abs(complex(lhs))


def test_adjoint_stencil_batched():
    rng = np.random.default_rng(53)
    D = _dense(rng, 2, 8, np.complex128, lead=(3,))
    got = tst.adjoint_stencil(t_of(D))
    for k in range(3):
        assert torch.equal(got[k], tst.adjoint_stencil(t_of(D[k])))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_apply_D_unrolled_matches_jax(n):
    rng = np.random.default_rng(54 + n)
    L = 8
    D, v = _dense(rng, n, L, np.complex128), crandn(rng, (n, L, L))
    want = jst.apply_D_unrolled(jnp.asarray(D), jnp.asarray(v))
    assert rel_err(tst.apply_D_unrolled(t_of(D), t_of(v)), want) < C128_BAR
    assert rel_err(tst.apply_D(t_of(D), t_of(v)), want) < C128_BAR
    assert tst.nnz_per_site(n) == jst.nnz_per_site(n)


# ---- the L2 rule and the tiles


def test_apply_mode_at_the_card_shapes():
    """The dense apply streams 5n^2 + 2n words a site, the links apply 6:
    n=2 at L=256 and the n=4 batch at L=32 stay global; n=2 at 2048/4096
    and n=4 at 1024 are tiled; the links apply is global up to L=1024 in
    complex64 (50.3 MB) and tiled past it."""
    c64, c128 = torch.complex64, torch.complex128
    assert cs.apply_mode(2, 256, c64) == "global"
    assert cs.apply_mode(2, 256, c128) == "global"
    assert cs.apply_mode(4, 32, c64) == "global"
    assert [cs.apply_mode(2, L, c64) for L in (2048, 4096)] == ["tiled"] * 2
    assert cs.apply_mode(4, 1024, c64) == "tiled"
    assert cs.apply_mode(2, 128, c128) == "global"
    assert [cs.apply_mode(2, L, c64, links=True) for L in (256, 1024, 2048,
                                                          4096)] == [
        "global", "global", "tiled", "tiled"]
    assert cs.apply_mode(2, 1024, c128, links=True) == "tiled"


def test_tiled_apply_wrappers_refuse_a_bad_tile():
    """A tile outside 1..16 x 1..32 is refused before the wrapper looks at
    its operands (CPU tensors here)."""
    rng = np.random.default_rng(57)
    L, m = 8, 0.1
    U = t_of(np.exp(1j * phases(rng, L)))
    v = t_of(crandn(rng, (2, L, L)))
    D = t_of(_dense(rng, 2, L, np.complex128))
    for tile in ((0, 32), (17, 32), (16, 33)):
        with pytest.raises(ValueError, match="tile"):
            cs.dense_apply_tiled(D, v, tile=tile)
        with pytest.raises(ValueError, match="tile"):
            cs.wilson_u_apply_tiled(U, m, v, tile=tile)
