"""The x-tiled kernels of the port against the JAX package's x-tiled Pallas
TPU kernels, run in interpret mode: B5a (links smoother), B5b (links
residual) and B6 (dense smoother), in complex64 at 2e-5, with explicit
tiles so several tiles and the wrapped halo rows are exercised. On CPU
tensors the port's wrappers run their plain versions; the kernels
themselves are held against those on the card (tests/test_torch_cuda.py).

Also: the global/tiled dispatch at the level sizes of the large flagship
(Wilson L=2048, 6 levels), and that the solver routes each level to the
wrapper the dispatch names."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from torch_port_helpers import C64_BAR, crandn, phases, rel_err, t_of  # noqa: E402

from tpu_multigrid.models import gauge as jgauge  # noqa: E402
from tpu_multigrid.ops import pallas_stencil as ps  # noqa: E402
from tpu_multigrid.ops import stencil as jst  # noqa: E402
import tpu_multigrid_torch as mgt  # noqa: E402
from tpu_multigrid_torch.ops import cuda_stencil as cs  # noqa: E402
from tpu_multigrid_torch.ops import gauge_stencil as tgs  # noqa: E402
from tpu_multigrid_torch.ops import smoothers as tsm, stencil as tst  # noqa: E402
from tpu_multigrid_torch.solver import cycles as tcy  # noqa: E402


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _links_case(L=32, seed=21):
    rng = np.random.default_rng(seed)
    m = -0.005
    jU = jgauge.gauge_from_phases(phases(rng, L), jnp.complex64)
    v = crandn(rng, (2, L, L), np.complex64)
    r = crandn(rng, (2, L, L), np.complex64)
    return m, jU, v, r


@pytest.mark.parametrize("kind", ["jacobi", "rbgs"])
def test_links_smoother_vs_pallas_tiled_B5a(interpret_pallas, kind):
    """4 x-tiles of 8 rows at L=32: the tile edges and the wrapped x-1 link
    row (uld) of every tile."""
    m, jU, v, r = _links_case()
    want = ps.wilson_u_smooth_pallas_tiled(jU, m, jnp.asarray(v),
                                           jnp.asarray(r), 2, kind, TX=8)
    got = cs.wilson_u_smooth_tiled(t_of(jU), m, t_of(v), t_of(r), 2, kind,
                                   tile=(8, 8))
    assert got.dtype == torch.complex64
    assert rel_err(got, want) < C64_BAR


def test_links_residual_vs_pallas_tiled_B5b(interpret_pallas):
    m, jU, v, r = _links_case(seed=22)
    want = ps.wilson_u_residual_pallas(jU, m, jnp.asarray(v), jnp.asarray(r),
                                       "tiled", TX=8)
    got = cs.wilson_u_residual_tiled(t_of(jU), m, t_of(v), t_of(r),
                                     tile=(8, 8))
    assert rel_err(got, want) < C64_BAR


@pytest.mark.parametrize("kind", ["rbgs", "jacobi"])
def test_dense_smoother_vs_pallas_tiled_B6(interpret_pallas, kind):
    """n=4 (levels 1-3 of the large flagship) at L=16 on 2 x-tiles; one
    sweep keeps interpret mode's unrolled n=4 graph cheap."""
    rng = np.random.default_rng(23)
    n, L = 4, 16
    D = 0.25 * crandn(rng, (5, n, n, L, L))
    D[0] += 4.0 * np.eye(n)[:, :, None, None]
    D = D.astype(np.complex64)
    Dinv = np.asarray(jst.site_inverse(jnp.asarray(D[0])))
    phi = crandn(rng, (n, L, L), np.complex64)
    r = crandn(rng, (n, L, L), np.complex64)
    want = ps.smooth_pallas_tiled(jnp.asarray(D), jnp.asarray(Dinv),
                                  jnp.asarray(phi), jnp.asarray(r), 1, kind,
                                  TX=8)
    got = cs.dense_smooth_tiled(t_of(D), t_of(Dinv), t_of(phi), t_of(r), 1,
                                kind, tile=(8, 8))
    assert rel_err(got, want) < C64_BAR


# ---- dispatch


def test_modes_at_the_large_flagship_sizes():
    """Wilson L=2048, 6 levels, complex64: level 0 (links) and levels 1-3
    (n=4 at 1024/512/256) are past the L2 and tiled; levels 4-5 (128, 64),
    the NTL copies (n=4 at 32) and the L=256 flagship's levels stay on the
    global kernels."""
    c64, c128 = torch.complex64, torch.complex128
    assert cs.u_mode(2048, c64) == "tiled"
    assert [cs.smoother_mode(4, L, c64) for L in (1024, 512, 256, 128, 64, 32)
            ] == ["tiled"] * 3 + ["global"] * 3
    assert cs.smoother_mode(2, 2048, c64) == "tiled"     # setup, level 0
    assert cs.u_mode(256, c64) == "global"               # L=256 flagship
    assert cs.smoother_mode(2, 256, c64) == "global"
    assert cs.smoother_mode(4, 128, c64) == "global"
    assert cs.u_mode(1024, c64) == "tiled"
    assert cs.u_mode(512, c64) == "global"
    assert cs.smoother_mode(4, 128, c128) == "global"    # 28 MB in c128
    assert cs.u_mode(1024, c128) == "tiled"


def test_default_tile():
    assert cs.default_tile(2048) == (16, 32)
    assert cs.default_tile(1024) == (16, 32)
    assert cs.default_tile(256) == (8, 32)
    for L in (32, 256, 2048):
        assert all(t <= m for t, m in zip(cs.default_tile(L), cs.MAX_TILE))


# ---- CPU tensors


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the tiled wrappers run their plain versions, equal to
    them exactly, and count no launch; a bad tile is refused."""
    rng = np.random.default_rng(24)
    L, m = 8, 0.1
    U = t_of(np.exp(1j * phases(rng, L)))
    phi, r = t_of(crandn(rng, (2, L, L))), t_of(crandn(rng, (2, L, L)))
    D = 0.25 * t_of(crandn(rng, (2, 5, 2, 2, L, L)))
    D[:, 0] += 4.0 * torch.eye(2, dtype=D.dtype)[:, :, None, None]
    Dinv = tst.site_inverse(D[:, 0])
    before = dict(cs.launches)
    for kind in ("rbgs", "jacobi"):
        assert torch.equal(
            cs.wilson_u_smooth_tiled(U, m, phi, r, 2, kind, 0.9, tile=(3, 5)),
            tgs.smooth_u("wilson", U, m, phi, r, 2, kind, 0.9))
        batch = phi[None].expand(2, -1, -1, -1).contiguous()
        assert torch.equal(
            cs.dense_smooth_tiled(D, Dinv, batch, r, 2, kind),
            tsm.smooth_plain(D, Dinv, batch, r, 2, kind))
    assert torch.equal(cs.wilson_u_residual_tiled(U, m, phi, r),
                       tgs.residual_u("wilson", U, m, phi, r))
    assert cs.launches == before
    for tile in ((0, 32), (17, 32), (16, 33)):
        with pytest.raises(ValueError):
            cs.wilson_u_residual_tiled(U, m, phi, r, tile=tile)


# ---- routing


def _spy(monkeypatch, name):
    """Replace cs.<name> by a recorder that runs the original."""
    calls = []
    orig = getattr(cs, name)

    def spy(*a, **k):
        calls.append(name)
        return orig(*a, **k)

    monkeypatch.setattr(cs, name, spy)
    return calls


@pytest.mark.parametrize("mode", ["global", "tiled"])
def test_smooth_routes_by_smoother_mode(monkeypatch, mode):
    rng = np.random.default_rng(25)
    n, L = 4, 8
    D = 0.25 * t_of(crandn(rng, (5, n, n, L, L)))
    D[0] += 4.0 * torch.eye(n, dtype=D.dtype)[:, :, None, None]
    phi, r = t_of(crandn(rng, (n, L, L))), t_of(crandn(rng, (n, L, L)))
    monkeypatch.setattr(cs, "smoother_mode", lambda n, L, dtype: mode)
    tiled = _spy(monkeypatch, "dense_smooth_tiled")
    plain = _spy(monkeypatch, "dense_smooth")
    tsm.smooth(D, tst.site_inverse(D[0]), phi, r, 1, "rbgs")
    assert (tiled if mode == "tiled" else plain) == [
        "dense_smooth_tiled" if mode == "tiled" else "dense_smooth"]
    assert (plain if mode == "tiled" else tiled) == []
    tsm.smooth(D, tst.site_inverse(D[0]), phi, r, 1, "rbgs", pallas="off")
    assert len(tiled) + len(plain) == 1


@pytest.mark.parametrize("mode", ["global", "tiled"])
def test_level0_routes_by_u_mode(monkeypatch, mode):
    """_relax / _residual0 at level 0 with the links active take the tiled
    or the global links wrappers as u_mode says; pallas='off' neither."""
    rng = np.random.default_rng(26)
    L = 8
    cfg = mgt.MGConfig(L=L, stencil="wilson", m=-0.005, nlevels=1,
                       num_iters=2, dtype="complex64")
    U = t_of(np.exp(1j * phases(rng, L))).to(torch.complex64)
    phi = t_of(crandn(rng, (2, L, L), np.complex64))
    r = t_of(crandn(rng, (2, L, L), np.complex64))
    monkeypatch.setattr(cs, "u_mode", lambda L, dtype: mode)
    names = {"global": ("wilson_u_smooth", "wilson_u_residual"),
             "tiled": ("wilson_u_smooth_tiled", "wilson_u_residual_tiled")}
    spies = {k: _spy(monkeypatch, k) for pair in names.values() for k in pair}
    tcy._relax(None, phi, r, cfg, 0, U)
    tcy._residual0(None, phi, r, cfg, 0, U)
    got = [k for k, calls in spies.items() for _ in calls]
    assert got == list(names[mode])
    off = cfg.replace(pallas="off")
    tcy._relax(None, phi, r, off, 0, U)
    tcy._residual0(None, phi, r, off, 0, U)
    assert sum(len(c) for c in spies.values()) == 2
