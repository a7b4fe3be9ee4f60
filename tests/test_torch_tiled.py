"""The JAX package's x-tiled Pallas TPU kernels, run in interpret mode with
explicit tiles so several tiles and the wrapped halo rows are exercised,
against the port's dispatched calls, which run the plain versions on CPU
tensors: B5a (links smoother), B5b (links residual) and B6 (dense
smoother), in complex64 at 2e-5. The port's kernels themselves are held
against the plain versions on the card (tests/test_torch_cuda.py).

Also: the L2 rule (u_mode, smoother_mode) at the level sizes of the large
flagship (Wilson L=2048, 6 levels); the tiles; a torch mirror of the
fused red-black pass of the CUDA kernels (its tiles, two-site halo and
ring) against the plain sweeps; the wrappers' sweep schedule and their
out-of-place rule."""
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
from tpu_multigrid_torch.ops import cuda_stencil as cs  # noqa: E402
from tpu_multigrid_torch.ops import dispatch  # noqa: E402
from tpu_multigrid_torch.ops import gauge_stencil as tgs  # noqa: E402
from tpu_multigrid_torch.ops import smoothers as tsm, stencil as tst  # noqa: E402


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
    got = dispatch.links_smooth(t_of(jU), m, t_of(v), t_of(r), 2, kind)
    assert got.dtype == torch.complex64
    assert rel_err(got, want) < C64_BAR


def test_links_residual_vs_pallas_tiled_B5b(interpret_pallas):
    m, jU, v, r = _links_case(seed=22)
    want = ps.wilson_u_residual_pallas(jU, m, jnp.asarray(v), jnp.asarray(r),
                                       "tiled", TX=8)
    got = dispatch.links_residual(t_of(jU), m, t_of(v), t_of(r))
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
    got = dispatch.smooth(t_of(D), t_of(Dinv), t_of(phi), t_of(r), 1, kind)
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


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("itemsize", [8, 16])
def test_rb_tile_fits_the_shared_memory(n, itemsize):
    """The dense red-black tile: 12 (complex64) or 6 (complex128) x-rows
    by 32 from L=1024, 16 below, cut by 2 rows where the block's staged
    phi and black-site operands would pass the shared memory of a block
    (n=4 complex128 below 1024: 8)."""
    for L in (256, 512, 1024, 2048):
        TX, TY = cs.rb_tile(L, n, itemsize)
        assert TY == 32 and 1 <= TX <= cs.MAX_TILE[0]
        assert cs.rb_smem_bytes(n, TX, TY, itemsize) <= cs.SMEM_BLOCK_MAX
        want = 16 if L < 1024 else (12 if itemsize == 8 else 6)
        if n == 4 and itemsize == 16 and L < 1024:
            want = 8
        assert TX == want, (L, TX)
    assert cs.rb_smem_bytes(4, 16, 32, 8) == 195072
    assert cs.rb_smem_bytes(4, 12, 32, 8) == 147456
    assert cs.rb_smem_bytes(4, 16, 32, 16) > cs.SMEM_BLOCK_MAX


def test_dense_red_black_tile_past_the_shared_memory_is_refused():
    """n=4 complex128 on 16 x 32 tiles would need 390 KB of shared memory
    a block: refused for red-black before any launch, on CPU tensors as on
    the card, and taken for Jacobi (no staged operands)."""
    rng = np.random.default_rng(27)
    n, L = 4, 8
    D = 0.25 * t_of(crandn(rng, (5, n, n, L, L)))
    D[0] += 4.0 * torch.eye(n, dtype=D.dtype)[:, :, None, None]
    Dinv = tst.site_inverse(D[0])
    phi, r = t_of(crandn(rng, (n, L, L))), t_of(crandn(rng, (n, L, L)))
    with pytest.raises(ValueError, match="shared memory"):
        cs.dense_smooth_tiled(D, Dinv, phi, r, 1, "rbgs", tile=(16, 32))
    assert cs._tile((16, 32), L, 0, 16) == (16, 32)


# ---- the tiles the wrappers take


def test_tiled_wrappers_refuse_a_bad_tile():
    """A tile outside 1..16 x 1..32 is refused before the wrapper looks at
    its operands (CPU tensors here)."""
    rng = np.random.default_rng(24)
    L, m = 8, 0.1
    U = t_of(np.exp(1j * phases(rng, L)))
    phi, r = t_of(crandn(rng, (2, L, L))), t_of(crandn(rng, (2, L, L)))
    for tile in ((0, 32), (17, 32), (16, 33)):
        with pytest.raises(ValueError, match="tile"):
            cs.wilson_u_residual_tiled(U, m, phi, r, tile=tile)


# ---- the sweep schedule of the tiled wrappers


@pytest.mark.parametrize("kind,n_sweeps", [("rbgs", 4), ("rbgs", 1),
                                           ("jacobi", 3), ("rbgs", 0)])
def test_sweeps_one_launch_a_sweep_out_of_place(kind, n_sweeps):
    """_sweeps makes one launch a sweep (rb=1 for red-black), from the
    caller's phi into a buffer of its own and then back and forth between
    two (phi -> A -> B -> A ...); phi is never a destination, and no sweeps
    give a copy of phi with no launch."""
    phi = torch.arange(8.0).reshape(2, 2, 2).to(torch.complex128)
    calls = []

    def launch(src, dst, rb):
        calls.append((src.data_ptr(), dst.data_ptr(), rb))
        dst.copy_(src + 1)

    out = cs._sweeps(launch, phi, n_sweeps, kind)
    assert len(calls) == n_sweeps
    assert torch.equal(out, phi + n_sweeps)
    assert out.data_ptr() != phi.data_ptr()
    assert all(rb == int(kind == "rbgs") for _, _, rb in calls)
    assert all(dst != phi.data_ptr() for _, dst, _ in calls)
    if calls:
        assert calls[0][0] == phi.data_ptr()
    for (_, dst, _), (src, _, _) in zip(calls, calls[1:]):
        assert src == dst
    assert len({dst for _, dst, _ in calls}) == min(n_sweeps, 2)


def test_sweep_refuses_dst_overlapping_src():
    """A fused red-black sweep reads src two sites past its tile while
    other blocks write dst: a sweep with dst == src, or overlapping it, is
    refused before any launch."""
    rng = np.random.default_rng(28)
    L = 8
    U = t_of(np.exp(1j * phases(rng, L)))
    phi, r = t_of(crandn(rng, (2, L, L))), t_of(crandn(rng, (2, L, L)))
    D = t_of(crandn(rng, (5, 2, 2, L, L)))
    dims = (1, 2, L, 0, 0, 0)
    before = dict(cs.launches)
    for dst in (phi, phi[1], phi.flatten()[3:]):
        with pytest.raises(ValueError, match="out of place"):
            cs._links_sweep(U, 0.1, r, 1.0, 4, 4, phi, dst, 1)
        with pytest.raises(ValueError, match="out of place"):
            cs._dense_sweep(D, D[0], r, dims, 1.0, 4, 4, phi, dst, 1)
    assert cs.launches == before


# ---- the fused red-black pass of the CUDA kernels, mirrored in torch


def _fused_rb_sweep(relax, src, TX, TY):
    """One red-black sweep as links_rb_tiled_kernel / dense_rb_tiled_kernel
    (csrc/stencil_tiled.cu) compute it, tile by tile, out of place: stage
    src over the tile and a two-site periodic halo; update the red sites
    ((x + y) even, global coordinates) of the tile AND of its one-site ring
    in the staged copy, from the staged black sites; then the tile's black
    sites from the new reds; write both colours of the tile (not the ring)
    to dst. relax(v, gx, gy) is the update at the lattice rows gx and
    columns gy from v [..., len(gx) + 2, len(gy) + 2], the staged values
    with a one-site border."""
    L = src.shape[-1]
    dst = torch.full_like(src, float("nan"))
    for x0 in range(0, L, TX):
        for y0 in range(0, L, TY):
            tx, ty = min(TX, L - x0), min(TY, L - y0)
            sv = src[..., (torch.arange(x0 - 2, x0 + tx + 2) % L)[:, None],
                     (torch.arange(y0 - 2, y0 + ty + 2) % L)[None, :]]
            ix = torch.arange(x0 - 1, x0 + tx + 1)     # tile and ring
            iy = torch.arange(y0 - 1, y0 + ty + 1)
            red = (ix[:, None] + iy[None, :]) % 2 == 0
            sv[..., 1:-1, 1:-1] = torch.where(
                red, relax(sv, ix % L, iy % L), sv[..., 1:-1, 1:-1])
            bx, by = ix[1:-1], iy[1:-1]                # the tile
            black = (bx[:, None] + by[None, :]) % 2 == 1
            dst[..., x0:x0 + tx, y0:y0 + ty] = torch.where(
                black, relax(sv[..., 1:-1, 1:-1], bx % L, by % L),
                sv[..., 2:-2, 2:-2])
    return dst


def _relaxed(old, upd, omega):
    return upd if omega == 1.0 else old + omega * (upd - old)


def _dense_relax(D, Dinv, r, omega):
    """-D0inv (sum_{mu != 0} D_mu phi(x + mu) - r), relaxed by omega."""
    def relax(v, gx, gy):
        X, Y = gx[:, None], gy[None, :]
        nbrs = (v[..., 2:, 1:-1], v[..., :-2, 1:-1],   # +x, -x
                v[..., 1:-1, 2:], v[..., 1:-1, :-2])   # +y, -y
        a = -r[..., X, Y]
        for d, w in enumerate(nbrs, start=1):
            Dd = D[..., d, :, :, :, :][..., X, Y]
            a = a + (Dd * w.unsqueeze(-4)).sum(-3)
        upd = -(Dinv[..., X, Y] * a.unsqueeze(-4)).sum(-3)
        return _relaxed(v[..., 1:-1, 1:-1], upd, omega)
    return relax


def _links_relax(U, m, r, omega):
    """(r - hop_U(phi)) / (2 + m), relaxed by omega (csrc/cplx.cuh
    wilson_hop_core)."""
    L = U.shape[-1]

    def relax(v, gx, gy):
        X, Y = gx[:, None], gy[None, :]
        xp, xm = v[..., 2:, 1:-1], v[..., :-2, 1:-1]
        yp, ym = v[..., 1:-1, 2:], v[..., 1:-1, :-2]
        ha = U[0][X, Y] * (xp[0] - xp[1])
        hb = U[0][((gx - 1) % L)[:, None], Y].conj() * (xm[0] + xm[1])
        hc = U[1][X, Y] * (yp[0] + 1j * yp[1])
        hd = U[1][X, ((gy - 1) % L)[None, :]].conj() * (ym[0] - 1j * ym[1])
        hop = torch.stack([0.5 * (ha + hb + hc + hd),
                           0.5 * ((hb - ha) + 1j * (hd - hc))])
        return _relaxed(v[..., 1:-1, 1:-1], (r[:, X, Y] - hop) / (2.0 + m),
                        omega)
    return relax


@pytest.mark.parametrize("omega", [1.0, 0.8])
@pytest.mark.parametrize("form", ["n=1", "n=2 k=2 shared", "n=4 batch 2",
                                  "links"])
@pytest.mark.parametrize("tile", [(3, 5), (4, 4), (6, 12), (16, 32)])
@pytest.mark.parametrize("L", [8, 12])
def test_fused_red_black_pass_matches_the_plain_sweeps(L, tile, form, omega):
    """Two sweeps of the torch mirror of the fused pass equal two plain
    red-black sweeps (smoothers.smooth_plain, gauge_stencil.smooth_u) in
    complex128 to 1e-12: ragged tiles, a halo that wraps onto the tile's
    own sites (a tile past the lattice), shared and batched operands."""
    rng = np.random.default_rng(29)
    if form == "links":
        m = -0.005
        U = t_of(np.exp(1j * phases(rng, L)))
        phi, r = t_of(crandn(rng, (2, L, L))), t_of(crandn(rng, (2, L, L)))
        relax = _links_relax(U, m, r, omega)
        want = tgs.smooth_u("wilson", U, m, phi, r, 2, "rbgs", omega)
    else:
        n = int(form[2])
        B = 2 if "2" in form[3:] else None
        nb = 2 if "batch" in form else 1
        D = 0.25 * t_of(crandn(rng, (nb, 5, n, n, L, L)))
        D[:, 0] += 4.0 * torch.eye(n, dtype=D.dtype)[:, :, None, None]
        Dinv = tst.site_inverse(D[:, 0])
        if nb == 1:
            D, Dinv = D[0], Dinv[0]
        lead = () if B is None else (B,)
        phi = t_of(crandn(rng, lead + (n, L, L)))
        r = t_of(crandn(rng, (lead if nb == 2 else ()) + (n, L, L)))
        relax = _dense_relax(D, Dinv, r, omega)
        want = tsm.smooth_plain(D, Dinv, phi, r, 2, "rbgs", omega)
    keep = phi.clone()
    got = _fused_rb_sweep(relax, _fused_rb_sweep(relax, phi, *tile), *tile)
    assert torch.equal(phi, keep)
    assert rel_err(got, want) < 1e-12
