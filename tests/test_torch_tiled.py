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


# ---- the column march: two red-black sweeps a launch (rb_plan)


def _march_pass(relax_row, src, S, W):
    """Two red-black sweeps as dense_rb_tiled_kernel<..., 2> (csrc/
    stencil_tiled.cu dense_rb_march) computes them, out of place: a block a
    strip of W columns and a segment of S rows (the last of each ragged),
    its window the strip and 4 columns either side; at march step t, for t
    from 3 rows before the segment to 6 after it, four stages run together
    on the values the step starts from: sweep 1's reds on row t (window
    columns 1 .. C - 2), its blacks on t - 2 (2 .. C - 3), sweep 2's reds on
    t - 4 (3 .. C - 4), its blacks on t - 6 (the strip), each where its row
    lies within the segment and 3 - k rows of it. relax_row(win, i, x, js,
    cols) is the update of the sites at lattice row x and window columns js
    from the window rows i - 1 .. i + 1 of win [..., rows, n, C]."""
    L = src.shape[-1]
    dst = torch.full_like(src, float("nan"))
    for y0 in range(0, L, W):
        w = min(W, L - y0)
        C = w + 8
        cols = (torch.arange(C) + y0 - 4) % L
        for xa in range(0, L, S):
            xb = min(xa + S, L)
            rows = torch.arange(xa - 4, xb + 4) % L   # march rows
            win = src[..., rows[:, None], cols[None, :]].movedim(-3, -2)
            win = win.clone()
            for t in range(xa - 3, xb + 6):
                start = win.clone()                   # the step's values
                for k in range(4):
                    row = t - 2 * k
                    if not xa - 3 + k <= row < xb + 3 - k:
                        continue
                    i = row - (xa - 4)
                    x = int(rows[i])
                    js = torch.arange(k + 1, C - 1 - k)
                    js = js[(x + y0 - 4 + js) % 2 == k % 2]
                    win.select(-3, i)[..., js] = relax_row(start, i, x, js,
                                                           cols)
            out = win[..., 4:4 + xb - xa, :, 4:4 + w].movedim(-2, -3)
            dst[..., xa:xb, y0:y0 + w] = out
    return dst


def _dense_relax_row(D, Dinv, r, omega):
    """dense_relax at the window columns js of window row i (lattice row x,
    window column j at lattice column cols[j]): -D0inv (sum_{mu != 0} D_mu
    phi(x + mu) - r), relaxed by omega."""
    def relax(win, i, x, js, cols):
        Y = cols[js]
        row = win.select(-3, i)
        nbrs = (win.select(-3, i + 1)[..., js],                  # +x
                win.select(-3, i - 1)[..., js],                  # -x
                row[..., js + 1], row[..., js - 1])              # +y, -y
        a = -r[..., x, Y]
        for d, v in enumerate(nbrs, start=1):
            Dd = D.select(-5, d)[..., x, Y]
            a = a + (Dd * v.unsqueeze(-3)).sum(-2)
        upd = -(Dinv[..., x, Y] * a.unsqueeze(-3)).sum(-2)
        return _relaxed(row[..., js], upd, omega)
    return relax


@pytest.mark.parametrize("omega", [1.0, 0.8])
@pytest.mark.parametrize("form", ["n=1", "n=2 batch 2", "n=4",
                                  "n=4 batch 2 shared r"])
@pytest.mark.parametrize("L,S,W", [(8, 1, 2), (12, 5, 4), (12, 12, 12),
                                   (20, 7, 6), (16, 3, 10)])
def test_column_march_matches_two_plain_sweeps(L, S, W, form, omega):
    """The torch mirror of the column march equals two plain red-black
    sweeps (smoothers.smooth_plain) in complex128 to 1e-12: ragged strips
    and segments, a window wider than the lattice (its columns wrap onto
    the strip's own), a segment of one row, batched fields with shared or
    batched operands."""
    rng = np.random.default_rng(31)
    n = int(form[2])
    B = 2 if "batch" in form else None
    lead = () if B is None else (B,)
    D = 0.25 * t_of(crandn(rng, lead + (5, n, n, L, L)))
    D[..., 0, :, :, :, :] += 4.0 * torch.eye(n, dtype=D.dtype)[:, :, None,
                                                               None]
    Dinv = tst.site_inverse(D[..., 0, :, :, :, :])
    phi = t_of(crandn(rng, lead + (n, L, L)))
    r = t_of(crandn(rng, ((n, L, L) if "shared" in form or B is None
                          else lead + (n, L, L))))
    relax = _dense_relax_row(D, Dinv, r, omega)
    keep = phi.clone()
    got = _march_pass(relax, phi, S, W)
    assert torch.equal(phi, keep)
    want = tsm.smooth_plain(D, Dinv, phi, r, 2, "rbgs", omega)
    assert rel_err(got, want) < 1e-12


def _rb_plan(n_sweeps, n=4, L=1024, B=1, G=1, itemsize=8, sms=132,
             aligned=True):
    return cs.rb_plan(n_sweeps, n, L, B, G, itemsize, sms, aligned)


@pytest.mark.parametrize("n_sweeps,passes", [
    (0, ()), (1, (1,)), (2, (2,)), (3, (2, 1)), (4, (2, 2)),
    (5, (2, 2, 1)), (8, (2, 2, 2, 2))])
def test_rb_plan_pairs_the_sweeps(n_sweeps, passes):
    """A march pass a pair of sweeps; an odd count ends with one launch of
    the one-pass kernel."""
    plan = _rb_plan(n_sweeps)
    assert plan.passes == passes and sum(plan.passes) == n_sweeps
    if 2 in passes:
        assert (plan.rows, plan.cols) == (342, 24)


@pytest.mark.parametrize("why,kw", [
    ("complex128", {"itemsize": 16}), ("groups of candidates", {"G": 2}),
    ("an unaligned operand", {"aligned": False}), ("odd L", {"L": 1023}),
    ("n=3", {"n": 3}), ("operands within the L2", {"L": 256}),
    ("n=2 operands within the L2", {"n": 2, "L": 512})])
def test_rb_plan_keeps_the_one_pass_kernel(why, kw):
    """Shapes the march does not take run a launch a sweep: complex128,
    G > 1 (the setup's candidates sharing D), an operand off a 16-byte
    line, an odd lattice, n outside {1, 2, 4}, and a lattice whose sweep
    operands (5n^2 + n words a site) fit the L2."""
    for n_sweeps in (1, 2, 3, 4):
        plan = _rb_plan(n_sweeps, **kw)
        assert plan.passes == (1,) * n_sweeps, why
        assert plan.rows == plan.cols == plan.smem_bytes == 0


def test_rb_plan_at_the_large_flagships_levels():
    """Levels 1-3 of the large flagship (n=4 complex64 at 1024, 512, 256):
    strips of 24 columns whose grid fills the card's 132 SMs at 1024 and
    512, one block an SM (over 114 KB of shared memory); 256, whose
    operands fit the L2, keeps the one-pass kernel."""
    for L, rows, cols in ((1024, 342, 24), (512, 86, 24)):
        plan = _rb_plan(4, L=L)
        assert (plan.rows, plan.cols) == (rows, cols)
        blocks = -(-L // cols) * -(-L // rows)
        assert 129 <= blocks <= 132 and plan.smem_bytes > 114 * 1024
    assert _rb_plan(4, L=256).passes == (1, 1, 1, 1)
    assert cs.march_pitch(4, 24) == 34
    assert cs.march_smem_bytes(4, 24, 8) == 223040


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("sms", [132, 114, 7, 1])
def test_rb_plan_fits_and_covers_the_lattice(monkeypatch, n, sms):
    """Every plan's block fits the shared memory of a block and a thread's
    copies a step, its pitch keeps the word planes of a site's components
    on different bank halves, and its strips and segments cover each site
    once; the grid is one wave wherever a strip a block does not outnumber
    the SMs. (The L2 is taken as empty, so that small lattices plan a
    march.)"""
    monkeypatch.setattr(cs, "L2_BYTES", 0)
    cs.rb_plan.cache_clear()
    try:
        for L in (2, 8, 20, 256, 512, 1000, 1024, 2048):
            for B in (1, 2, 3):
                plan = _rb_plan(4, n=n, L=L, B=B, sms=sms)
                assert plan.passes == (2, 2)
                assert plan.smem_bytes == cs.march_smem_bytes(n, plan.cols, 8)
                assert plan.smem_bytes <= cs.SMEM_BLOCK_MAX
                assert (5 * n * n + 2 * n) * (plan.cols // 2 + 4) <= (
                    cs.MARCH_COPIES * cs.MARCH_THREADS)
                pitch = cs.march_pitch(n, plan.cols)
                assert pitch >= plan.cols + 8 and pitch % 2 == 0
                assert n == 1 or (n * pitch) % 16 == 8
                assert plan.cols % 2 == 0 and 2 <= plan.cols <= L
                assert 1 <= plan.rows <= L
                hits = torch.zeros(L, L, dtype=torch.int64)
                for y0 in range(0, L, plan.cols):
                    for x0 in range(0, L, plan.rows):
                        hits[x0:x0 + plan.rows, y0:y0 + plan.cols] += 1
                assert bool((hits == 1).all())
                blocks = -(-L // plan.cols) * -(-L // plan.rows) * B
                if -(-L // plan.cols) * B <= sms:
                    assert blocks <= sms, (L, B, plan)
    finally:
        cs.rb_plan.cache_clear()


def test_the_march_counts_its_sweeps(monkeypatch):
    """dense_smooth_tiled on a mocked launch (the L2 taken as empty): 5
    red-black sweeps make two march passes (rb=2, the plan's segment rows
    and strip columns) and one one-pass launch (rb=1, rb_tile), ping-pong
    out of place, counted in rb_sweeps as 4 multi and 1 one; an explicit
    tile, Jacobi and G > 1 make a launch a sweep; reset_launches clears
    the counts."""
    calls = []

    def launch(name, dtype, device, D, Dinv, src, r, dst, *args):
        calls.append((src, dst) + args[-4:-3] + args[-2:])
        cs.launches[name] += 1

    monkeypatch.setattr(cs, "_launch", launch)
    monkeypatch.setattr(cs, "_on_card", lambda name, t: None)
    monkeypatch.setattr(cs, "_sm_count", lambda device: 132)
    monkeypatch.setattr(cs, "L2_BYTES", 0)
    cs.rb_plan.cache_clear()
    rng = np.random.default_rng(32)
    n, L = 4, 32
    D = t_of(crandn(rng, (5, n, n, L, L))).to(torch.complex64)
    Dinv = D[0].clone()
    phi = t_of(crandn(rng, (n, L, L))).to(torch.complex64)
    try:
        cs.reset_launches()
        cs.dense_smooth_tiled(D, Dinv, phi, phi.clone(), 5)
        plan = cs.rb_plan(5, n, L, 1, 1, 8, 132)
        assert plan.rows and plan.cols
        assert [c[2:] for c in calls] == [
            (2, plan.rows, plan.cols), (2, plan.rows, plan.cols),
            (1,) + cs.rb_tile(L, n, 8)]
        assert calls[0][0] == phi.data_ptr()
        assert calls[1][0] == calls[0][1] and calls[2][0] == calls[1][1]
        assert cs.rb_sweeps == {"multi": 4, "one": 1}
        assert cs.launches["dense_update_tiled"] == 3
        for kw in ({"tile": (12, 32)}, {"kind": "jacobi"}):
            calls.clear()
            cs.reset_launches()
            cs.dense_smooth_tiled(D, Dinv, phi, phi.clone(), 4, **kw)
            assert len(calls) == 4
            assert cs.rb_sweeps == ({"multi": 0, "one": 4} if "tile" in kw
                                    else {"multi": 0, "one": 0})
        calls.clear()
        cs.reset_launches()
        grouped = phi.expand(3, 2, n, L, L).contiguous()
        cs.dense_smooth_tiled(D.expand(3, *D.shape).contiguous(),
                              Dinv.expand(3, *Dinv.shape).contiguous(),
                              grouped, phi.clone(), 4)
        assert [c[2] for c in calls] == [1] * 4
        assert cs.rb_sweeps == {"multi": 0, "one": 4}
        cs.reset_launches()
        assert cs.rb_sweeps == {"multi": 0, "one": 0}
    finally:
        cs.rb_plan.cache_clear()
