"""The port's CUDA kernels (global and x-tiled) against their plain torch
versions, on the card.

Marked `cuda`: without a CUDA device every test skips (the decision is
taken inside the fixture). This file imports no jax, so it runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import functools

import numpy as np
import pytest
import torch

from tpu_multigrid_torch.ops import cuda_stencil as cs
from tpu_multigrid_torch.ops import dispatch
from tpu_multigrid_torch.ops import gauge_stencil as gs
from tpu_multigrid_torch.ops import smoothers as sm
from tpu_multigrid_torch.ops.stencil import site_inverse

pytestmark = pytest.mark.cuda

BARS = {torch.complex64: 2e-5, torch.complex128: 1e-12}
DTYPES = [torch.complex64, torch.complex128]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _c(rng, shape, dtype, dev):
    a = rng.normal(size=shape) + 1j * rng.normal(size=shape)
    return torch.from_numpy(a).to(device=dev, dtype=dtype)


def _links(rng, L, dtype, dev):
    return torch.from_numpy(np.exp(0.2j * rng.normal(size=(2, L, L)))).to(
        device=dev, dtype=dtype)


def _dense(rng, B, n, L, dtype, dev):
    D = 0.25 * _c(rng, (B, 5, n, n, L, L), dtype, dev)
    D[:, 0] += 4.0 * torch.eye(n, dtype=dtype, device=dev)[:, :, None, None]
    return D, site_inverse(D[:, 0])


def _rel(a, b):
    torch.cuda.synchronize()
    return float((a - b).abs().max() / b.abs().max())


def _tiled_launches(D, Dinv, phi, r, n_sweeps, kind="rbgs", tile=None):
    """dense_update_tiled launches of a dense_smooth_tiled call: rb_plan's
    passes for red-black on the default tile, else a launch a sweep."""
    if kind != "rbgs" or tile is not None:
        return n_sweeps
    dims = cs._dense_operands("x", D, Dinv, phi, r, kind)
    return len(cs.rb_plan(n_sweeps, dims.n, dims.L, dims.B, dims.G,
                          phi.element_size(), cs._sm_count(phi.device),
                          cs.aligned(D, Dinv, phi, r)).passes)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L", [8, 10, 256, 512])
def test_links_residual(dev, dtype, L):
    """B2 (a pair of sites a thread) up to L=512, the largest lattice whose
    residual takes the global kernel (u_mode)."""
    rng = np.random.default_rng(1)
    U = _links(rng, L, dtype, dev)
    phi, r = _c(rng, (2, L, L), dtype, dev), _c(rng, (2, L, L), dtype, dev)
    n0 = cs.launches["links_residual"]
    got = cs.wilson_u_residual(U, -0.005, phi, r)
    assert cs.launches["links_residual"] == n0 + 1
    want = gs.residual_u("wilson", U, -0.005, phi, r)
    assert _rel(got, want) < BARS[dtype]


def _sweep_by_sweep(fn, phi, n_sweeps):
    """n_sweeps calls of one sweep each: the first design's launch boundary
    after every sweep (it made one launch per Jacobi sweep or red/black
    half-sweep, with the same arithmetic per site)."""
    for _ in range(n_sweeps):
        phi = fn(phi, 1)
    return phi


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,omega", [("rbgs", 1.0), ("jacobi", 1.0),
                                        ("rbgs", 0.8), ("jacobi", 0.8)])
@pytest.mark.parametrize("L", [8, 256])
def test_links_smooth(dev, dtype, kind, omega, L):
    """One cooperative launch per call, for 1, 3 and 4 sweeps; the caller's
    phi untouched; the plain version's result, and the sweep-by-sweep
    launches' to rounding."""
    rng = np.random.default_rng(2)
    U = _links(rng, L, dtype, dev)
    phi, r = _c(rng, (2, L, L), dtype, dev), _c(rng, (2, L, L), dtype, dev)
    keep = phi.clone()

    def smooth(p, k):
        return cs.wilson_u_smooth(U, -0.005, p, r, k, kind, omega)

    for n_sweeps in (1, 3, 4):
        n0 = cs.launches["links_update"]
        got = smooth(phi, n_sweeps)
        assert cs.launches["links_update"] == n0 + 1
        assert torch.equal(phi, keep)        # the input is not overwritten
        want = gs.smooth_u("wilson", U, -0.005, phi, r, n_sweeps, kind, omega)
        assert _rel(got, want) < BARS[dtype]
        assert _rel(got, _sweep_by_sweep(smooth, phi, n_sweeps)) < BARS[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["rbgs", "jacobi"])
@pytest.mark.parametrize("n,B,L,shared", [
    (4, None, 128, False), (4, None, 64, False), (4, 4, 32, False),
    (2, 2, 256, True), (4, 2, 128, True), (1, 3, 16, False), (2, None, 8, False),
    (4, None, 1024, False),
])
def test_dense_smooth(dev, dtype, kind, n, B, L, shared):
    """The flagship's coarse levels (n=4 at 128 and 64), its NTL copies
    (batch 4, each its own D) and its setup relaxation (k=2 candidates
    sharing D, n=2 at 256 and n=4 at 128), plus n=1, a lattice with fewer
    x-rows than blocks (L=8) and one whose band cannot be staged (L=1024,
    streamed operands): one cooperative launch per call, for 1, 3 and 4
    sweeps and omega 1 and 0.8; the plain version's result, and the
    sweep-by-sweep launches' to rounding."""
    rng = np.random.default_rng(3)
    nb = 1 if (B is None or shared) else B
    D, Dinv = _dense(rng, nb, n, L, dtype, dev)
    if B is None or shared:
        D, Dinv = D[0], Dinv[0]
    lead = () if B is None else (B,)
    phi = _c(rng, lead + (n, L, L), dtype, dev)
    r = _c(rng, (n, L, L) if shared else lead + (n, L, L), dtype, dev)
    keep = phi.clone()
    for n_sweeps, omega in ((4, 1.0), (1, 1.0), (3, 0.8)):
        def smooth(p, k):
            return cs.dense_smooth(D, Dinv, p, r, k, kind, omega)

        n0 = cs.launches["dense_update"]
        got = smooth(phi, n_sweeps)
        assert cs.launches["dense_update"] == n0 + 1
        assert torch.equal(phi, keep)
        want = sm.smooth_plain(D, Dinv, phi, r, n_sweeps, kind, omega)
        assert _rel(got, want) < BARS[dtype]
        assert _rel(got, _sweep_by_sweep(smooth, phi, n_sweeps)) < BARS[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_persistent_smoothers_stage_by_shape(dev, dtype):
    """plan_band on the card: the flagship's bands are staged (level 1
    even in complex128, one 172 KB row a block), the L=1024 level and
    complex128 setup at n=2 L=256 stream; every grid is co-resident, and
    the launches are counted by mode."""
    size = torch.empty((), dtype=dtype).element_size()
    for name, n, B, L, staged in (
            ("links_update", 2, 1, 256, True),
            ("dense_update", 4, 1, 128, True),
            ("dense_update", 4, 1, 64, True),
            ("dense_update", 4, 4, 32, True),
            ("dense_update", 4, 1, 1024, False),
            ("dense_update", 2, 2, 256, size == 8)):
        band = cs._band(name, dtype, n, B, L, dev)
        assert band.staged == staged, (name, n, B, L, band)
        assert band.grid * band.rows >= B * L > (band.grid - 1) * band.rows
    rng = np.random.default_rng(14)
    D, Dinv = _dense(rng, 1, 4, 1024, dtype, dev)
    phi = _c(rng, (4, 1024, 1024), dtype, dev)
    before = {k: dict(v) for k, v in cs.band_launches.items()}
    cs.dense_smooth(D[0], Dinv[0], phi, phi, 1, "rbgs")
    cs.dense_smooth(D[0, :, :, :, :128, :128].contiguous(),
                    Dinv[0, :, :, :128, :128].contiguous(),
                    phi[:, :128, :128].contiguous(),
                    phi[:, :128, :128].contiguous(), 1, "rbgs")
    got = cs.band_launches["dense_update"]
    assert got["streamed"] == before["dense_update"]["streamed"] + 1
    assert got["staged"] == before["dense_update"]["staged"] + 1


def test_refused_cooperative_launch_raises(dev, monkeypatch):
    """A band asking for more shared memory than a block may have: the
    card refuses the launch, the wrapper raises and counts nothing."""
    rng = np.random.default_rng(15)
    U = _links(rng, 64, torch.complex64, dev)
    phi = _c(rng, (2, 64, 64), torch.complex64, dev)
    D, Dinv = _dense(rng, 1, 4, 64, torch.complex64, dev)
    v = _c(rng, (4, 64, 64), torch.complex64, dev)
    too_big = cs.Band(rows=1, grid=64, staged=True,
                      smem_bytes=4 * cs.SMEM_BLOCK_MAX)
    monkeypatch.setattr(cs, "_band", lambda *a: too_big)
    n0 = dict(cs.launches)
    with pytest.raises(RuntimeError, match="launch failed"):
        cs.wilson_u_smooth(U, 0.1, phi, phi, 2, "rbgs")
    with pytest.raises(RuntimeError, match="launch failed"):
        cs.dense_smooth(D[0], Dinv[0], v, v, 2, "jacobi")
    assert cs.launches == n0
    torch.cuda.synchronize()               # no error left behind
    assert _rel(cs.wilson_u_residual(U, 0.1, phi, phi),
                gs.residual_u("wilson", U, 0.1, phi, phi)) < 2e-5


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(4)
    L = 8
    U = _links(rng, L, torch.complex64, dev)
    phi = _c(rng, (2, L, L), torch.complex64, dev)
    with pytest.raises(ValueError):
        cs.wilson_u_residual(U, 0.1, phi.transpose(-1, -2), phi)
    with pytest.raises(TypeError):
        cs.wilson_u_residual(U, 0.1, phi, phi.to(torch.complex128))
    with pytest.raises(ValueError):
        cs.wilson_u_residual(U, 0.1, phi, phi.cpu())
    with pytest.raises(ValueError):
        odd = phi[:, :7, :7].contiguous()
        cs.wilson_u_smooth(U[:, :7, :7].contiguous(), 0.1, odd, odd, 1, "rbgs")
    with pytest.raises(TypeError):
        re = phi.real.contiguous()
        cs.wilson_u_residual(U.real.contiguous(), 0.1, re, re)
    n0 = cs.launches["links_residual_norm"]
    with pytest.raises(ValueError):
        cs.wilson_u_residual_norm(U, 0.1, phi.transpose(-1, -2), phi)
    with pytest.raises(TypeError):
        cs.wilson_u_residual_norm(U, 0.1, phi, phi.to(torch.complex128))
    with pytest.raises(ValueError):
        cs.wilson_u_residual_norm(U, 0.1, phi, phi.cpu())
    assert cs.launches["links_residual_norm"] == n0
    D, Dinv = _dense(rng, 1, 3, L, torch.complex64, dev)
    with pytest.raises(ValueError):
        cs.dense_smooth(D[0], Dinv[0], _c(rng, (3, L, L), torch.complex64, dev),
                        _c(rng, (3, L, L), torch.complex64, dev), 1, "rbgs")


# ---- B8 and B2 redesigned (a pair of sites a thread) and the level-0 check


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", [1, 3, 8])
@pytest.mark.parametrize("shared_r", [False, True])
def test_links_residual_batch(dev, dtype, B, shared_r):
    """B2 on phi [B, 2, 256, 256] with r shared or batched (one entry a
    block): one launch, the plain version's result, each entry its own
    unbatched call's."""
    rng = np.random.default_rng(60 + B)
    L = 256
    U = _links(rng, L, dtype, dev)
    phi = _c(rng, (B, 2, L, L), dtype, dev)
    r = _c(rng, (2, L, L) if shared_r else (B, 2, L, L), dtype, dev)
    n0 = cs.launches["links_residual"]
    got = cs.wilson_u_residual(U, -0.005, phi, r)
    assert cs.launches["links_residual"] == n0 + 1
    assert _rel(got, gs.residual_u("wilson", U, -0.005, phi, r)) < BARS[dtype]
    for i in range(B):
        one = cs.wilson_u_residual(U, -0.005, phi[i], r if shared_r else r[i])
        assert _rel(got[i], one) < BARS[dtype]


def _off_line(rng, shape, dtype, dev):
    """A contiguous view one complex word past a 16-byte line: in complex64
    off the line, in complex128 still on it."""
    n = int(np.prod(shape))
    return _c(rng, (n + 1,), dtype, dev)[1:].view(shape)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,view", [(9, False), (255, False), (8, True),
                                    (256, True)])
def test_links_kernels_take_odd_and_unaligned(dev, dtype, L, view):
    """An odd lattice and an operand off a 16-byte line take the word-a-load
    path (not PAIRED) of the apply and the residual, and the check (a word
    a load always) takes them too: no refusal, the plain versions'
    results."""
    rng = np.random.default_rng(61)
    U = _links(rng, L, dtype, dev)
    mk = _off_line if view else _c
    phi, r = mk(rng, (2, L, L), dtype, dev), mk(rng, (2, L, L), dtype, dev)
    assert cs._links_paired(U, phi, r) == (view and dtype == torch.complex128)
    assert _rel(cs.wilson_u_apply(U, 0.1, phi),
                gs.apply_wilson_u(U, 0.1, phi)) < BARS[dtype]
    assert _rel(cs.wilson_u_residual(U, 0.1, phi, r),
                gs.residual_u("wilson", U, 0.1, phi, r)) < BARS[dtype]
    assert _rel(cs.wilson_u_residual_norm(U, 0.1, phi, r),
                gs.residual_norm_ratio_u("wilson", U, 0.1, phi, r)
                ) < BARS[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,B,shared_b", [
    (8, None, False), (10, None, False), (256, None, False),
    (512, None, False), (256, 3, False), (256, 8, False), (256, 8, True),
    (32, 3, True)])
def test_links_residual_norm(dev, dtype, L, B, shared_b):
    """The check in one launch a call: ||b - D_U phi|| / ||b|| in b's real
    dtype (0-d unbatched, [B] batched) against the plain composition, and
    the same bits over 3 calls."""
    rng = np.random.default_rng(62)
    U = _links(rng, L, dtype, dev)
    lead = () if B is None else (B,)
    phi = _c(rng, lead + (2, L, L), dtype, dev)
    b = _c(rng, (2, L, L) if shared_b else lead + (2, L, L), dtype, dev)
    want = gs.residual_norm_ratio_u("wilson", U, -0.005, phi, b)
    got = []
    for _ in range(3):
        n0 = cs.launches["links_residual_norm"]
        got.append(cs.wilson_u_residual_norm(U, -0.005, phi, b))
        assert cs.launches["links_residual_norm"] == n0 + 1
    assert got[0].dtype == want.dtype and got[0].shape == want.shape
    assert _rel(got[0], want) < BARS[dtype]
    assert all(torch.equal(g, got[0]) for g in got[1:])


# ---- a batch of right-hand sides on shared links (B1, B2, B5a, B5b)

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,L,shared_r", [(3, 8, False), (8, 256, False),
                                          (3, 256, True), (8, 8, True)])
@pytest.mark.parametrize("tiled", [False, True])
def test_batched_links(dev, dtype, B, L, shared_r, tiled):
    """phi [B, 2, L, L] on the links U [2, L, L], r batched or shared: one
    launch a call (the x-tiled smoother: one a sweep) for the whole batch;
    the plain version's result, and each entry its own unbatched call's,
    to rounding; the caller's phi untouched."""
    rng = np.random.default_rng(40 + B + L)
    U = _links(rng, L, dtype, dev)
    phi = _c(rng, (B, 2, L, L), dtype, dev)
    r = _c(rng, (2, L, L) if shared_r else (B, 2, L, L), dtype, dev)
    keep = phi.clone()
    tile = ((3, 5) if L == 8 else (6, 12)) if tiled else None
    if tiled:
        res = lambda p, q: cs.wilson_u_residual_tiled(U, -0.005, p, q,
                                                      tile=tile)
        upd = lambda p, q, *a: cs.wilson_u_smooth_tiled(U, -0.005, p, q, *a,
                                                        tile=tile)
        kr, ku = "links_residual_tiled", "links_update_tiled"
    else:
        res = lambda p, q: cs.wilson_u_residual(U, -0.005, p, q)
        upd = lambda p, q, *a: cs.wilson_u_smooth(U, -0.005, p, q, *a)
        kr, ku = "links_residual", "links_update"

    def r_of(i):
        return r if shared_r else r[i]

    n0 = cs.launches[kr]
    got = res(phi, r)
    assert cs.launches[kr] == n0 + 1
    assert _rel(got, gs.residual_u("wilson", U, -0.005, phi, r)) < BARS[dtype]
    for i in range(B):
        assert _rel(got[i], res(phi[i], r_of(i))) < BARS[dtype]
    for kind, omega, sweeps in (("rbgs", 1.0, 1), ("rbgs", 0.8, 3),
                                ("jacobi", 1.0, 3), ("jacobi", 0.8, 4)):
        n0 = cs.launches[ku]
        got = upd(phi, r, sweeps, kind, omega)
        assert cs.launches[ku] == n0 + (sweeps if tiled else 1)
        assert torch.equal(phi, keep)
        want = gs.smooth_u("wilson", U, -0.005, phi, r, sweeps, kind, omega)
        assert _rel(got, want) < BARS[dtype]
        for i in range(B):
            one = upd(phi[i], r_of(i), sweeps, kind, omega)
            assert _rel(got[i], one) < BARS[dtype]


def test_batched_links_refuse_what_the_kernels_do_not_take(dev):
    """Links with a batch axis, an r whose batch is not phi's, a
    non-contiguous batch: a ValueError, and no launch."""
    rng = np.random.default_rng(46)
    L = 8
    U = _links(rng, L, torch.complex64, dev)
    phi = _c(rng, (3, 2, L, L), torch.complex64, dev)
    n0 = dict(cs.launches)
    for fn in (cs.wilson_u_residual, cs.wilson_u_residual_tiled):
        with pytest.raises(ValueError):
            fn(U.expand(3, 2, L, L).contiguous(), 0.1, phi, phi)
        with pytest.raises(ValueError):
            fn(U, 0.1, phi, phi[:2].contiguous())
        with pytest.raises(ValueError):
            fn(U, 0.1, phi.transpose(0, 1).contiguous().transpose(0, 1), phi)
    with pytest.raises(ValueError):
        cs.wilson_u_smooth(U, 0.1, phi, phi[:2].contiguous(), 1, "rbgs")
    with pytest.raises(ValueError):
        cs.wilson_u_smooth_tiled(U, 0.1, phi, phi[:2].contiguous(), 1, "rbgs")
    assert cs.launches == n0


# ---- x-tiled kernels (csrc/stencil_tiled.cu)

# (L, tile): several tiles with the periodic wrap, ragged tiles that do not
# divide L, a tile larger than the lattice, and the default tile.
TILES = [(8, (4, 4)), (32, (8, 8)), (32, (6, 12)), (8, (16, 32)),
         (32, None)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,tile", TILES + [(2048, None)])
def test_links_residual_tiled(dev, dtype, L, tile):
    rng = np.random.default_rng(5)
    U = _links(rng, L, dtype, dev)
    phi, r = _c(rng, (2, L, L), dtype, dev), _c(rng, (2, L, L), dtype, dev)
    n0 = cs.launches["links_residual_tiled"]
    got = cs.wilson_u_residual_tiled(U, -0.005, phi, r, tile=tile)
    assert cs.launches["links_residual_tiled"] == n0 + 1
    want = gs.residual_u("wilson", U, -0.005, phi, r)
    assert _rel(got, want) < BARS[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,omega", [("rbgs", 1.0), ("jacobi", 1.0),
                                        ("rbgs", 0.8), ("jacobi", 0.8)])
@pytest.mark.parametrize("L,tile", TILES + [(2048, None)])
def test_links_smooth_tiled(dev, dtype, kind, omega, L, tile):
    """One launch per sweep (a red-black sweep in one fused pass)."""
    rng = np.random.default_rng(6)
    U = _links(rng, L, dtype, dev)
    phi, r = _c(rng, (2, L, L), dtype, dev), _c(rng, (2, L, L), dtype, dev)
    keep = phi.clone()
    n0 = cs.launches["links_update_tiled"]
    got = cs.wilson_u_smooth_tiled(U, -0.005, phi, r, 4, kind, omega,
                                   tile=tile)
    assert cs.launches["links_update_tiled"] == n0 + 4
    assert torch.equal(phi, keep)
    want = gs.smooth_u("wilson", U, -0.005, phi, r, 4, kind, omega)
    assert _rel(got, want) < BARS[dtype]
    if tile is None:            # the global kernel computes the same
        glob = cs.wilson_u_smooth(U, -0.005, phi, r, 4, kind, omega)
        assert _rel(got, glob) < BARS[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,omega", [("rbgs", 1.0), ("jacobi", 1.0),
                                        ("rbgs", 0.8)])
@pytest.mark.parametrize("n,B,L,shared,tile", [
    (4, None, 1024, False, None),            # level 1 of the large flagship
    (2, 2, 2048, True, None),                # setup at level 0, k=2
    (4, 3, 32, False, (8, 8)),               # batched D, several tiles
    (4, 2, 32, True, (6, 12)),               # shared D, ragged tiles
    (1, 3, 8, False, (4, 4)),
    (2, None, 8, False, (16, 32)),           # one tile past the lattice
])
def test_dense_smooth_tiled(dev, dtype, kind, omega, n, B, L, shared, tile):
    """Batch strides 0 (D, D0inv and r shared by the batch) and full."""
    rng = np.random.default_rng(7)
    nb = 1 if (B is None or shared) else B
    D, Dinv = _dense(rng, nb, n, L, dtype, dev)
    if B is None or shared:
        D, Dinv = D[0], Dinv[0]
    lead = () if B is None else (B,)
    phi = _c(rng, lead + (n, L, L), dtype, dev)
    r = _c(rng, (n, L, L) if shared else lead + (n, L, L), dtype, dev)
    keep = phi.clone()
    n0 = cs.launches["dense_update_tiled"]
    got = cs.dense_smooth_tiled(D, Dinv, phi, r, 4, kind, omega, tile=tile)
    assert cs.launches["dense_update_tiled"] == n0 + _tiled_launches(
        D, Dinv, phi, r, 4, kind, tile)
    assert torch.equal(phi, keep)
    want = sm.smooth_plain(D, Dinv, phi, r, 4, kind, omega)
    assert _rel(got, want) < BARS[dtype]


def _groups(rng, C, G, n, L, dtype, dev, shared_r):
    """C groups of G fields [C, G, n, L, L], each group on its own D and
    D0inv [C, ...]; r shared [n, L, L] or one a field."""
    D, Dinv = _dense(rng, C, n, L, dtype, dev)
    phi = _c(rng, (C, G, n, L, L), dtype, dev)
    r = _c(rng, (n, L, L) if shared_r else (C, G, n, L, L), dtype, dev)
    return D, Dinv, phi, r


def _copied(D, Dinv, phi, r):
    """The same call with every D and D0inv copied for each field of its
    group: a copy an entry (G = 1), fields and r flattened to [C G, ...]."""
    G = phi.shape[1]
    flat = phi.reshape(-1, *phi.shape[2:])
    return (D.repeat_interleave(G, dim=0).contiguous(),
            Dinv.repeat_interleave(G, dim=0).contiguous(), flat,
            r if r.dim() == 3 else r.reshape(flat.shape))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["rbgs", "jacobi"])
@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("tiled", [False, True], ids=["global", "tiled"])
def test_dense_smooth_groups(dev, dtype, kind, n, G, tiled):
    """B3 / B6 with C = 3 groups (an odd C) of G fields, each group on its
    own D and D0inv, on L = 20 (no multiple of the red-black tile's 16 x
    32) and L = 128 (the ensemble's level 0): one launch a call (a sweep
    tiled), counted as grouped where G > 1; the plain version's result (D
    broadcast over its group); the same bits as the call with each D
    copied G times; the caller's phi untouched."""
    rng = np.random.default_rng(15)
    name = "dense_update_tiled" if tiled else "dense_update"
    fn = cs.dense_smooth_tiled if tiled else cs.dense_smooth
    for L, shared_r in ((20, True), (128, False)):
        D, Dinv, phi, r = _groups(rng, 3, G, n, L, dtype, dev, shared_r)
        keep = phi.clone()
        n0, g0 = cs.launches[name], cs.group_launches[name]
        got = fn(D, Dinv, phi, r, 3, kind, 0.9)
        assert cs.launches[name] == n0 + (3 if tiled else 1)
        assert cs.group_launches[name] == g0 + (0 if G == 1 else
                                                3 if tiled else 1)
        assert torch.equal(phi, keep)
        want = sm.smooth_plain(D, Dinv, phi, r, 3, kind, 0.9)
        assert _rel(got, want) < BARS[dtype]
        copied = fn(*_copied(D, Dinv, phi, r), 3, kind, 0.9)
        assert torch.equal(got.reshape(copied.shape), copied)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("staged", [True, False], ids=["staged", "streamed"])
@pytest.mark.parametrize("G,rows", [(2, 3), (4, 7), (4, 1), (3, 5)])
def test_dense_smooth_groups_band_edges(dev, monkeypatch, dtype, staged, G,
                                        rows):
    """B3's bands cut through groups and x rows: a band of `rows` rows that
    is no multiple of G (the rows g = (c L + x) G + m of one (c, x) split
    between two bands) nor divides the B L rows; staged and streamed
    operands; against the plain version and the copied-D launch."""
    rng = np.random.default_rng(16)
    n, L, C = 4, 12, 3
    D, Dinv, phi, r = _groups(rng, C, G, n, L, dtype, dev, False)
    size = phi.element_size()
    total = C * G * L

    def band(name, dt, n_, B, L_, device, G_=1):
        return cs.Band(rows, -(-total // rows), staged,
                       cs.dense_band_bytes(n_, L_, rows, size, G_)
                       if staged else 0)

    monkeypatch.setattr(cs, "_band", band)
    for kind in ("rbgs", "jacobi"):
        got = cs.dense_smooth(D, Dinv, phi, r, 3, kind, 0.9)
        want = sm.smooth_plain(D, Dinv, phi, r, 3, kind, 0.9)
        assert _rel(got, want) < BARS[dtype]
        copied = cs.dense_smooth(*_copied(D, Dinv, phi, r), 3, kind, 0.9)
        assert torch.equal(got.reshape(copied.shape), copied)


def test_dense_smooth_groups_refused(dev):
    """Operators whose copies match neither the groups nor the entries, or
    a third batch axis: ValueError, nothing launched."""
    rng = np.random.default_rng(17)
    D, Dinv, phi, r = _groups(rng, 3, 2, 2, 8, torch.complex64, dev, True)
    n0 = dict(cs.launches)
    for fn in (cs.dense_smooth, cs.dense_smooth_tiled):
        with pytest.raises(ValueError):      # 2 copies for 3 groups
            fn(D[:2], Dinv[:2], phi, r, 1)
        with pytest.raises(ValueError):      # a copy a field: use [C G]
            fn(D.repeat_interleave(2, 0), Dinv.repeat_interleave(2, 0),
               phi, r, 1)
        with pytest.raises(ValueError):      # r batched by group only
            fn(D, Dinv, phi, r.expand(3, -1, -1, -1).contiguous(), 1)
        with pytest.raises(ValueError):
            fn(D, Dinv, phi[None], r, 1)
    assert cs.launches == n0


def test_smooth_dispatches_tiled_past_the_l2(dev):
    """dispatch.smooth on a level past the L2 (n=4, L=256) launches the tiled
    kernel only (once per sweep); on one within it (n=4, L=128) the global
    kernel only (once per call)."""
    rng = np.random.default_rng(8)
    for L, kernel, n in ((256, "dense_update_tiled", 3),
                         (128, "dense_update", 1)):
        D, Dinv = _dense(rng, 1, 4, L, torch.complex64, dev)
        phi = _c(rng, (4, L, L), torch.complex64, dev)
        before = dict(cs.launches)
        dispatch.smooth(D[0], Dinv[0], phi, phi, 3, "rbgs")
        moved = {k: v - before[k] for k, v in cs.launches.items()
                 if v != before[k]}
        assert moved == {kernel: n}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form,L,tile", [
    ("links", 2048, None), ("links", 32, (6, 12)), ("links", 8, (16, 32)),
    ("dense n=4", 1024, None), ("dense n=4", 32, (3, 5)),
    ("dense n=2 k=2", 2048, None), ("dense n=1 batch 3", 8, (16, 32)),
])
def test_fused_red_black_sweep(dev, dtype, form, L, tile):
    """The fused red-black pass (links_rb_tiled_kernel,
    dense_rb_tiled_kernel): 3 sweeps in one call equal 3 calls of one sweep
    (a launch boundary after each) to rounding; one sweep leaves src bit
    for bit unchanged; a sweep with dst == src, or overlapping it, raises
    and launches nothing, in the wrapper and in the C entry."""
    rng = np.random.default_rng(30)
    m, omega = -0.005, 0.8
    if form == "links":
        U = _links(rng, L, dtype, dev)
        phi, r = _c(rng, (2, L, L), dtype, dev), _c(rng, (2, L, L), dtype, dev)
        TX, TY = cs._tile(tile, L)
        name = "links_update_tiled"

        def smooth(p, k):
            return cs.wilson_u_smooth_tiled(U, m, p, r, k, "rbgs", omega,
                                            tile=tile)

        def sweep(src, dst):
            cs._links_sweep(U, m, r, omega, TX, TY, src, dst, 1)

        def raw(src, dst):
            return cs._entry(name, dtype)(
                U.data_ptr(), src.data_ptr(), r.data_ptr(), dst.data_ptr(), 1,
                L, m, omega, 1, 0, TX, TY,
                torch.cuda.current_stream().cuda_stream)
    else:
        n = int(form.split()[1][2:])
        B = 2 if "k=2" in form else 3 if "batch" in form else None
        nb = 3 if B == 3 else 1
        D, Dinv = _dense(rng, nb, n, L, dtype, dev)
        if nb == 1:
            D, Dinv = D[0], Dinv[0]
        lead = () if B is None else (B,)
        phi = _c(rng, lead + (n, L, L), dtype, dev)
        r = _c(rng, (n, L, L) if B != 3 else lead + (n, L, L), dtype, dev)
        TX, TY = cs._tile(tile, L, n, phi.element_size())
        name = "dense_update_tiled"
        dims = cs._dense_operands(name, D, Dinv, phi, r, "rbgs")

        def smooth(p, k):
            return cs.dense_smooth_tiled(D, Dinv, p, r, k, "rbgs", omega,
                                         tile=tile)

        def sweep(src, dst):
            cs._dense_sweep(D, Dinv, r, dims, omega, TX, TY, src, dst, 1)

        def raw(src, dst):
            return cs._entry(name, dtype)(
                D.data_ptr(), Dinv.data_ptr(), src.data_ptr(), r.data_ptr(),
                dst.data_ptr(), *dims.args(), 1, omega, TX, TY,
                torch.cuda.current_stream().cuda_stream)
    keep = phi.clone()
    n0 = cs.launches[name]
    got = smooth(phi, 3)
    assert cs.launches[name] == n0 + (
        3 if form == "links" else _tiled_launches(D, Dinv, phi, r, 3,
                                                  tile=tile))
    assert _rel(got, _sweep_by_sweep(smooth, phi, 3)) < BARS[dtype]
    out = torch.empty_like(phi)
    sweep(phi, out)
    torch.cuda.synchronize()
    assert torch.equal(phi, keep)              # src bit for bit unchanged
    assert torch.equal(out, smooth(phi, 1))
    n0 = cs.launches[name]
    with pytest.raises(ValueError, match="out of place"):
        sweep(phi, phi)
    with pytest.raises(ValueError, match="out of place"):
        sweep(phi, phi.flatten()[1:])
    assert cs.launches[name] == n0
    assert raw(phi, phi) != 0                  # refused by the C entry
    torch.cuda.synchronize()
    assert torch.equal(phi, keep)


# ---- the column march: two red-black sweeps a launch (rb_plan)


@pytest.mark.parametrize("n,L,B,shared_r", [
    (4, 1024, None, True),                   # level 1 of the large flagship
    (4, 512, None, True),                    # level 2
    (4, 1000, 2, False),                     # ragged strips and segments
    (4, 512, 2, True),                       # batched phi, r shared
    (2, 1024, None, True),
    (1, 2048, None, True),
])
def test_dense_march_equals_one_pass_launches(dev, n, L, B, shared_r):
    """dense_smooth_tiled where rb_plan takes the call (complex64, operands
    past the L2): 1 to 5 sweeps in n_sweeps // 2 march passes and
    n_sweeps % 2 one-pass launches, counted in rb_sweeps; the same bits as
    as many calls of one sweep (one-pass launches), omega 1 and 0.8; the
    caller's phi untouched; the plain version's result to the c64 bar."""
    rng = np.random.default_rng(33)
    dtype = torch.complex64
    D, Dinv = _dense(rng, 1, n, L, dtype, dev)
    D, Dinv = D[0], Dinv[0]
    lead = () if B is None else (B,)
    phi = _c(rng, lead + (n, L, L), dtype, dev)
    r = _c(rng, (n, L, L) if shared_r else lead + (n, L, L), dtype, dev)
    keep = phi.clone()
    assert cs.rb_plan(4, n, L, B or 1, 1, 8, cs._sm_count(dev)).passes == (
        2, 2)
    for k, omega in ((1, 0.8), (2, 1.0), (3, 0.8), (4, 1.0), (5, 0.8)):
        def smooth(p, s):
            return cs.dense_smooth_tiled(D, Dinv, p, r, s, "rbgs", omega)

        cs.reset_launches()
        got = smooth(phi, k)
        assert cs.launches["dense_update_tiled"] == k // 2 + k % 2
        assert cs.rb_sweeps == {"multi": 2 * (k // 2), "one": k % 2}
        assert torch.equal(phi, keep)
        assert torch.equal(got, _sweep_by_sweep(smooth, phi, k))
    want = sm.smooth_plain(D, Dinv, phi, r, 4, "rbgs", 0.8)
    got = cs.dense_smooth_tiled(D, Dinv, phi, r, 4, "rbgs", 0.8)
    assert _rel(got, want) < BARS[dtype]


@pytest.mark.parametrize("n,L,rows,cols", [
    (4, 256, 16, 24),                        # level 3's lattice
    (4, 36, 10, 14), (4, 20, 7, 6), (2, 24, 2, 24), (1, 40, 13, 18),
    (4, 8, 1, 2),                            # a window wider than the lattice
])
@pytest.mark.parametrize("batched", [False, True])
def test_dense_march_pass_at_any_geometry(dev, n, L, rows, cols, batched):
    """One march pass (rb=2) on strips of `cols` columns and segments of
    `rows` rows, ragged and wrapping, equals two one-pass launches bit for
    bit, one field or a batch of 2 with D, D0inv and r each its own; src
    is left as it was."""
    rng = np.random.default_rng(34)
    dtype = torch.complex64
    B = 2 if batched else None
    D, Dinv = _dense(rng, B or 1, n, L, dtype, dev)
    if not batched:
        D, Dinv = D[0], Dinv[0]
    lead = () if B is None else (B,)
    phi = _c(rng, lead + (n, L, L), dtype, dev)
    r = _c(rng, lead + (n, L, L), dtype, dev)
    keep = phi.clone()
    dims = cs._dense_operands("x", D, Dinv, phi, r, "rbgs")
    for omega in (1.0, 0.8):
        two = torch.empty_like(phi)
        cs._dense_sweep(D, Dinv, r, dims, omega, rows, cols, phi, two, 2)
        a, b = torch.empty_like(phi), torch.empty_like(phi)
        tile = cs.rb_tile(L, n, 8)
        cs._dense_sweep(D, Dinv, r, dims, omega, *tile, phi, a, 1)
        cs._dense_sweep(D, Dinv, r, dims, omega, *tile, a, b, 1)
        torch.cuda.synchronize()
        assert torch.equal(phi, keep)
        assert torch.equal(two, b)


def test_dense_march_refuses_what_it_does_not_take(dev):
    """The C entry refuses a march pass (rb=2) in complex128, with G > 1,
    on an odd strip width or past the lattice, and on an operand off a
    16-byte line: an error, nothing written."""
    rng = np.random.default_rng(35)
    n, L = 4, 16
    stream = torch.cuda.current_stream().cuda_stream

    def entry(dtype, D, Dinv, phi, r, out, G, TX, TY):
        B = phi.numel() // (n * L * L)
        return cs._entry("dense_update_tiled", dtype)(
            D.data_ptr(), Dinv.data_ptr(), phi.data_ptr(), r.data_ptr(),
            out.data_ptr(), B, n, L, G, 0, 0, 0, 2, 1.0, TX, TY, stream)

    for dtype in DTYPES:
        D, Dinv = _dense(rng, 1, n, L, dtype, dev)
        phi = _c(rng, (2, n, L, L), dtype, dev)
        out = torch.full_like(phi, float("nan"))
        ops = (D[0], Dinv[0], phi, phi[0].clone(), out)
        if dtype == torch.complex128:
            assert entry(dtype, *ops, 1, 4, 8) != 0
            continue
        assert entry(dtype, *ops, 2, 4, 8) != 0          # G > 1
        assert entry(dtype, *ops, 1, 4, 7) != 0          # odd strip
        assert entry(dtype, *ops, 1, 4, L + 2) != 0      # past the lattice
        buf = _c(rng, (n * L * L + 1,), dtype, dev)
        off = buf[1:].view(n, L, L)
        assert entry(dtype, D[0], Dinv[0], off, off, out[0], 1, 4, 8) != 0
        torch.cuda.synchronize()
        assert bool(out.isnan().all())


def test_tiled_wrappers_refuse_what_the_kernels_do_not_take(dev):
    rng = np.random.default_rng(9)
    L = 8
    U = _links(rng, L, torch.complex64, dev)
    phi = _c(rng, (2, L, L), torch.complex64, dev)
    n0 = dict(cs.launches)
    with pytest.raises(ValueError):
        cs.wilson_u_residual_tiled(U, 0.1, phi, phi, tile=(0, 8))
    with pytest.raises(ValueError):
        cs.wilson_u_residual_tiled(U, 0.1, phi.transpose(-1, -2), phi)
    with pytest.raises(TypeError):
        cs.wilson_u_smooth_tiled(U, 0.1, phi, phi.to(torch.complex128), 1)
    for tile in ((17, 32), (16, 33)):       # past the kernel's 16 x 32
        with pytest.raises(ValueError):
            cs.wilson_u_smooth_tiled(U, 0.1, phi, phi, 1, tile=tile)
    with pytest.raises(ValueError):
        odd = phi[:, :7, :7].contiguous()
        cs.wilson_u_smooth_tiled(U[:, :7, :7].contiguous(), 0.1, odd, odd, 1,
                                 "rbgs")
    D, Dinv = _dense(rng, 1, 3, L, torch.complex64, dev)
    with pytest.raises(ValueError):
        cs.dense_smooth_tiled(D[0], Dinv[0],
                              _c(rng, (3, L, L), torch.complex64, dev),
                              _c(rng, (3, L, L), torch.complex64, dev), 1)
    D, Dinv = _dense(rng, 2, 2, L, torch.complex64, dev)
    with pytest.raises(ValueError):         # batch of D does not match phi
        cs.dense_smooth_tiled(D, Dinv, _c(rng, (3, 2, L, L),
                                          torch.complex64, dev),
                              _c(rng, (2, L, L), torch.complex64, dev), 1)
    assert cs.launches == n0


# ---- the SpMV kernels: B7a/B7b (dense apply), B8/B5c (links apply)

from tpu_multigrid_torch.models.operators import assemble_wilson  # noqa: E402
from tpu_multigrid_torch.ops import stencil as st  # noqa: E402


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,L,bd,bv,tile", [
    (2, 256, None, None, None),              # the flagship's level 0
    (4, 32, 4, 4, None),                     # the NTL copies, batched D
    (4, 16, None, 4, None),                  # shared D, batched v (min-res)
    (2, 8, 3, None, None),                   # batched D, shared v
    (1, 8, None, None, None),
    (2, 2048, None, None, "tiled"),          # past the L2
    (4, 1024, None, None, "tiled"),
    (4, 32, 3, 3, (8, 8)),                   # several tiles, periodic wrap
    (2, 32, None, 2, (6, 12)),               # ragged tiles
    (2, 8, 2, None, (16, 32)),               # one tile past the lattice
])
def test_dense_apply(dev, dtype, n, L, bd, bv, tile):
    rng = np.random.default_rng(10)
    D, _ = _dense(rng, bd or 1, n, L, dtype, dev)
    D = D if bd else D[0]
    v = _c(rng, ((bv,) if bv else ()) + (n, L, L), dtype, dev)
    keep = v.clone()
    name = "dense_apply" if tile is None else "dense_apply_tiled"
    n0 = cs.launches[name]
    if tile is None:
        got = cs.dense_apply(D, v)
    else:
        got = cs.dense_apply_tiled(D, v, tile=None if tile == "tiled"
                                   else tile)
    assert cs.launches[name] == n0 + 1
    assert torch.equal(v, keep)
    want = st.apply_D(D, v)
    assert got.shape == want.shape
    assert _rel(got, want) < BARS[dtype]
    if tile == "tiled":                      # the global kernel, same shape
        assert _rel(cs.dense_apply(D, v), want) < BARS[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L,tile", [(256, None), (8, None), (10, None),
                                    (1024, None)] + [
    (L, tile or "tiled") for L, tile in TILES + [(2048, None)]])
def test_links_apply(dev, dtype, L, tile):
    """Against the plain links apply and the dense apply of the assembled
    Wilson stencil."""
    rng = np.random.default_rng(11)
    U = _links(rng, L, dtype, dev)
    v = _c(rng, (2, L, L), dtype, dev)
    name = "links_apply" if tile is None else "links_apply_tiled"
    n0 = cs.launches[name]
    if tile is None:
        got = cs.wilson_u_apply(U, -0.07, v)
    else:
        got = cs.wilson_u_apply_tiled(U, -0.07, v, tile=None if tile ==
                                      "tiled" else tile)
    assert cs.launches[name] == n0 + 1
    assert _rel(got, gs.apply_wilson_u(U, -0.07, v)) < BARS[dtype]
    assert _rel(got, st.apply_D(assemble_wilson(U, -0.07), v)) < BARS[dtype]


def test_apply_dispatches_by_apply_mode(dev):
    """dispatch.apply_D launches the tiled kernel past the L2 (n=2,
    L=2048) and the global one within it (n=2, L=256); so does the links
    apply (L=2048 and L=1024)."""
    rng = np.random.default_rng(12)
    cases = [(dispatch.apply_D, 2048, "dense_apply_tiled"),
             (dispatch.apply_D, 256, "dense_apply")]
    for fn, L, kernel in cases:
        D, _ = _dense(rng, 1, 2, L, torch.complex64, dev)
        v = _c(rng, (2, L, L), torch.complex64, dev)
        before = dict(cs.launches)
        fn(D[0], v)
        moved = {k: c - before[k] for k, c in cs.launches.items()
                 if c != before[k]}
        assert moved == {kernel: 1}
    for L, kernel in ((2048, "links_apply_tiled"), (1024, "links_apply")):
        U = _links(rng, L, torch.complex64, dev)
        before = dict(cs.launches)
        dispatch.links_apply(U, 0.1, _c(rng, (2, L, L), torch.complex64,
                                        dev))
        moved = {k: c - before[k] for k, c in cs.launches.items()
                 if c != before[k]}
        assert moved == {kernel: 1}


def test_apply_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """A wrong dtype, shape, device or layout raises and launches
    nothing."""
    rng = np.random.default_rng(13)
    L = 8
    c64 = torch.complex64
    U = _links(rng, L, c64, dev)
    v = _c(rng, (2, L, L), c64, dev)
    D, _ = _dense(rng, 1, 2, L, c64, dev)
    D = D[0]
    n0 = dict(cs.launches)
    for fn in (cs.wilson_u_apply, cs.wilson_u_apply_tiled):
        with pytest.raises(TypeError):
            fn(U, 0.1, v.to(torch.complex128))
        with pytest.raises(TypeError):
            fn(U.real.contiguous(), 0.1, v.real.contiguous())
        with pytest.raises(ValueError):
            fn(U[:, :4].contiguous(), 0.1, v)
        with pytest.raises(ValueError):
            fn(U.cpu(), 0.1, v)
        with pytest.raises(ValueError):
            fn(U, 0.1, v.transpose(-1, -2))
        with pytest.raises(ValueError):     # the applies take no batch axis
            fn(U, 0.1, v.expand(3, 2, L, L).contiguous())
    for fn in (cs.dense_apply, cs.dense_apply_tiled):
        with pytest.raises(TypeError):
            fn(D, v.to(torch.complex128))
        with pytest.raises(ValueError):
            fn(D.cpu(), v)
        with pytest.raises(ValueError):
            fn(D[:, :, :, :4], v)
        with pytest.raises(ValueError):
            fn(D, v.transpose(-1, -2))
        with pytest.raises(ValueError):              # n=3 has no kernel
            fn(_dense(rng, 1, 3, L, c64, dev)[0][0], _c(rng, (3, L, L), c64,
                                                        dev))
        with pytest.raises(ValueError):              # batches disagree
            fn(_dense(rng, 2, 2, L, c64, dev)[0], _c(rng, (3, 2, L, L), c64,
                                                     dev))
    with pytest.raises(ValueError):
        cs.dense_apply_tiled(D, v, tile=(17, 32))
    assert cs.launches == n0


# ---- B2 fused with its restriction; B7a / B7b residual and groups ----

from tpu_multigrid_torch.ops import transfer as tr  # noqa: E402


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quad", [1, 2, 3, 4])
@pytest.mark.parametrize("L,nc,bx,by,B,shared_r", [
    (256, 4, 2, 2, None, False),            # the flagship's level 0
    (256, 4, 2, 2, 8, False),               # its batch of 8 right-hand sides
    (36, 2, 2, 2, 3, True),                 # ragged: 18 coarse columns
    (68, 1, 4, 4, None, False),             # ragged: 17 x 17 coarse sites
    (24, 4, 4, 2, 2, False),                # bx != by
    (8, 2, 2, 4, None, False),              # a lattice under one block
])
def test_links_residual_restrict(dev, dtype, quad, L, nc, bx, by, B,
                                 shared_r):
    """One launch; the plain composition's result (restrict of the plain
    links residual), every quadrant, ragged coarse tiles, a batch on shared
    links and near-null rows, r shared or batched."""
    rng = np.random.default_rng(60 + L + nc + quad)
    U = _links(rng, L, dtype, dev)
    lead = (B,) if B else ()
    phi = _c(rng, lead + (2, L, L), dtype, dev)
    r = _c(rng, (2, L, L) if shared_r else lead + (2, L, L), dtype, dev)
    pn = _c(rng, (nc, 2, L, L), dtype, dev)
    n0 = dict(cs.launches)
    got = cs.wilson_u_residual_restrict(U, -0.005, phi, r, pn, quad, bx, by)
    assert cs.launches["links_residual_restrict"] == (
        n0["links_residual_restrict"] + 1)
    assert {k: v for k, v in cs.launches.items() if v != n0[k]} == {
        "links_residual_restrict": n0["links_residual_restrict"] + 1}
    want = tr.restrict_plain(pn, gs.residual_u("wilson", U, -0.005, phi, r),
                             quad, bx, by)
    assert got.shape == want.shape == lead + (nc, L // bx, L // by)
    assert _rel(got, want) < BARS[dtype]


def test_links_residual_restrict_refuses(dev):
    """nc = 3, a block of 8, blocks that do not divide L, a phi_null with a
    batch axis, a misaligned or non-contiguous operand: a ValueError (a
    wrong dtype: a TypeError), and no launch."""
    rng = np.random.default_rng(61)
    L, c64 = 16, torch.complex64
    U = _links(rng, L, c64, dev)
    phi, r = _c(rng, (2, L, L), c64, dev), _c(rng, (2, L, L), c64, dev)
    pn = _c(rng, (4, 2, L, L), c64, dev)
    flat = _c(rng, (2 * L * L + 1,), c64, dev)
    odd = flat[1:].view(2, L, L)             # 8 bytes past a 16-byte line
    n0 = dict(cs.launches)

    def call(U=U, phi=phi, r=r, pn=pn, bx=2, by=2, quad=1):
        return cs.wilson_u_residual_restrict(U, 0.1, phi, r, pn, quad, bx, by)

    for kw in (dict(pn=_c(rng, (3, 2, L, L), c64, dev)), dict(bx=8),
               dict(by=1), dict(pn=pn.expand(2, 4, 2, L, L).contiguous()),
               dict(phi=odd), dict(r=odd), dict(phi=phi.transpose(-1, -2)),
               dict(pn=pn[:, :, :8, :8].contiguous())):
        with pytest.raises(ValueError):
            call(**kw)
    with pytest.raises(ValueError):          # 4 does not divide 18
        U18 = _links(rng, 18, c64, dev)
        p18 = _c(rng, (2, 18, 18), c64, dev)
        cs.wilson_u_residual_restrict(U18, 0.1, p18, p18,
                                      _c(rng, (4, 2, 18, 18), c64, dev), 1,
                                      4, 2)
    with pytest.raises(TypeError):
        call(pn=pn.to(torch.complex128))
    assert cs.launches == n0


# ---- the cycle's transfers (csrc/transfer.cu) ----
#
# Bars: BARS. In complex64 a restricted word sums nf bx by (<= 16 here)
# products and a prolonged one nc (<= 6), in another order than the plain
# version's batched gemv; complex128 to the self-test's 1e-12.


def _launched(n0):
    return {k: v - n0[k] for k, v in cs.launches.items() if v != n0[k]}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quad", [1, 2, 3, 4])
@pytest.mark.parametrize("L,nc,nf,bx,by", [
    (2048, 4, 2, 2, 2),                     # the large flagship's level 0
    (1024, 4, 4, 2, 2),                     # its level 1
    (128, 4, 4, 2, 2),                      # the flagship's level 1
    (36, 4, 2, 2, 2),                       # ragged: 18 coarse columns
    (24, 6, 1, 4, 2),                       # nc > 4 rows, bx != by
    (12, 3, 4, 2, 4),
    (9, 2, 2, 3, 1),                        # odd blocks and lattice
])
def test_transfer_kernels(dev, dtype, quad, L, nc, nf, bx, by):
    """restrict, prolong and prolong onto a base: one launch each, the plain
    (einsum) result, every quadrant."""
    rng = np.random.default_rng(70 + L + nc + quad)
    pn = _c(rng, (nc, nf, L, L), dtype, dev)
    vf, base = _c(rng, (nf, L, L), dtype, dev), _c(rng, (nf, L, L), dtype,
                                                    dev)
    vc = _c(rng, (nc, L // bx, L // by), dtype, dev)
    n0 = dict(cs.launches)
    got_r = dispatch.restrict(pn, vf, quad, bx, by)
    got_p = dispatch.prolong(pn, vc, quad, bx, by)
    got_b = dispatch.prolong(pn, vc, quad, bx, by, base=base)
    assert _launched(n0) == {"restrict": 1, "prolong": 2}
    assert _rel(got_r, tr.restrict_plain(pn, vf, quad, bx, by)) < BARS[dtype]
    assert _rel(got_p, tr.prolong_plain(pn, vc, quad, bx, by)) < BARS[dtype]
    assert _rel(got_b, tr.prolong_plain(pn, vc, quad, bx, by,
                                        base)) < BARS[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("form", [
    "a batch of fields", "a batch of hierarchies", "batched phi_null",
    "copies", "copies, a batch of fields", "copies, a batch of hierarchies",
    "unaligned"])
@pytest.mark.parametrize("L,nf", [(64, 4), (128, 2)])
def test_transfer_kernel_batch_forms(dev, dtype, form, L, nf):
    """The batch forms of the cycles, one launch each way: phi_null shared
    by a batch of 3 fields (solve_batched), a batch of hierarchies
    (solve_ensemble), one field on batched near-null rows, the NTL copies
    (copy q at quadrant q + 1; unbatched, a batch of fields, and the
    ensemble's strided view of its copies), and views 8 bytes off a 16-byte
    line; against the plain version."""
    rng = np.random.default_rng(80 + L)
    nc, S = 4, L // 2

    def c(*shape):
        return _c(rng, shape, dtype, dev)

    quad, pn, vf, vc = 1, c(nc, nf, L, L), c(3, nf, L, L), c(3, nc, S, S)
    if form == "a batch of hierarchies":
        pn = c(3, nc, nf, L, L)
    elif form == "batched phi_null":
        pn, vf, vc, quad = c(3, nc, nf, L, L), vf[0], vc[0], 3
    elif form.startswith("copies"):
        quad, vc = None, c(3, 4, nc, S, S)
        pn = c(4, nc, nf, L, L)
        if form == "copies":
            vf, vc = vf[0], vc[0]
        elif form == "copies, a batch of hierarchies":
            pn = c(3, 5, nc, nf, L, L)[:, 1:]
    elif form == "unaligned":
        def off(*shape):
            n = int(np.prod(shape))
            return c(n + 1)[1:].view(*shape)
        pn, vf, vc = off(nc, nf, L, L), off(3, nf, L, L), off(3, nc, S, S)
    n0 = dict(cs.launches)
    got_r = dispatch.restrict(pn, vf, quad, 2, 2) if quad else (
        dispatch.restrict(pn, vf, None, 2, 2))
    got_p = dispatch.prolong(pn, vc, quad, 2, 2) if quad else (
        dispatch.prolong(pn, vc, None, 2, 2))
    assert _launched(n0) == {"restrict": 1, "prolong": 1}
    want_r = tr.restrict_plain(pn, vf, quad, 2, 2)
    want_p = tr.prolong_plain(pn, vc, quad, 2, 2)
    assert got_r.shape == want_r.shape and got_p.shape == want_p.shape
    assert _rel(got_r, want_r) < BARS[dtype]
    assert _rel(got_p, want_p) < BARS[dtype]


def test_transfer_wrappers_refuse(dev):
    """A non-contiguous entry, a field of another shape, device or dtype,
    blocks that do not divide L, two batch axes, batches that differ, a
    base of another shape: a ValueError (a dtype: a TypeError), and no
    launch."""
    rng = np.random.default_rng(90)
    c64 = torch.complex64
    pn, vf = _c(rng, (4, 2, 16, 16), c64, dev), _c(rng, (2, 16, 16), c64, dev)
    vc = _c(rng, (4, 8, 8), c64, dev)
    n0 = dict(cs.launches)
    for args in ((pn.transpose(-1, -2), vf), (pn, vf.transpose(-1, -2)),
                 (pn, vf[:1]), (pn, vf[:, :8, :8].contiguous()),
                 (pn.expand(2, 2, *pn.shape), vf),
                 (pn.expand(2, *pn.shape), vf.expand(3, *vf.shape))):
        with pytest.raises(ValueError):
            cs.transfer_restrict(*args, 1, 2, 2)
    with pytest.raises(ValueError):
        cs.transfer_restrict(pn, vf, 1, 3, 2)
    with pytest.raises(ValueError):
        cs.transfer_restrict(pn.cpu(), vf, 1, 2, 2)
    with pytest.raises(TypeError):
        cs.transfer_restrict(pn, vf.to(torch.complex128), 1, 2, 2)
    with pytest.raises(ValueError):
        cs.transfer_prolong(pn, vc[:, :4], 1, 2, 2)
    with pytest.raises(ValueError):
        cs.transfer_prolong(pn, vc, 1, 2, 2, base=vf[:1])
    with pytest.raises(ValueError):
        cs.transfer_prolong(pn, vc, 1, 2, 2, base=vf.transpose(-1, -2))
    with pytest.raises(ValueError):
        cs.transfer_prolong(pn, vc, None, 2, 2)
    assert cs.launches == n0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("resid", [False, True])
@pytest.mark.parametrize("n,L,E,B,tile", [
    (4, 128, None, None, None),              # the flagship's level 1
    (4, 64, None, 4, None),                  # its min-res apply, G = B = 4
    (4, 64, 2, 8, None),                     # an ensemble's min-res, G = 4
    (4, 32, 16, 16, None),                   # the NTL copies, G = 1
    (2, 64, None, 8, None),                  # a batch on one hierarchy
    (1, 10, 3, 6, None),                     # G = 2, n = 1
    (4, 1024, None, None, "tiled"),          # the large flagship's level 1
    (4, 32, 2, 8, (8, 8)),                   # tiled, G = 4, periodic wrap
    (2, 30, None, 3, (6, 12)),               # tiled, ragged, G = B
])
def test_dense_apply_and_residual_in_groups(dev, dtype, resid, n, L, E, B,
                                            tile):
    """B entries in groups of G = B / E sharing one D (E None: D shared by
    the batch): APPLY writes D v, RESID r - D v; one launch; each entry
    against the plain version on its own D."""
    rng = np.random.default_rng(70 + n + L)
    D, _ = _dense(rng, E or 1, n, L, dtype, dev)
    D = D if E else D[0]
    v = _c(rng, ((B,) if B else ()) + (n, L, L), dtype, dev)
    r = _c(rng, tuple(v.shape), dtype, dev)
    keep = v.clone()
    name = ("dense_residual" if resid else "dense_apply") + (
        "_tiled" if tile else "")
    fn = getattr(cs, name)
    if tile:
        fn = functools.partial(fn, tile=None if tile == "tiled" else tile)
    n0 = cs.launches[name]
    got = fn(D, v, r) if resid else fn(D, v)
    assert cs.launches[name] == n0 + 1
    assert torch.equal(v, keep)
    if E and B:
        G = B // E
        want = torch.stack([st.apply_D(D[b // G], v[b]) for b in range(B)])
    else:
        want = st.apply_D(D, v)
    if resid:
        want = r - want
    assert got.shape == want.shape
    assert _rel(got, want) < BARS[dtype]


def test_residual_dispatches_by_apply_mode(dev):
    """dispatch.residual launches the tiled kernel past the L2 (n=4,
    L=1024) and the global one within it (n=4, L=128)."""
    rng = np.random.default_rng(71)
    for L, kernel in ((1024, "dense_residual_tiled"), (128, "dense_residual")):
        D, _ = _dense(rng, 1, 4, L, torch.complex64, dev)
        v = _c(rng, (4, L, L), torch.complex64, dev)
        before = dict(cs.launches)
        dispatch.residual(D[0], v, v)
        moved = {k: c - before[k] for k, c in cs.launches.items()
                 if c != before[k]}
        assert moved == {kernel: 1}


def test_dense_residual_refuses(dev):
    """A misaligned operand (the global kernel reads pairs of sites),
    groups that do not divide the batch, an r of another shape: a
    ValueError, and no launch."""
    rng = np.random.default_rng(72)
    c64 = torch.complex64
    D, _ = _dense(rng, 2, 2, 8, c64, dev)
    v = _c(rng, (6, 2, 8, 8), c64, dev)
    flat = _c(rng, (2 * 64 + 1,), c64, dev)
    odd = flat[1:].view(2, 8, 8)
    n0 = dict(cs.launches)
    for call in (lambda: cs.dense_residual(D[0], odd, odd),
                 lambda: cs.dense_residual(D[0], v[0], odd),
                 lambda: cs.dense_apply(D, v[:5].contiguous()),
                 lambda: cs.dense_residual(D, v, v[:3].contiguous()),
                 lambda: cs.dense_residual_tiled(D, v, v[:3].contiguous())):
        with pytest.raises(ValueError):
            call()
    assert cs.launches == n0


@pytest.mark.parametrize("dtype", DTYPES)
def test_apply_D_and_residual_route_what_the_global_kernel_refuses(dev,
                                                                    dtype):
    """The global kernel's wrappers refuse an odd lattice (n=2, L=7) and, in
    complex64, an operand off a 16-byte line; apply_D and residual send
    such calls to the x-tiled kernel, one launch each, with the plain
    version's result."""
    rng = np.random.default_rng(73)
    D7, _ = _dense(rng, 1, 2, 7, dtype, dev)
    v7 = _c(rng, (2, 7, 7), dtype, dev)
    n0 = dict(cs.launches)
    for call in (lambda: cs.dense_apply(D7[0], v7),
                 lambda: cs.dense_residual(D7[0], v7, v7)):
        with pytest.raises(ValueError):
            call()
    assert cs.launches == n0
    want7 = st.apply_D(D7[0], v7)
    cases = [(lambda: dispatch.apply_D(D7[0], v7), want7,
              "dense_apply_tiled"),
             (lambda: dispatch.residual(D7[0], v7, v7), v7 - want7,
              "dense_residual_tiled")]
    if dtype == torch.complex64:          # a complex128 word is 16 bytes
        D8, _ = _dense(rng, 1, 2, 8, dtype, dev)
        off = _c(rng, (2 * 64 + 1,), dtype, dev)[1:].view(2, 8, 8)
        want8 = st.apply_D(D8[0], off)
        cases += [(lambda: dispatch.apply_D(D8[0], off), want8,
                   "dense_apply_tiled"),
                  (lambda: dispatch.residual(D8[0], off, off), off - want8,
                   "dense_residual_tiled")]
    for call, want, kernel in cases:
        before = dict(cs.launches)
        got = call()
        assert {k: c - before[k] for k, c in cs.launches.items()
                if c != before[k]} == {kernel: 1}
        assert _rel(got, want) < BARS[dtype]


def test_chebyshev_config_on_an_odd_coarsest_level(dev):
    """eigs.chebyshev_config applies apply_D on every level: at L=12 with
    two levels of 2 x 2 blocks the coarsest is S=3, which the x-tiled
    kernel takes. Each level's lambda_max against the plain apply's on the
    same operators, complex128."""
    from tpu_multigrid_torch import build_hierarchy
    from tpu_multigrid_torch.solver import eigs
    cfg, U, D = _wilson_setup(12, "complex128", dev, smoother="jacobi")
    hier = build_hierarchy(D, cfg, U=U)
    assert [lev.D.shape[-1] for lev in hier.levels] == [12, 6, 3]
    n0 = dict(cs.launches)
    cc = eigs.chebyshev_config(cfg, hier)
    assert cs.launches["dense_apply_tiled"] > n0["dense_apply_tiled"]
    assert cs.launches["dense_apply"] > n0["dense_apply"]
    for lev, lmax in zip(hier.levels, cc.cheby_lmax):
        want = eigs.jacobi_operator_lmax(lev.D.cpu(), lev.D0inv.cpu())
        assert abs(lmax - want) < 1e-10 * abs(want)


# ---- the CLI path on the card: gs_lex, self-tests, the CLI, the writer ----


def test_gs_lex_runs_the_plain_sweeps_on_cuda(dev):
    """gs_lex has no kernel (the JAX package runs it on plain XLA): on CUDA
    tensors dispatch.smooth runs the plain wavefront, launches nothing, and
    matches the CPU run."""
    rng = np.random.default_rng(20)
    for B in (None, 3):
        D, Dinv = _dense(rng, 1, 4, 16, torch.complex128, dev)
        lead = (B,) if B else ()
        phi = _c(rng, lead + (4, 16, 16), torch.complex128, dev)
        r = _c(rng, lead + (4, 16, 16), torch.complex128, dev)
        n0 = dict(cs.launches)
        got = dispatch.smooth(D[0], Dinv[0], phi, r, 2, "gs_lex", 0.9)
        assert cs.launches == n0 and got.device == phi.device
        want = dispatch.smooth(D[0].cpu(), Dinv[0].cpu(), phi.cpu(),
                               r.cpu(), 2, "gs_lex", 0.9)
        assert _rel(got.cpu(), want) < BARS[torch.complex128]


def _fallback_solve(dev, case):
    """The port's solve of torch_port_helpers.FALLBACK_SOLVES[case] on the
    card, from its numpy inputs: JAX's cycle count."""
    from tpu_multigrid_torch import MGConfig, build_hierarchy, point_source
    from tpu_multigrid_torch import solve
    from tpu_multigrid_torch.models import gauge, operators
    from torch_port_helpers import FALLBACK_SOLVES, numpy_inputs
    kw, width, count = FALLBACK_SOLVES[case]
    cfg = MGConfig(**kw)
    phases, starts = numpy_inputs(cfg, width)
    U = gauge.gauge_from_phases(phases, cfg.cdtype, dev)
    hier = build_hierarchy(operators.assemble(cfg.stencil, U, cfg.m), cfg,
                           U=U, starts=[torch.from_numpy(s).to(dev)
                                        for s in starts])
    out = solve(hier, point_source(cfg, device=dev), cfg, max_iters=300)
    assert out.converged and out.iters == count, (out.iters, count)


def test_ndof_coarse3_solve_holds_jax_count(dev):
    """A Laplace level 1 of n = 3 (--ndof-coarse 3), whose smooth, SpMV and
    residual no kernel takes, runs their plain versions (the kernel
    wrappers refuse n = 3); level 0 (n = 1) still runs its kernels."""
    n0 = dict(cs.launches)
    _fallback_solve(dev, "ndof_coarse3")
    assert cs.launches["dense_update"] > n0["dense_update"]


def test_odd_coarsest_level_solve_holds_jax_count(dev):
    """L=48 in 2 x 2 blocks on 4 levels: a 3 x 3 coarsest level, which the
    red-black kernels refuse, smoothed by the plain sweeps; levels 0-3 (48
    to 6) still on dense_update."""
    n0 = dict(cs.launches)
    _fallback_solve(dev, "coarsest_3x3")
    assert cs.launches["dense_update"] > n0["dense_update"]


def _wilson_setup(L, dtype, dev, **kw):
    from tpu_multigrid_torch import MGConfig
    from tpu_multigrid_torch.models import gauge, operators
    cfg = MGConfig(L=L, stencil="wilson", m=0.05, nlevels=2, ntl=True,
                   num_iters=4, null_iters=40, dtype=dtype, **kw)
    U = gauge.gauge_from_phases(
        0.3 * np.random.default_rng(21).normal(size=(2, L, L)), cfg.cdtype,
        dev)
    return cfg, U, operators.assemble("wilson", U, cfg.m)


def test_run_mg_tests_on_a_c64_cuda_hierarchy(dev):
    from tpu_multigrid_torch import build_hierarchy, testing
    cfg, U, D = _wilson_setup(64, "complex64", dev)
    hier = build_hierarchy(D, cfg, U=U)
    checks = testing.run_mg_tests(hier, cfg)
    assert len(checks) == 2 + 4 + 4 * cfg.n_copies
    assert max(checks.values()) < testing.epsilon_for(cfg) == 1e-4, checks


def test_cli_on_cuda(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from tpu_multigrid_torch import cli
    rc = cli.main(["--L", "32", "--stencil", "wilson", "--m", "0.05",
                   "--nlevels", "2", "--ntl", "--num-iters", "4",
                   "--null-iters", "40", "--dtype", "complex64",
                   "--res-threshold", "1e-6", "--gauge", "random",
                   "--platform", "cuda", "--out-dir", str(tmp_path)])
    assert rc == 0
    assert (tmp_path / "results_phi.txt").exists()


def test_results_writer_cuda_matches_cpu(dev, tmp_path):
    """Two cycles of solve_with_history(writer=...) on one complex64
    hierarchy, on the card (kernels) and on the CPU (plain versions): every
    line of every results file agrees to 1e-5 relative: of the line's
    largest value for phi, of |b| for the residual fields (r = b - D phi
    carries rounding of ~eps |b| at the sites where it nearly cancels)."""
    from tpu_multigrid_torch import build_hierarchy, point_source
    from tpu_multigrid_torch import solve_with_history
    from tpu_multigrid_torch.solver.hierarchy import (Hierarchy, LevelOps,
                                                      NTLOps)
    from tpu_multigrid_torch.utils.io import ResultsWriter
    from torch_port_helpers import read_results
    cfg, U, D = _wilson_setup(32, "complex64", torch.device("cpu"))
    hcpu = build_hierarchy(D, cfg, U=U)

    def on(t):
        return None if t is None else t.to(dev)

    hgpu = Hierarchy(levels=tuple(LevelOps(D=on(l.D), D0inv=on(l.D0inv),
                                           phi_null=on(l.phi_null))
                                  for l in hcpu.levels),
                     ntl=NTLOps(phi_null=on(hcpu.ntl.phi_null),
                                D=on(hcpu.ntl.D), D0inv=on(hcpu.ntl.D0inv)),
                     gauge=on(hcpu.gauge))
    for name, hier, d in (("cpu", hcpu, torch.device("cpu")),
                          ("cuda", hgpu, dev)):
        w = ResultsWriter(cfg, str(tmp_path / name))
        n0 = dict(cs.launches)
        solve_with_history(hier, point_source(cfg, device=d), cfg,
                           max_iters=2, writer=w)
        w.close()
        assert (cs.launches != n0) == (name == "cuda")
    bmax = float(point_source(cfg).abs().max())
    for f in ("results_phi.txt", "results_res_lvl-0.txt",
              "results_res_lvl-1.txt", "results_res_lvl-2.txt"):
        _, got = read_results(tmp_path / "cuda" / f)
        _, want = read_results(tmp_path / "cpu" / f)
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            scale = max(np.max(np.abs(w)), 0.0 if "phi" in f else bmax)
            assert np.max(np.abs(g - w)) <= 1e-5 * scale, f
