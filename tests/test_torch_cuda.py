"""The port's CUDA kernels (global and x-tiled) against their plain torch
versions, on the card.

Marked `cuda`: without a CUDA device every test skips (the decision is
taken inside the fixture). This file imports no jax, so it runs on a
machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from tpu_multigrid_torch.ops import cuda_stencil as cs
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("L", [8, 256])
def test_links_residual(dev, dtype, L):
    rng = np.random.default_rng(1)
    U = _links(rng, L, dtype, dev)
    phi, r = _c(rng, (2, L, L), dtype, dev), _c(rng, (2, L, L), dtype, dev)
    n0 = cs.launches["links_residual"]
    got = cs.wilson_u_residual(U, -0.005, phi, r)
    assert cs.launches["links_residual"] == n0 + 1
    want = gs.residual_u("wilson", U, -0.005, phi, r)
    assert _rel(got, want) < BARS[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,omega", [("rbgs", 1.0), ("jacobi", 1.0),
                                        ("rbgs", 0.8), ("jacobi", 0.8)])
@pytest.mark.parametrize("L", [8, 256])
def test_links_smooth(dev, dtype, kind, omega, L):
    rng = np.random.default_rng(2)
    U = _links(rng, L, dtype, dev)
    phi, r = _c(rng, (2, L, L), dtype, dev), _c(rng, (2, L, L), dtype, dev)
    keep = phi.clone()
    n0 = cs.launches["links_update"]
    got = cs.wilson_u_smooth(U, -0.005, phi, r, 4, kind, omega)
    assert cs.launches["links_update"] == n0 + (8 if kind == "rbgs" else 4)
    assert torch.equal(phi, keep)            # the input is not overwritten
    want = gs.smooth_u("wilson", U, -0.005, phi, r, 4, kind, omega)
    assert _rel(got, want) < BARS[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["rbgs", "jacobi"])
@pytest.mark.parametrize("n,B,L,shared", [
    (4, None, 128, False), (4, None, 64, False), (4, 4, 32, False),
    (2, 2, 256, True), (4, 2, 128, True), (1, 3, 16, False), (2, None, 8, False),
])
def test_dense_smooth(dev, dtype, kind, n, B, L, shared):
    """The flagship's coarse levels (n=4 at 128 and 64), its NTL copies
    (batch 4, each its own D) and its setup relaxation (k=2 candidates
    sharing D, n=2 at 256 and n=4 at 128), plus n=1."""
    rng = np.random.default_rng(3)
    nb = 1 if (B is None or shared) else B
    D, Dinv = _dense(rng, nb, n, L, dtype, dev)
    if B is None or shared:
        D, Dinv = D[0], Dinv[0]
    lead = () if B is None else (B,)
    phi = _c(rng, lead + (n, L, L), dtype, dev)
    r = _c(rng, (n, L, L) if shared else lead + (n, L, L), dtype, dev)
    n0 = cs.launches["dense_update"]
    got = sm.smooth(D, Dinv, phi, r, 4, kind)
    assert cs.launches["dense_update"] == n0 + (8 if kind == "rbgs" else 4)
    want = sm.smooth(D, Dinv, phi, r, 4, kind, pallas="off")
    assert _rel(got, want) < BARS[dtype]


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
    D, Dinv = _dense(rng, 1, 3, L, torch.complex64, dev)
    with pytest.raises(ValueError):
        cs.dense_smooth(D[0], Dinv[0], _c(rng, (3, L, L), torch.complex64, dev),
                        _c(rng, (3, L, L), torch.complex64, dev), 1, "rbgs")


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
    rng = np.random.default_rng(6)
    U = _links(rng, L, dtype, dev)
    phi, r = _c(rng, (2, L, L), dtype, dev), _c(rng, (2, L, L), dtype, dev)
    keep = phi.clone()
    n0 = cs.launches["links_update_tiled"]
    got = cs.wilson_u_smooth_tiled(U, -0.005, phi, r, 4, kind, omega,
                                   tile=tile)
    assert cs.launches["links_update_tiled"] == n0 + (8 if kind == "rbgs"
                                                      else 4)
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
    assert cs.launches["dense_update_tiled"] == n0 + (8 if kind == "rbgs"
                                                      else 4)
    assert torch.equal(phi, keep)
    want = sm.smooth_plain(D, Dinv, phi, r, 4, kind, omega)
    assert _rel(got, want) < BARS[dtype]


def test_smooth_dispatches_tiled_past_the_l2(dev):
    """smooth() on a level past the L2 (n=4, L=256) launches the tiled
    kernel only; on one within it (n=4, L=128) the global kernel only."""
    rng = np.random.default_rng(8)
    for L, kernel in ((256, "dense_update_tiled"), (128, "dense_update")):
        D, Dinv = _dense(rng, 1, 4, L, torch.complex64, dev)
        phi = _c(rng, (4, L, L), torch.complex64, dev)
        before = dict(cs.launches)
        sm.smooth(D[0], Dinv[0], phi, phi, 1, "rbgs")
        moved = {k: v - before[k] for k, v in cs.launches.items()
                 if v != before[k]}
        assert moved == {kernel: 2}


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
@pytest.mark.parametrize("L,tile", [(256, None), (8, None)] + [
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
    """apply_D launches the tiled kernel past the L2 (n=2, L=2048) and the
    global one within it (n=2, L=256); so does the links apply (L=2048 and
    L=1024)."""
    rng = np.random.default_rng(12)
    cases = [(lambda D, v: cs.apply_D(D, v), 2048, "dense_apply_tiled"),
             (lambda D, v: cs.apply_D(D, v), 256, "dense_apply")]
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
        cs.wilson_u_apply_auto(U, 0.1, _c(rng, (2, L, L), torch.complex64,
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


# ---- the CLI path on the card: gs_lex, self-tests, the CLI, the writer ----


def test_gs_lex_runs_the_plain_sweeps_on_cuda(dev):
    """gs_lex has no kernel (the JAX package runs it on plain XLA): on CUDA
    tensors `smooth` runs the plain wavefront, launches nothing, and
    matches the CPU run."""
    rng = np.random.default_rng(20)
    for B in (None, 3):
        D, Dinv = _dense(rng, 1, 4, 16, torch.complex128, dev)
        lead = (B,) if B else ()
        phi = _c(rng, lead + (4, 16, 16), torch.complex128, dev)
        r = _c(rng, lead + (4, 16, 16), torch.complex128, dev)
        n0 = dict(cs.launches)
        got = sm.smooth(D[0], Dinv[0], phi, r, 2, "gs_lex", 0.9)
        assert cs.launches == n0 and got.device == phi.device
        want = sm.smooth(D[0].cpu(), Dinv[0].cpu(), phi.cpu(), r.cpu(), 2,
                         "gs_lex", 0.9)
        assert _rel(got.cpu(), want) < BARS[torch.complex128]


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
