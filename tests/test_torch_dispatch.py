"""The persistent smoothers' planning on the CPU: the band a block owns,
staged versus streamed operands and the co-resident grid (plan_band, from
a given SM count and occupancy), and the least bytes and flops of each
hand kernel's call (profiling.kernel_work), which the kernel table's
bounds come from; the route functions of ops/dispatch.py, which choose
the implementation of each call from what it can observe; and the kernel
wrappers' refusal of CPU tensors. No card is needed: the planning and the
routes are plain Python."""
import math

import numpy as np
import pytest
import torch

from tpu_multigrid_torch import profiling
from tpu_multigrid_torch.ops import cuda_stencil as cs
from tpu_multigrid_torch.ops import dispatch

H100_SMS = 132
SMEM_PER_SM = 233472          # 228 KB, of which a block may take 227 KB
THREADS = {"links_update": 128, "dense_update": 256}
HBM = 3.35e12


def h100_occupancy(name):
    """Blocks an SM holds by threads (2048 an SM) and by shared memory
    (1 KB reserved a block); registers are left out."""
    def occ(staged, smem):
        by_threads = 2048 // THREADS[name]
        return by_threads if smem == 0 else min(
            by_threads, SMEM_PER_SM // (smem + 1024))
    return occ


def plan(name, n, B, L, itemsize, sms=H100_SMS, occupancy=None):
    occupancy = occupancy or h100_occupancy(name)
    if name == "links_update":
        return cs.plan_band(B * L,
                            lambda k: cs.links_band_bytes(L, k, itemsize, B),
                            sms, occupancy)
    return cs.plan_band(B * L,
                        lambda k: cs.dense_band_bytes(n, L, k, itemsize),
                        sms, occupancy)


@pytest.mark.parametrize("name,n,B,L,itemsize,want", [
    # the flagship: level 0 links, levels 1-2, the NTL copies
    ("links_update", 2, 1, 256, 8, cs.Band(1, 256, True, 5 * 256 * 8)),
    ("dense_update", 4, 1, 128, 8, cs.Band(1, 128, True, 84 * 128 * 8)),
    ("dense_update", 4, 1, 64, 8, cs.Band(1, 64, True, 84 * 64 * 8)),
    ("dense_update", 4, 4, 32, 8, cs.Band(1, 128, True, 84 * 32 * 8)),
    # level 1 in complex128: one 172 KB row a block, one block an SM
    ("dense_update", 4, 1, 128, 16, cs.Band(1, 128, True, 84 * 128 * 16)),
    # setup, k=2 candidates sharing D: staged in complex64, streamed in
    # complex128 (two 90 KB rows a block do not fit, one row leaves the
    # grid too large to be resident)
    ("dense_update", 2, 2, 256, 8, cs.Band(1, 512, True, 22 * 256 * 8)),
    ("dense_update", 2, 2, 256, 16, cs.Band(1, 512, False, 0)),
    # past the shared memory: one row of n=4 L=1024 is 688 KB
    ("dense_update", 4, 1, 1024, 8, cs.Band(1, 1024, False, 0)),
    ("links_update", 2, 1, 2048, 8, cs.Band(1, 2048, False, 0)),
    # fewer x-rows than blocks
    ("links_update", 2, 1, 8, 8, cs.Band(1, 8, True, 5 * 8 * 8)),
    ("dense_update", 4, 3, 8, 16, cs.Band(1, 24, True, 84 * 8 * 16)),
    # a batch of right-hand sides on shared links: B L (x, batch entry)
    # rows, one a block at B=8 L=256 (16 blocks an SM resident)
    ("links_update", 2, 8, 256, 8, cs.Band(1, 2048, True, 5 * 256 * 8)),
    ("links_update", 2, 3, 8, 16, cs.Band(1, 24, True, 5 * 8 * 16)),
    ("links_update", 2, 2, 2048, 8, cs.Band(2, 2048, False, 0)),
])
def test_plan_band_at_the_paths_shapes(name, n, B, L, itemsize, want):
    assert plan(name, n, B, L, itemsize) == want


@pytest.mark.parametrize("sms,blocks", [(132, 1), (132, 3), (16, 2), (4, 1),
                                        (1, 1)])
@pytest.mark.parametrize("name,n,B,L,itemsize", [
    ("links_update", 2, 1, 256, 8), ("links_update", 2, 1, 2048, 16),
    ("dense_update", 4, 1, 128, 8), ("dense_update", 4, 4, 32, 16),
    ("dense_update", 1, 3, 64, 8), ("dense_update", 2, 2, 256, 16),
    ("links_update", 2, 8, 256, 8), ("links_update", 2, 3, 64, 16),
])
def test_plan_band_grid_is_resident_and_covers_the_rows(sms, blocks, name,
                                                        n, B, L, itemsize):
    """For any card: every block resident at once, the bands cover the
    rows with no empty block, a staged band fits its shared memory."""
    def occ(staged, smem):
        return blocks if smem <= cs.SMEM_BLOCK_MAX else 0
    band = plan(name, n, B, L, itemsize, sms, occ)
    total = B * L
    assert band.grid <= blocks * sms
    assert band.grid * band.rows >= total > (band.grid - 1) * band.rows
    if band.staged:
        size = (cs.links_band_bytes(L, band.rows, itemsize, B)
                if name == "links_update"
                else cs.dense_band_bytes(n, L, band.rows, itemsize))
        assert band.smem_bytes == size <= cs.SMEM_BLOCK_MAX
        if band.rows > 1:              # one row fewer would not be resident
            assert math.ceil(total / (band.rows - 1)) > blocks * sms
    else:
        assert band.smem_bytes == 0


def test_plan_band_takes_more_rows_on_a_small_card():
    """4 SMs holding one block each: 64 rows of n=1 at L=64 go 16 to a
    block, staged (6 words a site, 48 KB a band)."""
    band = plan("dense_update", 1, 1, 64, 8, sms=4,
                occupancy=lambda staged, smem: 1)
    assert band == cs.Band(16, 4, True, 6 * 16 * 64 * 8)


def test_plan_band_refuses_a_kernel_that_cannot_be_resident():
    with pytest.raises(RuntimeError, match="cannot be resident"):
        plan("links_update", 2, 1, 4096, 8, occupancy=lambda s, m: 0)


def test_band_bytes():
    assert cs.links_band_bytes(256, 1, 8) == 10240        # U_x 2 rows, U_y, r
    # rows g = x B + b: a band of 8 rows at B=8 touches at most 2 x rows,
    # whose U it stages once for the batch; r of each of its 8 rows
    assert cs.links_band_bytes(256, 8, 8, B=8) == (2 * 2 + 1 + 16) * 256 * 8
    assert cs.links_band_bytes(256, 8, 8, B=1) == (4 * 8 + 1) * 256 * 8
    assert cs.band_xrows(1, 8, 256) == 1 and cs.band_xrows(9, 8, 256) == 2
    assert cs.band_xrows(10, 8, 256) == 3
    assert cs.band_xrows(600, 1, 256) == 256
    assert cs.dense_band_bytes(4, 128, 1, 8) == 86016     # 84 words a site
    assert cs.dense_band_bytes(4, 128, 1, 16) == 172032
    assert cs.dense_band_bytes(2, 256, 1, 8) == 45056     # 22 words a site


@pytest.mark.parametrize("kernel,n,L,batch,op_batch,us", [
    ("links_update", 2, 256, 1, 1, 1.25),                 # B1
    ("links_residual", 2, 256, 1, 1, 1.25),               # B2
    ("dense_update", 4, 128, 1, 1, 3.60),                 # B3 / B4 level 1
    ("dense_update", 4, 64, 1, 1, 0.90),                  # B3 level 2
    ("dense_update", 4, 32, 4, 4, 0.90),                  # B3 NTL copies
    ("dense_update", 2, 256, 2, 1, 4.70),                 # B3 setup, k=2
    ("links_update_tiled", 2, 2048, 1, 1, 80.1),          # B5a
    ("links_residual_tiled", 2, 2048, 1, 1, 80.1),        # B5b
    ("links_apply_tiled", 2, 2048, 1, 1, 60.1),           # B5c
    ("links_apply_tiled", 2, 4096, 1, 1, 240.4),
    ("dense_update_tiled", 4, 1024, 1, 1, 230.4),         # B6
    ("dense_update_tiled", 4, 512, 1, 1, 57.6),
    ("dense_update_tiled", 4, 256, 1, 1, 14.4),
    ("dense_apply", 2, 256, 1, 1, 3.76),                  # B7a
    ("dense_apply_tiled", 2, 2048, 1, 1, 240.4),          # B7b
    ("dense_apply_tiled", 4, 1024, 1, 1, 220.4),
    ("links_apply", 2, 256, 1, 1, 0.94),                  # B8
    # batched links (U read once, r and the fields per right-hand side)
    ("links_update", 2, 256, 8, 8, 7.83),                 # B1, B=8
    ("links_residual", 2, 256, 8, 8, 7.83),               # B2, B=8
    ("links_update_tiled", 2, 2048, 2, 2, 140.2),         # B5a, B=2
    ("links_residual_tiled", 2, 2048, 2, 2, 140.2),       # B5b, B=2
    ("links_residual", 2, 256, 3, 3, 3.13),               # B2, B=3
    # B2 fused with the restriction (nc=4, 2 x 2 blocks): 15 words a site
    ("links_residual_restrict", 2, 256, 1, 1, 2.35),
    ("links_residual_restrict", 2, 256, 8, 8, 7.83),      # B=8
    # B7a: the level-1 residual; the min-res apply on a shared D (G=4)
    ("dense_residual", 4, 128, 1, 1, 3.60),
    ("dense_apply", 4, 64, 4, 1, 1.10),
    ("dense_residual_tiled", 4, 1024, 1, 1, 230.4),       # B7b residual
    # the level-0 check: U, phi and b, 6 words a site; a batch of 8
    ("links_residual_norm", 2, 256, 1, 1, 0.94),
    ("links_residual_norm", 2, 256, 8, 8, 5.32),
    # B8 and B2 at the largest shapes they take on the global path
    ("links_apply", 2, 1024, 1, 1, 15.02),
    ("links_residual", 2, 512, 1, 1, 5.01),
    # the cycle's transfers at L=2048 level 0 (nf=2) and level 1 (nf=4):
    # restrict 11 and 21 words a fine site, prolong onto its base 13
    ("restrict", 2, 2048, 1, 1, 110.18),
    ("restrict", 4, 1024, 1, 1, 52.59),
    ("prolong", 2, 2048, 1, 1, 130.21),
])
def test_kernel_work_gives_the_bounds_of_the_kernel_table(kernel, n, L,
                                                          batch, op_batch,
                                                          us):
    """complex64 at 3.35 TB/s: every kernel is bound by bytes, and the
    bound is the table's, to its rounding."""
    nbytes, flops = profiling.kernel_work(kernel, n, L, 8, batch, op_batch,
                                          n_sweeps=4)
    sec, by = profiling.bound_seconds(nbytes, flops, HBM, 67e12)
    assert by == "bytes"
    assert sec * 1e6 == pytest.approx(us, rel=1e-3, abs=0.006)


def test_kernel_work_counts_sweeps_and_batches():
    b1, f1 = profiling.kernel_work("dense_update", 4, 32, 8, 4, 4, 1)
    b4, f4 = profiling.kernel_work("dense_update", 4, 32, 8, 4, 4, 4)
    assert b1 == b4 == 92 * 4 * 32 * 32 * 8        # bytes once per smooth
    assert f4 == 4 * f1 == 4 * 4 * (8 * 80 + 8) * 32 * 32
    assert profiling.bound_seconds(10, 10**9, 1.0, 1e6) == (1000.0,
                                                            "operations")
    with pytest.raises(ValueError):
        profiling.kernel_work("gs_lex", 4, 32, 8)


def test_reset_launches_clears_the_band_counts():
    cs.band_launches["dense_update"]["staged"] += 3
    cs.rb_sweeps["multi"] += 2
    cs.reset_launches()
    assert all(v == 0 for modes in cs.band_launches.values()
               for v in modes.values())
    assert all(v == 0 for v in cs.launches.values())
    assert cs.rb_sweeps == {"multi": 0, "one": 0}


# ---- the route functions of ops/dispatch.py: which implementation runs

C64, C128 = torch.complex64, torch.complex128
CARD = {"device": "cuda", "pallas": "auto"}


def _on_lines(offset, dtype, n=2, L=8):
    """cuda_stencil.aligned of a view [n, L, L] that starts `offset`
    elements into its storage."""
    flat = torch.zeros(offset + 1, dtype=dtype)
    return cs.aligned(flat[offset:].expand(n, L, L))


ROUTES = [
    # CPU tensors, pallas 'auto': the plain versions of the persistent
    # smoothers, of the links smoother and residual, of the x-tiled links
    # residual and of the SpMV
    ("cpu: dense smoother", lambda: dispatch.smooth_route(
        "rbgs", 2, 8, C128, 0, device="cpu", pallas="auto"), "plain"),
    ("cpu: links smoother", lambda: dispatch.links_route(
        8, C128, 0, "rbgs", device="cpu", pallas="auto"), "plain"),
    ("cpu: x-tiled links residual", lambda: dispatch.links_route(
        2048, C64, 0, device="cpu", pallas="auto"), "plain"),
    ("cpu: SpMV", lambda: dispatch.spmv_route(
        2, 8, C128, True, device="cpu", pallas="auto"), "plain"),
    # the dense SpMV and residual: the global kernel only for an even
    # lattice within the L2 and operands on 16-byte lines (it reads pairs
    # of sites in 16-byte loads); else the x-tiled one, which takes any L
    ("spmv: the flagship's level 1", lambda: dispatch.spmv_route(
        4, 128, C64, _on_lines(0, C64), **CARD), "global"),
    ("spmv: an odd coarsest level", lambda: dispatch.spmv_route(
        4, 3, C64, _on_lines(0, C64), **CARD), "tiled"),
    ("spmv: odd, complex128", lambda: dispatch.spmv_route(
        2, 7, C128, _on_lines(0, C128), **CARD), "tiled"),
    ("spmv: 8 bytes off a 16-byte line", lambda: dispatch.spmv_route(
        2, 8, C64, _on_lines(1, C64), **CARD), "tiled"),
    ("spmv: complex128 one word in (16 bytes)", lambda: dispatch.spmv_route(
        2, 8, C128, _on_lines(1, C128), **CARD), "global"),
    ("spmv: past the L2", lambda: dispatch.spmv_route(
        4, 1024, C64, True, **CARD), "tiled"),
    # the dense smoother by smoother_mode
    ("smooth: within the L2", lambda: dispatch.smooth_route(
        "rbgs", 4, 128, C64, 0, **CARD), "global"),
    ("smooth: past the L2", lambda: dispatch.smooth_route(
        "rbgs", 4, 1024, C64, 0, **CARD), "tiled"),
    # level 0's links kernels by u_mode
    ("links smooth: L=256", lambda: dispatch.links_route(
        256, C64, 0, "rbgs", **CARD), "global"),
    ("links smooth: L=2048", lambda: dispatch.links_route(
        2048, C64, 0, "rbgs", **CARD), "tiled"),
    ("links residual: L=256", lambda: dispatch.links_route(
        256, C64, 0, **CARD), "global"),
    ("links residual: L=2048, batch of 2", lambda:
        dispatch.links_route(2048, C64, 1, **CARD), "tiled"),
    # level 0's residual with its restriction: fused where the global links
    # kernels run and the fused kernel takes nc rows in bx x by blocks
    ("fused: nc=4 in 2 x 2 blocks", lambda: dispatch.residual_restrict_route(
        4, 2, 2, 256, C64, 0, True, True, **CARD), "fused"),
    ("fused: nc=1 in 4 x 2, a batch of 8", lambda:
        dispatch.residual_restrict_route(1, 4, 2, 256, C64, 1, True, True,
                                         **CARD), "fused"),
    ("fused: nc=3 does not fit", lambda: dispatch.residual_restrict_route(
        3, 2, 2, 256, C64, 0, True, True, **CARD), "global"),
    ("fused: 8 x 2 blocks do not fit", lambda:
        dispatch.residual_restrict_route(4, 8, 2, 256, C64, 0, True, True,
                                         **CARD), "global"),
    ("fused: phi_null batched (an ensemble)", lambda:
        dispatch.residual_restrict_route(4, 2, 2, 256, C64, 1, False, True,
                                         **CARD), "global"),
    ("fused: an operand off a line", lambda:
        dispatch.residual_restrict_route(4, 2, 2, 256, C64, 0, True, False,
                                         **CARD), "global"),
    ("fused: the x-tiled level 0", lambda: dispatch.residual_restrict_route(
        4, 2, 2, 2048, C64, 0, True, True, **CARD), "tiled"),
    ("fused: pallas off", lambda: dispatch.residual_restrict_route(
        4, 2, 2, 256, C64, 0, True, True, device="cuda", pallas="off"),
     "plain"),
    # the level-0 check: one launch at a links-active level 0, at any L; a
    # dense level 0 (complex128 with links 'auto', or no links on the
    # hierarchy) checks through the dense residual; pallas 'off': plain
    ("check: links level 0", lambda: dispatch.check_route(
        C64, 1, **CARD), "global"),
    ("check: x-tiled links level 0", lambda: dispatch.check_route(
        C64, 0, **CARD), "global"),
    ("check: dense level 0, complex128", lambda: dispatch.spmv_route(
        2, 8, C128, True, **CARD), "global"),
    ("check: dense level 0, no links", lambda: dispatch.spmv_route(
        2, 8, C64, True, **CARD), "global"),
    ("check: pallas off", lambda: dispatch.check_route(
        C64, 1, device="cuda", pallas="off"), "plain"),
    # the transfers of CPU tensors, either pallas
    ("transfers: cpu, pallas auto", lambda: dispatch.transfer_route(
        C128, device="cpu", pallas="auto"), "plain"),
    ("transfers: cpu, pallas off", lambda: dispatch.transfer_route(
        C128, device="cpu", pallas="off"), "plain"),
    ("transfers: the card", lambda: dispatch.transfer_route(C64, **CARD),
     "global"),
    # the links SpMV by apply_mode(links=True)
    ("links apply: L=1024", lambda: dispatch.links_apply_route(
        1024, C64, **CARD), "global"),
    ("links apply: L=2048", lambda: dispatch.links_apply_route(
        2048, C64, **CARD), "tiled"),
    # shapes no kernel takes run the plain version, as JAX's _relax sends
    # them to plain XLA: a dense level of n = 3 (--ndof-coarse 3) ...
    ("n=3: red-black smooth", lambda: dispatch.smooth_route(
        "rbgs", 3, 8, C128, 0, **CARD), "plain"),
    ("n=3: Jacobi smooth", lambda: dispatch.smooth_route(
        "jacobi", 3, 8, C128, 0, **CARD), "plain"),
    ("n=3: SpMV and residual", lambda: dispatch.spmv_route(
        3, 8, C128, True, **CARD), "plain"),
    # ... and a red-black sweep of an odd lattice (a 3 x 3 coarsest level),
    # which Jacobi's kernels take
    ("odd L: red-black smooth", lambda: dispatch.smooth_route(
        "rbgs", 4, 3, C128, 0, **CARD), "plain"),
    ("odd L: NTL copies' red-black smooth", lambda: dispatch.smooth_route(
        "rbgs", 4, 3, C128, 1, **CARD), "plain"),
    ("odd L: Jacobi smooth", lambda: dispatch.smooth_route(
        "jacobi", 4, 3, C128, 0, **CARD), "global"),
    ("odd L: links red-black smooth", lambda: dispatch.links_route(
        9, C128, 0, "rbgs", **CARD), "plain"),
    # kinds without a kernel, and pallas 'off'
    ("gs_lex", lambda: dispatch.smooth_route(
        "gs_lex", 4, 128, C64, 0, **CARD), "plain"),
    ("links gs_lex", lambda: dispatch.links_route(
        256, C64, 0, "gs_lex", **CARD), "plain"),
    ("smooth: pallas off", lambda: dispatch.smooth_route(
        "rbgs", 4, 128, C64, 0, device="cuda", pallas="off"), "plain"),
    ("smooth: an ensemble's candidates [C, k, n, L, L]", lambda:
        dispatch.smooth_route("rbgs", 2, 128, C64, 2, **CARD), "global"),
]


@pytest.mark.parametrize("route,want", [r[1:] for r in ROUTES],
                         ids=[r[0] for r in ROUTES])
def test_routes(route, want):
    assert route() == want


def _cpu_calls():
    """One call of each kernel wrapper on CPU tensors of shapes it takes on
    the card."""
    rng = np.random.default_rng(1)
    L = 8

    def c(*shape):
        return torch.from_numpy(rng.normal(size=shape)
                                + 1j * rng.normal(size=shape))

    U, phi, v = c(2, L, L), c(2, L, L), c(2, L, L)
    D, Dinv, pn = c(5, 2, 2, L, L), c(2, 2, L, L), c(4, 2, L, L)
    vc = c(4, L // 2, L // 2)
    return {
        "wilson_u_residual": lambda: cs.wilson_u_residual(U, 0.1, phi, v),
        "wilson_u_residual_tiled": lambda: cs.wilson_u_residual_tiled(
            U, 0.1, phi, v),
        "wilson_u_residual_norm": lambda: cs.wilson_u_residual_norm(
            U, 0.1, phi, v),
        "wilson_u_residual_restrict": lambda: cs.wilson_u_residual_restrict(
            U, 0.1, phi, v, pn, 1, 2, 2),
        "wilson_u_smooth": lambda: cs.wilson_u_smooth(U, 0.1, phi, v, 2),
        "wilson_u_smooth_tiled": lambda: cs.wilson_u_smooth_tiled(
            U, 0.1, phi, v, 2),
        "wilson_u_apply": lambda: cs.wilson_u_apply(U, 0.1, v),
        "wilson_u_apply_tiled": lambda: cs.wilson_u_apply_tiled(U, 0.1, v),
        "dense_smooth": lambda: cs.dense_smooth(D, Dinv, phi, v, 2),
        "dense_smooth_tiled": lambda: cs.dense_smooth_tiled(D, Dinv, phi, v,
                                                            2),
        "dense_apply": lambda: cs.dense_apply(D, v),
        "dense_apply_tiled": lambda: cs.dense_apply_tiled(D, v),
        "dense_residual": lambda: cs.dense_residual(D, phi, v),
        "dense_residual_tiled": lambda: cs.dense_residual_tiled(D, phi, v),
        "transfer_restrict": lambda: cs.transfer_restrict(pn, v, 1, 2, 2),
        "transfer_prolong": lambda: cs.transfer_prolong(pn, vc, 1, 2, 2),
    }


WRAPPERS = ["wilson_u_residual", "wilson_u_residual_tiled",
            "wilson_u_residual_norm", "wilson_u_residual_restrict",
            "wilson_u_smooth", "wilson_u_smooth_tiled", "wilson_u_apply",
            "wilson_u_apply_tiled", "dense_smooth", "dense_smooth_tiled",
            "dense_apply", "dense_apply_tiled", "dense_residual",
            "dense_residual_tiled", "transfer_restrict", "transfer_prolong"]


@pytest.mark.parametrize("wrapper", WRAPPERS)
def test_kernel_wrappers_refuse_cpu_tensors(wrapper):
    """The wrappers are kernel-only: a CPU tensor is refused before any
    launch (ops/dispatch.py sends CPU tensors to the plain versions)."""
    before = dict(cs.launches)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        _cpu_calls()[wrapper]()
    assert cs.launches == before
