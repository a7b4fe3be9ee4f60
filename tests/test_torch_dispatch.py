"""The persistent smoothers' planning on the CPU: the band a block owns,
staged versus streamed operands and the co-resident grid (plan_band, from
a given SM count and occupancy), and the least bytes and flops of each
hand kernel's call (profiling.kernel_work), which the kernel table's
bounds come from. No card is needed: the wrappers take the plain versions
for CPU tensors, and the planning is plain Python."""
import math

import numpy as np
import pytest
import torch

from tpu_multigrid_torch import profiling
from tpu_multigrid_torch.ops import cuda_stencil as cs
from tpu_multigrid_torch.ops import gauge_stencil as gs
from tpu_multigrid_torch.ops import smoothers as sm

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


def test_cpu_tensors_take_the_plain_versions():
    """On CPU tensors the persistent smoothers' wrappers run the plain
    sweeps and count no launch, staged or streamed."""
    rng = np.random.default_rng(0)
    L = 8
    U = torch.from_numpy(np.exp(0.2j * rng.normal(size=(2, L, L))))
    phi = torch.from_numpy(rng.normal(size=(2, L, L)) + 0j)
    D = torch.from_numpy(0.25 * rng.normal(size=(5, 2, 2, L, L)) + 0j)
    D[0] += 4.0 * torch.eye(2, dtype=D.dtype)[:, :, None, None]
    Dinv = torch.linalg.inv(D[0].permute(2, 3, 0, 1)).permute(2, 3, 0, 1)
    before = (dict(cs.launches),
              {k: dict(v) for k, v in cs.band_launches.items()})
    for kind in ("rbgs", "jacobi"):
        assert torch.equal(cs.wilson_u_smooth(U, 0.1, phi, phi, 3, kind, 0.8),
                           gs.smooth_u("wilson", U, 0.1, phi, phi, 3, kind,
                                       0.8))
        assert torch.equal(cs.dense_smooth(D, Dinv, phi, phi, 3, kind, 0.8),
                           sm.smooth_plain(D, Dinv, phi, phi, 3, kind, 0.8))
    assert (cs.launches, cs.band_launches) == before


def test_reset_launches_clears_the_band_counts():
    cs.band_launches["dense_update"]["staged"] += 3
    cs.reset_launches()
    assert all(v == 0 for modes in cs.band_launches.values()
               for v in modes.values())
    assert all(v == 0 for v in cs.launches.values())


@pytest.mark.parametrize("n,L,dtype,offset,want", [
    (4, 128, torch.complex64, 0, "global"),      # the flagship's level 1
    (4, 3, torch.complex64, 0, "tiled"),         # an odd coarsest level
    (2, 7, torch.complex128, 0, "tiled"),
    (2, 8, torch.complex64, 1, "tiled"),         # 8 bytes off a 16-byte line
    (2, 8, torch.complex128, 1, "global"),       # a word is 16 bytes
    (4, 1024, torch.complex64, 0, "tiled"),      # past the L2
])
def test_dense_route_sends_what_the_global_kernel_refuses_to_the_tiled(
        n, L, dtype, offset, want):
    """apply_D and residual take the global SpMV kernel only for an even
    lattice within the L2 and operands on 16-byte lines (the kernel reads
    pairs of sites in 16-byte loads); else the x-tiled one, which takes
    any L."""
    flat = torch.zeros(offset + 1, dtype=dtype)
    v = flat[offset:].expand(n, L, L)
    assert cs._dense_route(v) == want
    if offset:                         # a misaligned r alone does the same
        aligned = torch.zeros(1, dtype=dtype).expand(n, L, L)
        assert cs._dense_route(aligned, None, v) == want
