#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_multigrid_torch) on one GPU.

    python3 chip_smoke.py

From the root of a checkout, with one CUDA card. It builds the port's
hand-written kernels from csrc/, holds each kernel against its plain torch
version on the card at the shapes of the paths below (timing both with
CUDA events; the x-tiled kernels also beside the global kernel at the same
shape), then drives two solves through the package's entry points
(MGConfig, assemble, build_hierarchy(..., U=U), solve_chunked, solve_ir):

- the flagship: Wilson, L=256, m=-0.005, 3 levels, NTL with 4 quadrant
  copies and min-res weights, red-black GS x4, 100 near-null sweeps,
  complex64, to 1e-6, on the global kernels (each host check one
  links_residual_norm launch), then by solve_ir to 1e-8 and 1e-13 (its
  outer residual on the dense residual kernel, beside the plain outer
  residual); the check by both compositions in turns (B2 and two norms,
  and the one launch): device ops and host time a check, ms a checked
  cycle;
- the large flagship: the same at L=2048 with 6 levels (coarsest 32), on
  the x-tiled kernels at levels 0-3 (each host check still one
  links_residual_norm launch), to 1e-6, then by solve_ir (complex64
  cycles, exact complex128 defect) to 1e-8 and 1e-13; the check by both
  compositions in turns (B5b and two norms, and the one launch).

Then mesh: the distributed path (parallel/) at world size 1, a one-rank
NCCL group on the card: the flagship's setup by build_hierarchy_sharded
and its solve by make_sharded_solver (the tile levels on plain torch, the
replicated coarsest level and the NTL copies on dense_update), held to
the single-device solve on the same hierarchy with links off, and the
CLI with --mesh 1,1 (after the cli phase below).

Then block8: the flagship with 8 x 8 blocks, which the fused
residual-restriction does not take (level 0's residual on the unfused
B2), 3 cycles.

Then the SpMV path:

- spmv: profiling.roofline_table on Wilson L=2048 complex64 (gauge phases
  0.2 N(0,1) from default_rng(7), m=-0.07: bench.py's stencil-stream
  phase), plus the links-apply rows at L=256, 2048 and 4096, with achieved
  bytes/s and the fraction of the card's HBM peak;
- krylov, through mr_solve, solve_chunked, eo_mr_solve, cgnr_solve_ir and
  fgmres_solve: MR and MG (complex128) on the flagship operator to 1e-8,
  even-odd MR to 1e-8, CGNR with complex128 defect correction on Wilson
  m=-0.07 on a beta=32 native heat-bath ensemble at L=128 and 256 to 1e-8
  (true residual recomputed with the plain apply_D), and MG-preconditioned
  FGMRES on the flagship hierarchy to 1e-6; one profiled CGNR chunk gives
  the device's busy share and its largest device kernels.

Then the entry points a user runs, in process: tpu_multigrid_torch.cli
(the flagship's config and phases through the CLI: its cycle count, the
self-tests, the results files, a near-null checkpoint read back, the
complex128 solve_ir to 1e-13, the fmg / fgmres / cgnr / eo_mr solvers,
--resume, lexicographic GS with joint-QR setup at L=32) and
tpu_multigrid_torch.scan (a two-point laplace mass scan at L=256).

Then the batch axis and the other programs:

- batched: 8 right-hand sides (complex normal from a seed) through
  solve_batched on the flagship hierarchy, 10 cycles, and 2 through the
  large flagship's, 8 cycles: each equal to its own unbatched solve, one
  batched cycle making exactly the launches of an unbatched one (one
  launch a call for the whole batch);
- ensemble8: bench.py's ensemble phase (Wilson L=128, m=-0.005, 2 levels,
  NTL, 8 gauge configurations, 18 cycles) through
  build_hierarchies_batched and solve_ensemble;
- chebyshev: eigs.chebyshev_config on the flagship hierarchy, then the
  Chebyshev-smoothed solve to 1e-6, beside the plain path;
- geo: the CLI's gen-1 program at the reference's own size (L=2048,
  m=0.002, 9 levels, 20 sweeps) by --geo-ir to sum|r| < 1e-7, and the
  gen-2 program at L=32 with lexicographic GS, t_flag 0 and 1.

It checks convergence, that each solve went through every kernel of its
path (launch counters, set to 0 before the path and read after it), that
one flagship cycle launches exactly FLAGSHIP_CYCLE (the persistent
smoothers once per smooth call, level 0's residual fused with its
restriction, the two coarse residuals on the dense residual kernel, the
min-res apply on the SpMV kernel, no x-tiled kernel) and one
large-flagship cycle exactly LARGE_CYCLE (the x-tiled smoothers once per
sweep, the coarse residuals x-tiled past the L2 and global within it),
that a batched or ensemble cycle launches as an unbatched one does, that
the plain path on the same hierarchy takes the same number of cycles
(within one), and that the kernel path agrees with the plain path on a
small complex128 problem.

Beside each kernel's main shape (and, for the links kernels, the batched
main shape; for B8, B2 and the check also B8 at L=1024, B2 at L=512 and
both dtypes) it computes the kernel's bound (the least bytes and flops of
the call over the card's peak rates), its device time a call
(torch.profiler; for B8, B2 and the check also beside the floor: a
one-element zero_(), and a cold copy of the row's least bytes), and
times one PyTorch call that computes the same function where there is
one: for the
SpMV and residual kernels torch.sparse.mm / torch.sparse.addmm on the
operator assembled once as a CSR matrix (int32 indices), by CUDA events
and, beside each row's kernel, by cold device time; the smoothers and the
fused residual-restriction have none. The port never calls these.
Beside the fused residual-restriction it times the unfused path it
replaces (B2, then the plain restriction).

Any failed check raises, and the exit code is then non-zero. The last
line of standard output is one JSON object, {"ok": true, "device": ...};
the line before it is a JSON object with one entry per kernel. Without a
CUDA device, or outside the repository, it fails and prints no result.
"""
import collections
import contextlib
import dataclasses
import functools
import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPLACES = {
    "links_update": "tpu_multigrid/ops/pallas_stencil.py:669",
    "links_residual": "tpu_multigrid/ops/pallas_stencil.py:662",
    "links_residual_restrict": "tpu_multigrid/ops/pallas_stencil.py:662",
    "links_residual_norm": "tpu_multigrid/ops/pallas_stencil.py:662",
    "dense_update": "tpu_multigrid/ops/pallas_stencil.py:125",
    "links_update_tiled": "tpu_multigrid/ops/pallas_stencil.py:711",
    "links_residual_tiled": "tpu_multigrid/ops/pallas_stencil.py:703",
    "dense_update_tiled": "tpu_multigrid/ops/pallas_stencil.py:358",
    "links_apply": "tpu_multigrid/ops/pallas_stencil.py:656",
    "dense_apply": "tpu_multigrid/ops/pallas_stencil.py:64",
    "dense_residual": "tpu_multigrid/ops/pallas_stencil.py:64",
    "links_apply_tiled": "tpu_multigrid/ops/pallas_stencil.py:695",
    "dense_apply_tiled": "tpu_multigrid/ops/pallas_stencil.py:236",
    "dense_residual_tiled": "tpu_multigrid/ops/pallas_stencil.py:236",
}
SOURCES = {k: "tpu_multigrid_torch/csrc/" + ("stencil_tiled.cu" if
                                             k.endswith("_tiled") else
                                             "stencil.cu")
           for k in REPLACES}
FLAGSHIP_KERNELS = ("links_update", "links_residual_norm", "dense_update",
                    "links_residual_restrict", "dense_residual", "dense_apply")
# the unfused B2: level 0's residual where the fused residual-restriction
# does not take the blocks (8 x 8)
BLOCK8_KERNELS = ("links_residual",)
LARGE_KERNELS = ("links_update_tiled", "links_residual_tiled",
                 "links_residual_norm", "dense_update_tiled", "dense_update", "dense_residual_tiled",
                 "dense_residual", "dense_apply")
SPMV_KERNELS = ("dense_apply_tiled", "links_apply", "links_apply_tiled")
KRYLOV_KERNELS = ("dense_apply",)
CLI_KERNELS = ("links_update", "links_residual_norm", "dense_update",
               "dense_apply")
# the kernels that take a batch of right-hand sides on shared links (and
# near-null rows) or a shared D
BATCHED_KERNELS = ("links_update", "links_residual_norm",
                   "links_update_tiled", "links_residual_tiled",
                   "links_residual_restrict", "dense_residual",
                   "dense_residual_tiled")
ENSEMBLE_KERNELS = ("dense_update", "dense_residual", "dense_apply")
CHEBYSHEV_KERNELS = ("dense_apply", "links_residual_norm")
# the gen-2 program's cycles at L=32, m=0.5, 3 levels, 4 lexicographic
# sweeps, t_flag 0 and 1 (the count tests/test_torch_cli.py holds the
# port's CLI to on the CPU, which is the JAX CLI's)
GEO2_CYCLES = 10
L2_BYTES = 50 * 2**20
BARS = {"complex64": 2e-5, "complex128": 1e-12}
# Peak rates outside the tensor cores, H100 SXM (NVIDIA's data sheet): the
# kernels' complex arithmetic is float32 (complex64) or float64 pairs.
PEAK_FLOPS = {"complex64": 67e12, "complex128": 34e12}
NO_LIBRARY = ("none: no single PyTorch call computes a red-black or Jacobi "
              "sweep")
NO_LIBRARY_RESTRICT = ("none: no single PyTorch call computes the residual "
                       "and its restriction")
NO_LIBRARY_NORM = ("none: no single PyTorch call computes the residual's "
                   "norm over the right-hand side's")
# The kernels whose rows also read the floor: the device time, cold, of a
# copy moving the row's least bytes (chip_smoke.run_kernel_cases)
FLOOR_KERNELS = ("links_apply", "links_residual", "links_residual_norm")
# Device ops of one flagship cycle on record for the first design of the
# smoothers (one launch per half-sweep; PERF.md).
FIRST_DESIGN_CYCLE_OPS = 313
# Launches of one flagship cycle: rbgs x4 down and up at level 0 (links)
# and at levels 1-2 and once on the NTL copies (dense); level 0's residual
# fused with its restriction, levels 1-2's on the dense residual kernel,
# the min-res apply on the SpMV kernel.
FLAGSHIP_CYCLE = {"links_update": 2, "dense_update": 5,
                  "links_update_tiled": 0, "dense_update_tiled": 0,
                  "links_residual_restrict": 1, "links_residual": 0,
                  "dense_residual": 2, "dense_apply": 1}
# One large-flagship cycle: one fused red-black launch a sweep (rbgs x4 at
# level 0, 2 calls, and at levels 1-3, 2 calls each); level 0's residual on
# B5b (then the plain restriction); the dense residuals of levels 1-2
# (L=1024, 512) x-tiled, of levels 3-5 (L=256, 128, 64) global
# (apply_mode); the min-res apply at level 5.
LARGE_CYCLE = {"links_update_tiled": 8, "dense_update_tiled": 24,
               "links_residual_tiled": 1, "links_residual_restrict": 0,
               "dense_residual_tiled": 2, "dense_residual": 3,
               "dense_apply": 1}


@dataclasses.dataclass
class Case:
    """One kernel call at a path's shape: the kernel (fk), its plain
    version (fp), the global kernel at a tiled case's shape (fg), the
    least (bytes, flops) of the call, and `library`: a function that builds
    (outside any timing) and returns one PyTorch call computing the same
    function, or None."""
    kernel: str
    label: str
    dtype: object
    fk: object
    fp: object
    fg: object = None
    work: tuple = None
    library: object = None
    batch: int = 1
    no_library: str = NO_LIBRARY


def stencil_csr(torch, D):
    """The stencil D [5, n, n, L, L] as one CSR matrix of n L^2 rows, int32
    indices, columns sorted: row i L^2 + s, column j L^2 + (the neighbour
    of site s in direction d), value D[d, i, j, s]."""
    n, L = D.shape[1], D.shape[-1]
    LL = L * L
    ar = torch.arange(L, device=D.device)
    X, Y = torch.meshgrid(ar, ar, indexing="ij")
    nbr = torch.stack([X * L + Y, (X + 1) % L * L + Y, (X - 1) % L * L + Y,
                       X * L + (Y + 1) % L, X * L + (Y - 1) % L])
    nbr = nbr.reshape(5, LL)
    j = torch.arange(n, device=D.device)
    cols = (j[None, None, :] * LL + nbr.T[:, :, None]).reshape(1, LL, 5 * n)
    cols = cols.expand(n, LL, 5 * n).reshape(n * LL, 5 * n)
    vals = D.permute(1, 3, 4, 0, 2).reshape(n * LL, 5 * n)
    cols, order = torch.sort(cols, dim=1)
    vals = torch.gather(vals, 1, order)
    crow = torch.arange(n * LL + 1, device=D.device,
                        dtype=torch.int32) * (5 * n)
    return torch.sparse_csr_tensor(crow, cols.to(torch.int32).reshape(-1),
                                   vals.reshape(-1), size=(n * LL, n * LL),
                                   check_invariants=False)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


# Bytes rewritten to flush the L2 before a cold call: five times the
# H100's 50 MB.
L2_FLUSH_BYTES = 256 << 20


def cuda_ms(torch, fn, reps=20):
    """Median milliseconds of fn() over `reps` runs, each between its own
    pair of CUDA events, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_cases(torch, mgt, dev):
    """Case objects at the paths' shapes, complex64 then complex128. The
    first complex64 case of each kernel is its main shape; the x-tiled
    cases at the default tile also run the global kernel (fg)."""
    cs = mgt.ops.cuda_stencil
    gs = mgt.ops.gauge_stencil
    sm = mgt.ops.smoothers
    work = mgt.profiling.kernel_work
    gen = torch.Generator(device=dev).manual_seed(20261016)
    m = -0.005

    def c(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype)

    def links(L, dtype):
        ph = 0.2 * torch.randn((2, L, L), generator=gen, device=dev,
                               dtype=torch.float64)
        return torch.polar(torch.ones_like(ph), ph).to(dtype)

    def stencil(B, n, L, dtype):
        D = 0.25 * c(((B,) if B else ()) + (5, n, n, L, L), dtype)
        D[..., 0, :, :, :, :] += 4.0 * torch.eye(
            n, dtype=dtype, device=dev)[:, :, None, None]
        return D

    def dense(B, n, L, dtype):
        D = stencil(B, n, L, dtype)
        return D, mgt.ops.stencil.site_inverse(D[..., 0, :, :, :, :])

    def links_op(U):
        return lambda: stencil_csr(torch, mgt.models.operators.assemble(
            "wilson", U, m))

    def links_cases(L, tag, dtype, tiled, tile=None, sweeps=4, omega=1.0,
                    resid=True, batch=1, shared_r=False):
        """A batch > 1: phi [batch, 2, L, L] on the shared links, r batched
        or shared."""
        lead = (batch,) if batch > 1 else ()
        U, phi = links(L, dtype), c(lead + (2, L, L), dtype)
        r = c((2, L, L) if shared_r else lead + (2, L, L), dtype)
        isz = phi.element_size()
        r_copies = 1 if shared_r else batch
        if tiled:
            res = functools.partial(cs.wilson_u_residual_tiled, tile=tile)
            upd = functools.partial(cs.wilson_u_smooth_tiled, tile=tile)
            kr, ku = "links_residual_tiled", "links_update_tiled"
            gres, gupd = cs.wilson_u_residual, cs.wilson_u_smooth
        else:
            res, upd, gres, gupd = (cs.wilson_u_residual, cs.wilson_u_smooth,
                                    None, None)
            kr, ku = "links_residual", "links_update"

        def resid_call():
            """One CSR SpMM for the batch: the entries of phi as columns,
            r as many columns (a shared r repeated), the result a
            (transposed) view."""
            A = links_op(U)()
            V = phi.reshape(batch, -1).T
            R = r.reshape(r_copies, -1).T.expand(-1, batch).contiguous()
            return lambda: torch.sparse.addmm(R, A, V, alpha=-1).T

        out = []
        if resid:
            out.append(Case(kr, f"{'B5b' if tiled else 'B2'} residual {tag}",
                            dtype, lambda: res(U, m, phi, r),
                            lambda: gs.residual_u("wilson", U, m, phi, r),
                            gres and (lambda: gres(U, m, phi, r)),
                            work(kr, 2, L, isz, batch, r_copies),
                            resid_call, batch))
        om = "" if omega == 1.0 else f" omega={omega}"
        for kind in ("rbgs", "jacobi"):
            name = ("B5a" if tiled else "B1") + f" {kind} x{sweeps}{om} {tag}"
            out.append(Case(
                ku, name, dtype,
                lambda k=kind: upd(U, m, phi, r, sweeps, k, omega),
                lambda k=kind: gs.smooth_u("wilson", U, m, phi, r, sweeps, k,
                                           omega),
                gupd and (lambda k=kind: gupd(U, m, phi, r, sweeps, k,
                                              omega)),
                work(ku, 2, L, isz, batch, r_copies, sweeps), batch=batch))
        return out

    def apply_cases(E, B, n, L, tag, dtype, tiled, tile=None, resid=False,
                    batch=1, row=None):
        """The dense SpMV (B7a global, B7b x-tiled) or, resid, its residual
        r - D v: E copies of D (None: one, shared by the batch) for B
        entries of v (None: one), in groups of B / E (dense_groups).
        batch: the Case's batch, > 1 for a batched main shape; row: the
        label's first word (its row in the kernel table) where it is not
        the kernel's own."""
        D = stencil(E, n, L, dtype)
        v = c(((B,) if B else ()) + (n, L, L), dtype)
        r = c(tuple(v.shape), dtype) if resid else None
        if resid:
            fn = (functools.partial(cs.dense_residual_tiled, tile=tile)
                  if tiled else cs.dense_residual)
            kern = "dense_residual_tiled" if tiled else "dense_residual"
            call = functools.partial(fn, D, v, r)
            glob = functools.partial(cs.dense_residual, D, v, r)
        else:
            fn = (functools.partial(cs.dense_apply_tiled, tile=tile) if tiled
                  else cs.dense_apply)
            kern = "dense_apply_tiled" if tiled else "dense_apply"
            call = functools.partial(fn, D, v)
            glob = functools.partial(cs.dense_apply, D, v)

        def plain():
            out = cs.grouped_apply(D, v)
            return out if r is None else r - out

        def sparse():
            """One CSR SpMM for the shared D: the entries of v as columns,
            the result a (transposed) view; addmm for the residual."""
            A = stencil_csr(torch, D)
            V = v.reshape(B or 1, -1).T
            if r is None:
                return lambda: torch.sparse.mm(A, V).T
            R = r.reshape(B or 1, -1).T
            return lambda: torch.sparse.addmm(R, A, V, alpha=-1).T

        name = row or f"{'B7b' if tiled else 'B7a'}{'-r' if resid else ''}"
        entries = B or E or 1
        return [Case(kern, f"{name} {'residual' if resid else 'apply'} {tag}",
                     dtype, call, plain,
                     glob if tiled and tile is None else None,
                     work(kern, n, L, v.element_size(), entries, E or 1),
                     None if E else sparse, batch)]

    def restrict_cases(L, tag, dtype, nc=4, bx=2, by=2, quads=(1,),
                       batch=1, shared_r=False):
        """B2 fused with the restriction of its output, at each quadrant of
        `quads`: phi [batch?, 2, L, L], r batched or shared, U and phi_null
        [nc, 2, L, L] shared; beside it (fg) the unfused path, B2 then the
        plain restriction."""
        lead = (batch,) if batch > 1 else ()
        U, phi = links(L, dtype), c(lead + (2, L, L), dtype)
        r = c((2, L, L) if shared_r else lead + (2, L, L), dtype)
        pn = c((nc, 2, L, L), dtype)
        out = []
        for quad in quads:
            out.append(Case(
                "links_residual_restrict",
                f"B2+R residual-restrict {tag} nc={nc} {bx}x{by} quad {quad}",
                dtype,
                functools.partial(cs.wilson_u_residual_restrict, U, m, phi, r,
                                  pn, quad, bx, by),
                lambda q=quad: mgt.ops.transfer.restrict(
                    pn, gs.residual_u("wilson", U, m, phi, r), q, bx, by),
                lambda q=quad: mgt.ops.transfer.restrict(
                    pn, cs.wilson_u_residual(U, m, phi, r), q, bx, by),
                work("links_residual_restrict", 2, L, phi.element_size(),
                     batch, 1 if shared_r else batch, nc=nc, block=bx * by),
                None, batch, NO_LIBRARY_RESTRICT))
        return out

    def links_apply_cases(L, tag, dtype, tiled, tile=None, row=None):
        """The links SpMV D_U v: B8 (global) or B5c (x-tiled); row: the
        label's first word where it is not the kernel's own."""
        U, v = links(L, dtype), c((2, L, L), dtype)
        fn = (functools.partial(cs.wilson_u_apply_tiled, tile=tile) if tiled
              else cs.wilson_u_apply)
        kern = "links_apply_tiled" if tiled else "links_apply"

        def spmm():
            A = links_op(U)()
            return lambda: torch.sparse.mm(A, v.reshape(-1, 1))

        return [Case(kern, f"{row or ('B5c' if tiled else 'B8')} apply {tag}",
                     dtype,
                     lambda: fn(U, m, v), lambda: gs.apply_wilson_u(U, m, v),
                     (lambda: cs.wilson_u_apply(U, m, v)) if tiled and tile is None
                     else None, work(kern, 2, L, v.element_size()), spmm)]

    def links_residual_cases(L, tag, dtype, row):
        """The unfused B2 alone, r - D_U phi."""
        U, phi, r = links(L, dtype), c((2, L, L), dtype), c((2, L, L), dtype)

        def addmm():
            A = links_op(U)()
            return lambda: torch.sparse.addmm(r.reshape(-1, 1), A,
                                              phi.reshape(-1, 1), alpha=-1)

        return [Case("links_residual", f"{row} residual {tag}", dtype,
                     lambda: cs.wilson_u_residual(U, m, phi, r),
                     lambda: gs.residual_u("wilson", U, m, phi, r), None,
                     work("links_residual", 2, L, phi.element_size()),
                     addmm)]

    def norm_cases(L, tag, dtype, batch=1, row="B2-norm"):
        """The level-0 check ||b - D_U phi|| / ||b|| in one launch, b
        batched like phi, against its plain composition; row: the label's
        first word."""
        lead = (batch,) if batch > 1 else ()
        U = links(L, dtype)
        phi, b = c(lead + (2, L, L), dtype), c(lead + (2, L, L), dtype)
        return [Case("links_residual_norm", f"{row} check {tag}", dtype,
                     lambda: cs.wilson_u_residual_norm(U, m, phi, b),
                     lambda: gs.residual_norm_ratio_u("wilson", U, m, phi, b),
                     None, work("links_residual_norm", 2, L,
                                phi.element_size(), batch, batch),
                     None, batch, NO_LIBRARY_NORM)]

    def dense_cases(B, n, L, shared, tag, kinds, dtype, tiled, tile=None,
                    sweeps=4, omega=1.0):
        D, Dinv = dense(None if shared else B, n, L, dtype)
        lead = (B,) if B else ()
        phi = c(lead + (n, L, L), dtype)
        r = c((n, L, L) if shared else lead + (n, L, L), dtype)
        fn = (functools.partial(cs.dense_smooth_tiled, tile=tile) if tiled
              else cs.dense_smooth)
        kern = "dense_update_tiled" if tiled else "dense_update"
        om = "" if omega == 1.0 else f" omega={omega}"
        out = []
        for kind in kinds:
            name = ("B6 " if tiled else ("B3 " if kind == "rbgs" else "B4 ")
                    ) + f"{kind} x{sweeps}{om} {tag}"
            out.append(Case(
                kern, name, dtype,
                lambda k=kind: fn(D, Dinv, phi, r, sweeps, k, omega),
                lambda k=kind: sm.smooth_plain(D, Dinv, phi, r, sweeps, k,
                                               omega),
                (lambda k=kind: cs.dense_smooth(D, Dinv, phi, r, sweeps, k,
                                                omega))
                if tiled and tile is None else None,
                work(kern, n, L, phi.element_size(), B or 1,
                     1 if shared or not B else B, sweeps)))
        return out

    cases = []
    for dtype in (torch.complex64, torch.complex128):
        # the flagship (L=256) on the global kernels: level 0's residual
        # fused with its restriction (unbatched, then the batch of 8), the
        # dense residual of level 1 (then level 2 and the batch of 8 on the
        # shared D) and the min-res apply on the 4 copies (then the SpMV of
        # MR and CGNR and an ensemble's min-res, 4 copies a configuration)
        cases += restrict_cases(256, "L=256", dtype)
        cases += restrict_cases(256, "L=256 batch 8", dtype, batch=8)
        cases += apply_cases(None, None, 4, 128, "n=4 L=128 (level 1)", dtype,
                             tiled=False, resid=True)
        cases += apply_cases(None, None, 4, 64, "n=4 L=64 (level 2)", dtype,
                             tiled=False, resid=True)
        cases += apply_cases(None, 8, 4, 128, "n=4 L=128 batch 8 shared D",
                             dtype, tiled=False, resid=True, batch=8)
        cases += apply_cases(None, 4, 4, 64, "n=4 L=64 x4 shared D (min-res)",
                             dtype, tiled=False)
        cases += apply_cases(None, None, 2, 256, "n=2 L=256 (MR, CGNR)",
                             dtype, tiled=False, row="B7a@MR")
        cases += apply_cases(8, 32, 4, 64, "n=4 L=64 x32 on 8 D (ensemble "
                             "min-res)", dtype, tiled=False)
        cases += links_cases(256, "L=256", dtype, tiled=False)
        # (batch, n, L, D shared by the batch?, label, kinds)
        for B, n, L, shared, tag, kinds in [
                (None, 4, 128, False, "n=4 L=128 (level 1)", ("rbgs", "jacobi")),
                (None, 4, 64, False, "n=4 L=64 (level 2)", ("rbgs",)),
                (4, 4, 32, False, "n=4 L=32 batch 4 (NTL copies)", ("rbgs",)),
                (2, 2, 256, True, "n=2 L=256 k=2 shared D (setup)", ("rbgs",)),
                (2, 4, 128, True, "n=4 L=128 k=2 shared D (setup)", ("rbgs",))]:
            cases += dense_cases(B, n, L, shared, tag, kinds, dtype,
                                 tiled=False)
        # the persistent smoothers' edges: 1 and 3 sweeps, omega 0.8, a
        # lattice with fewer x-rows than blocks (L=8), and streamed
        # operands (n=4 L=1024: no band fits the shared memory)
        for sweeps, omega in ((1, 1.0), (3, 1.0), (4, 0.8)):
            cases += links_cases(256, "L=256", dtype, tiled=False,
                                 sweeps=sweeps, omega=omega, resid=False)
            cases += dense_cases(None, 4, 128, False, "n=4 L=128",
                                 ("rbgs", "jacobi"), dtype, tiled=False,
                                 sweeps=sweeps, omega=omega)
        cases += links_cases(8, "L=8", dtype, tiled=False, resid=False)
        cases += dense_cases(3, 4, 8, False, "n=4 L=8 batch 3",
                             ("rbgs", "jacobi"), dtype, tiled=False)
        cases += dense_cases(None, 4, 1024, False,
                             "n=4 L=1024 (streamed operands)",
                             ("rbgs",), dtype, tiled=False)
        # the large flagship (L=2048) on the x-tiled kernels
        cases += links_cases(2048, "L=2048", dtype, tiled=True)
        for B, n, L, shared, tag, kinds in [
                (None, 4, 1024, False, "n=4 L=1024 (level 1)", ("rbgs", "jacobi")),
                (None, 4, 512, False, "n=4 L=512 (level 2)", ("rbgs",)),
                (None, 4, 256, False, "n=4 L=256 (level 3)", ("rbgs",)),
                (2, 2, 2048, True, "n=2 L=2048 k=2 shared D (setup)", ("rbgs",))]:
            cases += dense_cases(B, n, L, shared, tag, kinds, dtype,
                                 tiled=True)
        # tiles forced small: several tiles, the periodic wrap, ragged tiles
        cases += links_cases(32, "L=32 tile 8x8", dtype, tiled=True,
                             tile=(8, 8))
        cases += dense_cases(4, 4, 32, False, "n=4 L=32 batch 4 tile 8x8",
                             ("rbgs", "jacobi"), dtype, tiled=True,
                             tile=(8, 8))
        cases += dense_cases(2, 2, 32, True, "n=2 L=32 k=2 shared tile 6x12",
                             ("rbgs",), dtype, tiled=True, tile=(6, 12))
        # the fused red-black pass's edges: 1 and 3 sweeps, omega 0.8,
        # ragged 3 x 5 and 6 x 12 tiles, a batch with its own operators
        for sweeps, omega in ((1, 1.0), (3, 1.0), (4, 0.8)):
            cases += links_cases(32, "L=32 tile 6x12", dtype, tiled=True,
                                 tile=(6, 12), sweeps=sweeps, omega=omega,
                                 resid=False)
            cases += dense_cases(3, 4, 32, False, "n=4 L=32 batch 3 tile 3x5",
                                 ("rbgs", "jacobi"), dtype, tiled=True,
                                 tile=(3, 5), sweeps=sweeps, omega=omega)
        # the SpMV path: the first case of each kernel is its main shape
        cases += apply_cases(4, 4, 4, 32, "n=4 L=32 batch 4", dtype,
                             tiled=False)
        cases += links_apply_cases(256, "L=256", dtype, tiled=False)
        cases += apply_cases(None, None, 2, 2048,
                             "n=2 L=2048 (stencil stream)", dtype, tiled=True)
        cases += apply_cases(None, None, 4, 1024, "n=4 L=1024", dtype,
                             tiled=True)
        cases += links_apply_cases(2048, "L=2048", dtype, tiled=True)
        if dtype == torch.complex64:
            cases += apply_cases(None, None, 2, 4096, "n=2 L=4096", dtype,
                                 tiled=True)
            cases += links_apply_cases(4096, "L=4096", dtype, tiled=True)
        # the large flagship's x-tiled dense residuals (levels 1-2), then
        # groups: 4 entries a copy of D, and D shared by a batch
        cases += apply_cases(None, None, 4, 1024, "n=4 L=1024 (level 1)",
                             dtype, tiled=True, resid=True)
        cases += apply_cases(None, None, 4, 512, "n=4 L=512 (level 2)", dtype,
                             tiled=True, resid=True)
        cases += apply_cases(None, 2, 4, 1024, "n=4 L=1024 batch 2 shared D",
                             dtype, tiled=True, resid=True, batch=2)
        for tile in ((8, 8), (6, 12)):
            tag = f"L=32 tile {tile[0]}x{tile[1]}"
            cases += apply_cases(4, 4, 4, 32, "n=4 batch 4 " + tag, dtype,
                                 tiled=True, tile=tile)
            cases += apply_cases(None, None, 2, 32, "n=2 " + tag, dtype,
                                 tiled=True, tile=tile)
            cases += apply_cases(2, 8, 4, 32, "n=4 x8 on 2 D " + tag, dtype,
                                 tiled=True, tile=tile, resid=True)
            cases += apply_cases(None, 3, 2, 30, "n=2 x3 shared D L=30 "
                                 + tag, dtype, tiled=True, tile=tile,
                                 resid=True)
            cases += links_apply_cases(32, tag, dtype, tiled=True, tile=tile)
        # the fused residual-restriction at every quadrant, nc 1 and 2,
        # 4 x 4 and 4 x 2 blocks, ragged coarse tiles (L=36: 18 coarse
        # columns; L=68: 17), r shared by a batch; the dense residual and
        # apply in groups of 1, 4 and the whole batch, n = 1 and 2
        cases += restrict_cases(256, "L=256", dtype, quads=(2, 3, 4))
        cases += restrict_cases(36, "L=36 batch 3 shared r", dtype, nc=2,
                                quads=(1, 2, 3, 4), batch=3, shared_r=True)
        cases += restrict_cases(68, "L=68", dtype, nc=1, bx=4, by=4,
                                quads=(1, 3))
        cases += restrict_cases(24, "L=24 batch 2", dtype, bx=4, by=2,
                                quads=(2, 4), batch=2)
        for E, B, n, L in ((None, 8, 2, 64), (2, 8, 4, 32), (16, 16, 4, 32),
                           (3, 6, 1, 10)):
            for resid in (False, True):
                cases += apply_cases(E, B, n, L, f"n={n} L={L} x{B} on "
                                     f"{E or 1} D", dtype, tiled=False,
                                     resid=resid)
        # a batch of right-hand sides on shared links (B1, B2, B5a, B5b):
        # the batched main shapes first (B=8 at L=256, B=2 at L=2048), then
        # an odd batch, 1 and 3 sweeps, omega 0.8, r shared by the batch, a
        # band over several x rows (L=8) and ragged tiles
        cases += links_cases(256, "L=256 batch 8", dtype, tiled=False,
                             batch=8)
        cases += links_cases(2048, "L=2048 batch 2", dtype, tiled=True,
                             batch=2)
        for sweeps, omega in ((1, 1.0), (3, 1.0), (4, 0.8)):
            cases += links_cases(256, "L=256 batch 3", dtype, tiled=False,
                                 sweeps=sweeps, omega=omega, batch=3,
                                 resid=sweeps == 1)
            cases += links_cases(32, "L=32 batch 3 tile 6x12", dtype,
                                 tiled=True, tile=(6, 12), sweeps=sweeps,
                                 omega=omega, batch=3, resid=sweeps == 1)
        cases += links_cases(256, "L=256 batch 3 shared r", dtype,
                             tiled=False, batch=3, shared_r=True, sweeps=3)
        cases += links_cases(8, "L=8 batch 8", dtype, tiled=False, batch=8)
        cases += links_cases(32, "L=32 batch 8 shared r tile 3x5", dtype,
                             tiled=True, tile=(3, 5), batch=8, shared_r=True,
                             sweeps=3)
        # B8 and B2 at the largest lattices that take the global kernels
        # (apply_mode, u_mode), and the level-0 check (its main shape first;
        # also at the large flagship's x-tiled level 0)
        cases += links_apply_cases(1024, "L=1024", dtype, tiled=False,
                                   row="B8-L1024")
        cases += links_residual_cases(512, "L=512", dtype, row="B2-L512")
        cases += norm_cases(256, "L=256", dtype)
        cases += norm_cases(256, "L=256 batch 8", dtype, batch=8)
        cases += norm_cases(10, "L=10", dtype)
        cases += norm_cases(2048, "L=2048", dtype, row="check-L2048")
    return cases


def flagship(torch, mgt, dev, dtype="complex64", L=256, nlevels=3,
             null_iters=100, res_threshold=1e-6):
    """The config of bench.py's solve256 phase at lattice L with `nlevels`
    levels, and its two gauges: (cfg, [(phases, U, D), (phases, U, D)])."""
    cfg = mgt.MGConfig(L=L, stencil="wilson", m=-0.005, nlevels=nlevels,
                       ntl=True, num_iters=4, null_iters=null_iters,
                       dtype=dtype, res_threshold=res_threshold,
                       smoother="rbgs")
    rng = np.random.default_rng(cfg.seed)
    gauges = []
    for _ in range(2):
        ph = 0.2 * rng.normal(size=(2, L, L))
        U = mgt.models.gauge.gauge_from_phases(ph, cfg.cdtype, dev)
        gauges.append((ph, U,
                       mgt.models.operators.assemble(cfg.stencil, U, cfg.m)))
    return cfg, gauges


def timed(torch, fn):
    """(fn(), host seconds), synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def library_time(torch, case, want):
    """(ms, what) of the one PyTorch call that computes the case's function
    (built outside the timing), or (None, why there is none)."""
    if case.library is None:
        return None, case.no_library
    try:
        call = case.library()
        got = call()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        return None, f"not supported: {type(e).__name__}: {str(e)[:160]}"
    rel = float((got.reshape(want.shape) - want).abs().max()
                / want.abs().max())
    what = ("torch.sparse.addmm" if "residual" in case.kernel
            else "torch.sparse.mm") + f" (CSR, int32; rel diff {rel:.1e})"
    ms = cuda_ms(torch, call)
    del call
    return ms, what


def library_device_us(torch, case, flush):
    """Device microseconds a call of the case's library call takes from a
    cold L2 (device_us), or None where it does not run."""
    try:
        call = case.library()
        call()
    except (RuntimeError, NotImplementedError):
        return None
    us = device_us(torch, call, flush=flush)
    del call
    return us


def device_us(torch, fn, calls=10, flush=None, tries=3):
    """Microseconds of device time a call of fn under torch.profiler, or
    None where none of `tries` profiles was whole. A profile of one call
    gives fn's device events by name; a profile of `calls` calls is whole
    when each of those names came back `calls` times as often and no other
    did (the profiler has dropped events in some runs). flush: run before
    every call and left out of the sum (its events, from a profile of it
    alone, must share no name with fn's): each call then starts from a
    cold L2, and its time can be held against a bound at the HBM rate."""
    from torch.profiler import ProfilerActivity, profile

    def events(n, run_fn=True, run_flush=flush is not None):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            for _ in range(n):
                if run_flush:
                    flush()
                if run_fn:
                    fn()
            torch.cuda.synchronize()
        return device_events(p)

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        one = events(1, run_flush=False)[1]
        skip = (events(1, run_fn=False)[1] if flush is not None
                else collections.Counter())
        check(not set(one) & set(skip), f"the L2 flush shares a kernel with "
              f"the call it flushes for: {set(one) & set(skip)}")
        us, n = events(calls)
        if one and n == collections.Counter(
                {k: c * calls for k, c in (one + skip).items()}):
            return sum(t for k, t in us.items() if k not in skip) / calls
    return None


def fmt_us(us):
    return "not measured (events dropped)" if us is None else f"{us:.2f} us"


def run_kernel_cases(torch, mgt, dev):
    """Each kernel against its plain version (and a tiled kernel beside the
    global one) at the paths' shapes. Returns the per-kernel entries of the
    kernels line (complex64: the main shape's times, device time, bound and
    library call; for the links kernels also the batched main shape's
    under "batched"), the tiled-vs-global times, and the rows of the
    kernel table (B1 ... B8, and each batch of the links kernels): the
    first complex64 case of each, with its device time and bound. Device
    time is read twice: warm (calls back to back, operands that fit the
    50 MB L2 stay there) and cold (the L2 flushed before each call by
    rewriting L2_FLUSH_BYTES), the time that the bound at the HBM rate
    holds for; rule 2's share is the bound over the cold time. The floor
    beside them: the device time of a one-element zero_() (a kernel that
    does nothing), and for the rows of FLOOR_KERNELS the cold device time of
    a copy moving the row's least bytes (dst.copy_(src), src half of
    them)."""
    cs = mgt.ops.cuda_stencil
    peak = mgt.profiling.peak_bandwidth()
    flush_buf = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                            device=dev)
    one = torch.zeros(1, device=dev)
    floor = {"zero_one_element_us": device_us(torch, one.zero_)}
    print(f"  floor: a one-element zero_() takes "
          f"{fmt_us(floor['zero_one_element_us'])} on the device")
    per_kernel = {k: {"max_abs_err": 0.0, "ms": None, "plain_ms": None}
                  for k in REPLACES}
    vs_global = []
    rows = {}
    for case in kernel_cases(torch, mgt, dev):
        kern, label, fk, fp, fg = (case.kernel, case.label, case.fk, case.fp,
                                   case.fg)
        bands = {k: dict(v) for k, v in cs.band_launches.items()}
        got, want = fk(), fp()
        torch.cuda.synchronize()
        mode = [m for k, v in cs.band_launches.items()
                for m, c in v.items() if c != bands[k][m]]
        abs_err = float((got - want).abs().max())
        rel = abs_err / float(want.abs().max())
        ms, plain_ms = cuda_ms(torch, fk), cuda_ms(torch, fp)
        dt = str(case.dtype).replace("torch.", "")
        line = (f"  {kern:20s} {label:48s} {dt:10s} rel_err {rel:.3e} "
                f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms"
                + (f"  ({mode[0]} operands)" if mode else ""))
        check(rel < BARS[dt], f"{kern} {label} {dt}: rel err {rel:.3e} "
              f">= {BARS[dt]}")
        if fg is not None:
            g_rel = float((fg() - want).abs().max()) / float(want.abs().max())
            g_ms = cuda_ms(torch, fg)
            line += f"  global {g_ms:.4f} ms (rel_err {g_rel:.3e})"
            check(g_rel < BARS[dt], f"global kernel at {label} {dt}: rel err "
                  f"{g_rel:.3e}")
            vs_global.append({"kernel": kern, "case": label, "dtype": dt,
                              "ms": ms, "global_ms": g_ms,
                              "plain_ms": plain_ms})
        e = per_kernel[kern]
        key = label.split()[0] + (f" batch {case.batch}" if case.batch > 1
                                  else "")
        if dt != "complex64" and kern in FLOOR_KERNELS:
            key += f" {dt}"                  # these rows in both dtypes
        if (dt == "complex64" or kern in FLOOR_KERNELS) and key not in rows:
            # a row's first case
            nbytes, flops = case.work
            bound_s, bound_by = mgt.profiling.bound_seconds(
                nbytes, flops, peak, PEAK_FLOPS[dt])
            dev_us = device_us(torch, fk)
            cold_us = device_us(torch, fk, flush=flush_buf.bitwise_not_)
            # cold from a flush that only reads: the L2 then holds clean
            # lines, and the call's misses write nothing back
            clean_us = device_us(torch, fk, flush=flush_buf.sum)
            share = None if cold_us is None else bound_s * 1e6 / cold_us
            row = dict(ms=ms, plain_ms=plain_ms, case=label, dtype=dt,
                       rel_err=rel, device_us=dev_us, device_us_cold=cold_us,
                       device_us_cold_clean=clean_us,
                       bound_ms=bound_s * 1e3, bound_by=bound_by,
                       bound_share_cold=share)
            if kern in FLOOR_KERNELS:
                src = torch.empty(nbytes // 8, dtype=torch.int32, device=dev)
                dst = torch.empty_like(src)
                copy_us = device_us(torch, lambda: dst.copy_(src),
                                    flush=flush_buf.bitwise_not_)
                row.update(copy_bytes=2 * src.nbytes, copy_us_cold=copy_us,
                           cold_over_copy=None if None in (cold_us, copy_us)
                           else cold_us / copy_us)
                del src, dst
                row["library_ms"], row["library"] = library_time(torch, case,
                                                                 want)
            if kern == "links_residual_restrict":
                # the unfused path it replaces: B2, then the restriction
                row.update(unfused_ms=cuda_ms(torch, fg),
                           unfused_device_us=device_us(torch, fg),
                           unfused_device_us_cold=device_us(
                               torch, fg, flush=flush_buf.bitwise_not_))
            if case.library is not None:
                row["library_device_us_cold"] = library_device_us(
                    torch, case, flush_buf.bitwise_not_)
            rows[key] = dict(row, kernel=kern)
            line += (f"\n    row {key}: device {fmt_us(dev_us)} a call "
                     f"warm, {fmt_us(cold_us)} cold ({fmt_us(clean_us)} "
                     f"after a read-only flush); bound "
                     f"{bound_s * 1e3:.4f} ms ({bound_by})"
                     + ("" if share is None else
                        f", {share:.2f} of it cold"))
            if "library_device_us_cold" in row:
                line += (f"\n    library call: "
                         f"{fmt_us(row['library_device_us_cold'])} cold on "
                         "the device")
            if "copy_us_cold" in row:
                line += (f"\n    floor: a copy of the same "
                         f"{row['copy_bytes'] / 1e6:.2f} MB "
                         f"{fmt_us(row['copy_us_cold'])} cold"
                         + ("" if row["cold_over_copy"] is None else
                            f"; the call {row['cold_over_copy']:.2f} x it")
                         + "; library " + (row["library"]
                                           if row["library_ms"] is None else
                                           f"{row['library_ms']:.4f} ms, "
                                           f"{row['library']}"))
            if "unfused_ms" in row:
                line += (f"\n    unfused (B2 + restrict): "
                         f"{row['unfused_ms']:.4f} ms, device "
                         f"{fmt_us(row['unfused_device_us'])} warm, "
                         f"{fmt_us(row['unfused_device_us_cold'])} cold")
        main = e["ms"] is None if case.batch == 1 else "batched" not in e
        if dt == "complex64" and main:   # the (batched) main shape
            row = {k: v for k, v in rows[key].items()
                   if k not in ("kernel", "library_ms", "library")}
            if case.batch == 1:
                lib_ms, lib = library_time(torch, case, want)
                e.update(row, library_ms=lib_ms, library=lib)
                what = "main shape"
            else:
                e["batched"] = dict(row, batch=case.batch)
                what = "batched main shape"
            line += f"\n    {what}" + ("" if case.batch > 1 else "; library "
                                       + (lib if lib_ms is None
                                          else f"{lib_ms:.4f} ms, {lib}"))
        if dt == "complex64":
            e["max_abs_err"] = max(e["max_abs_err"], abs_err)
        print(line)
    del flush_buf
    rows["floor"] = floor
    return per_kernel, vs_global, rows


def cycle_launches(torch, mgt, dev, cfg, hier, ms_per_cycle, want, tag,
                   first_design_ops=None, b=None):
    """One cycle with the launch counters set to 0 just before it and read
    just after: exactly want[k] launches of each kernel k of `want`. The
    profiler gives the cycle's device ops and device time; the idle share
    is taken against the unprofiled ms_per_cycle. b: the right-hand side
    (default the point source), [B, n, L, L] for a batched cycle."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    cs = mgt.ops.cuda_stencil
    if b is None:
        b = mgt.point_source(cfg, device=dev)
    batch = b.shape[0] if b.dim() == 4 else None
    phis, _ = mgt.cycle(hier, mgt.zero_fields(cfg, dev, batch), b, cfg)
    torch.cuda.synchronize()
    cs.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        mgt.cycle(hier, phis, b, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    counts = {k: v for k, v in cs.launches.items() if v}
    events = [e for e in p.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(getattr(e, "device_time_total", None)
                  or getattr(e, "cuda_time_total", 0.0) for e in events)
    top = device_time_by_name(p).most_common(8)
    out = {"port_launches": counts, "device_ops": len(events),
           "device_ms": busy_us / 1e3,
           "wall_ms_profiled": wall * 1e3,
           "idle_share": 1 - busy_us / 1e3 / ms_per_cycle,
           "top_device_us": [[name[:80], us] for name, us in top]}
    if first_design_ops is not None:
        out["first_design_device_ops"] = first_design_ops
    print(f"  one {tag} cycle: kernel launches {counts}; profiler "
          f"{len(events)} device ops"
          + ("" if first_design_ops is None else
             f" (first design, on record: {first_design_ops})")
          + f", {busy_us / 1e3:.4f} ms of device time, idle "
          f"{out['idle_share']:.3f} of the {ms_per_cycle:.3f} ms cycle")
    for name, us in top:
        print(f"    {us:9.1f} us  {name[:80]}")
    check(all(counts.get(k, 0) == n for k, n in want.items()),
          f"a {tag} cycle launched {counts}: want {want}")
    return out


def solve_phase(torch, mgt, dev, cfg, gauges, kernels, max_cycles, n_cyc,
                reps, warm_check):
    """Setup (first gauge, with the host checks) and solve_chunked(chunk=1)
    through the entry points, with the launch counters set to 0 before the
    setup; then a warm setup on the second gauge (freed at once), ms per
    cycle on the kernels and on the plain versions, and the plain path's
    cycle count on the same hierarchy. Returns (hier, summary, launches)."""
    cs = mgt.ops.cuda_stencil
    (_, U, D), (_, Ub, Db) = gauges
    b = mgt.point_source(cfg, device=dev)
    tag = f"L={cfg.L} nlevels={cfg.nlevels}"
    cs.reset_launches()
    hier, t_setup = timed(torch, lambda: mgt.build_hierarchy(D, cfg, U=U))
    setup_launches = dict(cs.launches)
    out, t_solve = timed(torch, lambda: mgt.solve_chunked(
        hier, b, cfg, max_iters=max_cycles, chunk=1))
    launches = dict(cs.launches)
    solve_launches = {k: launches[k] - setup_launches[k] for k in launches}
    print(f"flagship {tag} NTL x{cfg.n_copies} {cfg.dtype}: setup "
          f"{t_setup:.3f} s (first gauge, with the host checks); "
          f"{out.iters} cycles to {out.resmag:.3e} in {t_solve:.3f} s")
    print(f"  launches in setup {setup_launches}; in solve {solve_launches}")
    check(math.isfinite(out.resmag), f"{tag}: residual {out.resmag}")
    check(out.converged and out.iters <= max_cycles,
          f"{tag} did not reach {cfg.res_threshold} in {max_cycles} cycles "
          f"({out.iters}, {out.resmag:.3e})")
    check(tuple(out.phi.shape) == (2, cfg.L, cfg.L)
          and out.phi.dtype == torch.complex64, f"{tag}: solution shape")
    check(bool(torch.isfinite(torch.view_as_real(out.phi)).all()),
          f"{tag}: solution not finite")
    for k in kernels:
        check(solve_launches[k] > 0, f"{tag}: solve never launched {k}")

    _, t_warm = timed(torch, lambda: mgt.build_hierarchy(
        Db, cfg, U=Ub, check=warm_check))

    def cycles(c):
        phis = mgt.zero_fields(c, dev)
        for _ in range(n_cyc):
            phis, _ = mgt.cycle(hier, phis, b, c)

    plain_cfg = cfg.replace(pallas="off")
    ms_cycle = cuda_ms(torch, lambda: cycles(cfg), reps=reps) / n_cyc
    ms_plain = cuda_ms(torch, lambda: cycles(plain_cfg), reps=reps) / n_cyc
    plain = mgt.solve_chunked(hier, b, plain_cfg, max_iters=max_cycles,
                              chunk=1)
    print(f"  setup warm (second gauge{'' if warm_check else ', check=False'})"
          f" {t_warm:.3f} s; per cycle {ms_cycle:.3f} ms on the kernels, "
          f"{ms_plain:.3f} ms on the plain versions (CUDA events, median of "
          f"{reps} x {n_cyc} cycles)")
    print(f"  plain path on the same hierarchy: {plain.iters} cycles to "
          f"{plain.resmag:.3e}")
    check(plain.converged and abs(plain.iters - out.iters) <= 1,
          f"{tag}: kernel path {out.iters} cycles vs plain path {plain.iters}")
    summary = {"L": cfg.L, "nlevels": cfg.nlevels, "cycles": out.iters,
               "res": out.resmag, "setup_s": t_setup, "setup_warm_s": t_warm,
               "solve_s": t_solve, "ms_per_cycle": ms_cycle,
               "ms_per_cycle_plain": ms_plain, "plain_cycles": plain.iters,
               "launches_setup": setup_launches,
               "launches_solve": solve_launches}
    return hier, summary, launches


@contextlib.contextmanager
def patched(owner, name, value):
    """owner.name = value while the block runs."""
    orig = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, orig)


def ir_phase(torch, mgt, dev, cfg, phases, hier):
    """solve_ir on the complex64 hierarchy with the exact complex128
    level-0 operator (assembled from the same phases) to 1e-8 and 1e-13,
    two inner cycles per outer step; its outer residual on the dense
    residual kernels and on the plain stencil.residual, in
    turns (kernel, plain, plain, kernel; the faster run of each), with the
    counts equal and one outer residual launch an outer step."""
    cfg128 = cfg.replace(dtype="complex128")
    U128 = mgt.models.gauge.gauge_from_phases(phases, cfg128.cdtype, dev)
    D_outer = mgt.models.operators.assemble(cfg.stencil, U128, cfg.m)
    del U128
    b = mgt.point_source(cfg128, device=dev)
    cs = mgt.ops.cuda_stencil
    plain_outer = types.SimpleNamespace(residual=mgt.ops.stencil.residual)
    key = "dense_residual" + (
        "_tiled" if cs.apply_mode(2, cfg.L, torch.complex128) == "tiled"
        else "")
    summary = {}
    for thr in (1e-8, 1e-13):
        def run():
            return mgt.solve_ir(hier, b, cfg128.replace(res_threshold=thr),
                                inner_cycles=2, max_iters=200,
                                D_outer=D_outer)
        secs = {"kernel": [], "plain": []}
        for design in ("kernel", "plain", "plain", "kernel"):
            n0 = cs.launches[key]
            with patched(mgt.solver.driver, "cuda_stencil",
                         cs if design == "kernel" else plain_outer):
                res, sec = timed(torch, run)
            secs[design].append(sec)
            if design == "kernel":
                out, n_kernel = res, cs.launches[key] - n0
            else:
                ref, n_plain = res, cs.launches[key] - n0
        sec, sec_plain = min(secs["kernel"]), min(secs["plain"])
        # the outer residual's launches: the kernel run's less the plain
        # run's (whose cycles make the same coarse-level launches)
        n_outer = n_kernel - n_plain
        print(f"  solve_ir to {thr:g}: {len(out.history)} outer steps, "
              f"{out.iters} cycles, res {out.resmag:.3e}, {sec:.3f} s; with "
              f"the plain outer residual {ref.iters} cycles, "
              f"{sec_plain:.3f} s")
        check(ref.iters == out.iters and n_outer == len(out.history),
              f"solve_ir to {thr:g}: {out.iters} cycles and {n_outer} {key} "
              f"launches for {len(out.history)} outer steps; {ref.iters} "
              "cycles with the plain outer residual")
        check(out.converged, f"solve_ir did not reach {thr:g} "
              f"({out.iters} cycles, {out.resmag:.3e})")
        check(out.phi.dtype == torch.complex128
              and bool(torch.isfinite(torch.view_as_real(out.phi)).all()),
              "solve_ir solution not finite complex128")
        summary[f"{thr:g}"] = {"outer_steps": len(out.history),
                               "cycles": out.iters, "res": out.resmag,
                               "seconds": sec,
                               "seconds_plain_outer": sec_plain,
                               "seconds_turns": secs,
                               "outer_residual_launches": n_outer}
    return summary


def check_phase(torch, mgt, dev, cfg, hier, reps=30, rounds=3):
    """The level-0 convergence check (residual_norm_ratio0) on a flagship's
    level 0, after two cycles from zero, by both compositions: the residual
    (B2, or B5b on the x-tiled level 0, through _residual0), then the two
    float64 norms; and the one launch (wilson_u_residual_norm). For each:
    its device ops (a profiled check with its read-back), its device
    microseconds (device_us, warm) and host microseconds a check (`reps`
    checks with read-back a turn, `rounds` rounds of turns); the one launch against
    the plain composition and its bits over 3 calls; then ms a checked
    cycle, solve_chunked(chunk=1) to the flagship's threshold with each
    check in turns, and the device ops of one checked cycle. Returns the
    summary."""
    from torch.profiler import ProfilerActivity, profile
    from torch.autograd import DeviceType
    cy = mgt.solver.cycles
    b = mgt.point_source(cfg, device=dev)
    phis = mgt.zero_fields(cfg, dev)
    for _ in range(2):
        phis, _ = mgt.cycle(hier, phis, b, cfg)
    phi = phis[0]

    def two_norms(h, p, q, c):
        return mgt.ops.stencil.norm_ratio(
            cy._residual0(h.levels[0], p, q, c, 0, h.gauge), q)

    designs = {"two_norms": two_norms, "one_launch": cy.residual_norm_ratio0}
    order = ("two_norms", "one_launch", "one_launch", "two_norms")
    plain = mgt.ops.gauge_stencil.residual_norm_ratio_u(
        "wilson", hier.gauge, cfg.m, phi, b)
    got = [cy.residual_norm_ratio0(hier, phi, b, cfg) for _ in range(3)]
    rel = float(abs(got[0] - plain) / plain)
    same = all(torch.equal(g, got[0]) for g in got)
    rel_two = float(abs(got[0] - two_norms(hier, phi, b, cfg)) / plain)

    def device_ops(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as p:
            fn()
            torch.cuda.synchronize()
        return len([e for e in p.events() if e.device_type == DeviceType.CUDA])

    out = {k: {"device_ops": device_ops(
        lambda f=f: float(f(hier, phi, b, cfg))),
        "device_us": device_us(torch, lambda f=f: f(hier, phi, b, cfg))}
        for k, f in designs.items()}
    host = {k: [] for k in designs}
    for _ in range(rounds):
        for k in order:
            f = designs[k]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                float(f(hier, phi, b, cfg))
            host[k].append((time.perf_counter() - t0) / reps * 1e6)
    checked = {k: [] for k in designs}
    for _ in range(rounds):
        for k in order:
            with patched(mgt.solver.driver, "residual_norm_ratio0",
                         designs[k]):
                res, sec = timed(torch, lambda: mgt.solve_chunked(
                    hier, b, cfg, max_iters=30, chunk=1))
            checked[k].append(sec * 1e3 / res.iters)
            out[k]["cycles"] = res.iters
    for k, f in designs.items():
        def checked_cycle(f=f):
            ps, _ = mgt.cycle(hier, phis, b, cfg)
            return float(f(hier, ps[0], b, cfg))
        out[k].update(host_us=statistics.median(host[k]),
                      host_us_turns=host[k],
                      ms_per_checked_cycle=statistics.median(checked[k]),
                      ms_per_checked_cycle_turns=checked[k],
                      checked_cycle_device_ops=device_ops(checked_cycle))
    out.update(rel_vs_plain=rel, rel_vs_two_norms=rel_two,
               bits_equal_3_calls=same)
    for k in designs:
        o = out[k]
        print(f"  check L={cfg.L} ({k}): {o['device_ops']} device ops a check "
              f"with its read-back, {fmt_us(o['device_us'])} of device time, "
              f"{o['host_us']:.1f} us of host time a check; "
              f"checked cycle {o['ms_per_checked_cycle']:.3f} ms "
              f"({o['checked_cycle_device_ops']} device ops; "
              f"{o['cycles']} cycles)")
    print(f"  check: one launch against the plain composition rel "
          f"{rel:.3e}, against the two norms {rel_two:.3e}; the same bits "
          f"over 3 calls: {same}")
    check(rel < BARS[cfg.dtype] and same, f"the one-launch check: rel "
          f"{rel:.3e}, the same bits over 3 calls {same}")
    check(out["one_launch"]["cycles"] == out["two_norms"]["cycles"],
          f"the checked solve took {out['one_launch']['cycles']} cycles, "
          f"{out['two_norms']['cycles']} with the two-norm check")
    return out


def block8_phase(torch, mgt, dev, n_cyc=3):
    """The unfused B2's path: the flagship's config and first gauge with
    8 x 8 blocks (the reference program's `block` argument) and 2 levels,
    which the fused residual-restriction does not take: level 0's residual
    on B2, then the plain restriction. n_cyc cycles of
    solve_chunked(chunk=1) with the launch counters set to 0 just before
    the solve: one links_residual launch a cycle and one
    links_residual_norm a check. Returns (summary, launches)."""
    cs = mgt.ops.cuda_stencil
    cfg, ((_, U, D), _) = flagship(torch, mgt, dev, nlevels=2)
    cfg = cfg.replace(block_x=8, block_y=8)
    hier = mgt.build_hierarchy(D, cfg, U=U, check=False)
    b = mgt.point_source(cfg, device=dev)
    cs.reset_launches()
    out, sec = timed(torch, lambda: mgt.solve_chunked(
        hier, b, cfg, max_iters=n_cyc, chunk=1))
    launches = dict(cs.launches)
    print(f"block8 L={cfg.L} 8 x 8 blocks, NTL x{cfg.n_copies}: {out.iters} "
          f"cycles to {out.resmag:.3e} in {sec:.3f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    check(math.isfinite(out.resmag) and out.resmag < 1.0
          and out.iters == n_cyc, f"block8: {out.iters} cycles to "
          f"{out.resmag:.3e}")
    check(launches["links_residual"] == n_cyc
          and launches["links_residual_norm"] == n_cyc
          and launches["links_residual_restrict"] == 0,
          f"block8: launches {launches} in {n_cyc} checked cycles")
    return {"cycles": out.iters, "res": out.resmag, "seconds": sec}, launches


def small_check(torch, mgt, dev):
    """Kernel path == plain path on a small complex128 problem."""
    small, ((_, Us, Ds), _) = flagship(torch, mgt, dev, dtype="complex128",
                                       L=32, nlevels=2, null_iters=16,
                                       res_threshold=1e-8)
    small = small.replace(links="on")
    bs = mgt.point_source(small, device=dev)
    res = {}
    for mode in ("auto", "off"):
        c = small.replace(pallas=mode)
        h = mgt.build_hierarchy(Ds, c, U=Us)
        res[mode] = mgt.solve(h, bs, c, max_iters=60)
    rel = float((res["auto"].phi - res["off"].phi).abs().max()
                / res["off"].phi.abs().max())
    print(f"small c128 L=32: kernels {res['auto'].iters} cycles, plain "
          f"{res['off'].iters} cycles, phi rel diff {rel:.3e}")
    check(res["auto"].converged and res["auto"].iters == res["off"].iters
          and rel < 1e-9, "kernel path disagrees with the plain path")


def spmv_phase(torch, mgt, dev, card):
    """profiling.roofline_table on Wilson L=2048 complex64 (bench.py's
    stencil-stream inputs) plus links-apply rows through
    wilson_u_apply_auto at L=256, 2048 and 4096, each beside the plain
    links apply. Returns (summary, launches)."""
    cs, prof = mgt.ops.cuda_stencil, mgt.profiling
    L, m = 2048, -0.07
    cfg = mgt.MGConfig(L=L, stencil="wilson", m=m, nlevels=1,
                       dtype="complex64")
    rng = np.random.default_rng(7)
    U = mgt.models.gauge.gauge_from_phases(
        0.2 * rng.normal(size=(2, L, L)), cfg.cdtype, dev)
    D = mgt.models.operators.assemble(cfg.stencil, U, cfg.m)
    v = torch.from_numpy(rng.normal(size=(2, L, L))
                         + 1j * rng.normal(size=(2, L, L))).to(dev, cfg.cdtype)
    peak = prof.peak_bandwidth()
    cs.reset_launches()
    tab = prof.roofline_table(cfg, D, v, reps=20)
    rows = [dict(r, L=L, n=2) for r in tab["rows"]]
    del D
    for Lu in (256, 2048, 4096):
        Uu = mgt.models.gauge.gauge_from_phases(
            0.2 * rng.normal(size=(2, Lu, Lu)), cfg.cdtype, dev)
        vu = torch.randn((2, Lu, Lu), dtype=cfg.cdtype, device=dev)
        nbytes = 6 * Lu * Lu * vu.element_size()
        tiled = cs.apply_mode(2, Lu, vu.dtype, links=True) == "tiled"
        for name, fn in (
                ("apply_wilson_u", mgt.ops.gauge_stencil.apply_wilson_u),
                ("links_apply_cuda_tiled" if tiled else "links_apply_cuda",
                 cs.wilson_u_apply_auto)):
            sec = prof.time_op(lambda U_, x, f=fn: f(U_, m, x), Uu, vu,
                               reps=20)
            rows.append(dict(vars(prof.RooflineRow(name, sec, nbytes)
                                  .finish(peak)), L=Lu, n=2))
    launches = dict(cs.launches)
    print(f"spmv: {tab['device']}, HBM peak {peak:.3e} B/s")
    for r in rows:
        r["bytes_per_s"] = r["bytes"] / r["sec"]
        r["streaming"] = r["bytes"] > 2 * L2_BYTES
        print(f"  {r['name']:24s} L={r['L']:5d} {r['sec'] * 1e3:9.4f} ms  "
              f"{r['bytes_per_s']:.3e} B/s  {r['bw_frac']:.3f} of peak"
              f"{'' if r['streaming'] else ' (in L2)'}")
        check(not r["streaming"] or r["bw_frac"] <= 1.05,
              f"spmv row {r['name']} L={r['L']} reads {r['bw_frac']:.3f} of "
              "the HBM peak on a streaming set")
    print(f"  launches {launches}")
    for k in SPMV_KERNELS:
        check(launches[k] > 0, f"spmv phase never launched {k}")
    print(json.dumps({"spmv": {"peak_bytes_per_s": peak, "rows": rows},
                      "card": card}))
    return {"rows": rows}, launches


def device_events(prof_obj):
    """(microseconds, number) of device events (kernels, copies) by name
    in a torch.profiler run; one stream, so the events do not overlap."""
    from torch.autograd import DeviceType
    us, n = collections.Counter(), collections.Counter()
    for e in prof_obj.events():
        if e.device_type == DeviceType.CUDA:
            us[e.name] += (getattr(e, "device_time_total", None)
                           or getattr(e, "cuda_time_total", 0.0))
            n[e.name] += 1
    return us, n


def device_time_by_name(prof_obj):
    """Microseconds of device time by event name in a torch.profiler run."""
    return device_events(prof_obj)[0]


def krylov_phase(torch, mgt, dev, flag_cfg, flag_hier):
    """MR, MG, EO-MR, CGNR with complex128 defect correction, and FGMRES
    through the package's entry points, each with the dense_apply launches
    it made. Returns (summary, launches over the phase)."""
    cs, native = mgt.ops.cuda_stencil, mgt.utils.native
    out = {}
    cs.reset_launches()

    def solve(tag, fn):
        before = cs.launches["dense_apply"]
        res, sec = timed(torch, fn)
        n = cs.launches["dense_apply"] - before
        check(n > 0, f"krylov {tag}: dense_apply never launched")
        return res, sec, n

    # 1. MR and MG on the flagship operator, complex128, to 1e-8
    cfg = flag_cfg.replace(dtype="complex128", res_threshold=1e-8)
    rng = np.random.default_rng(cfg.seed)
    U = mgt.models.gauge.gauge_from_phases(
        0.2 * rng.normal(size=(2, cfg.L, cfg.L)), cfg.cdtype, dev)
    D = mgt.models.operators.assemble(cfg.stencil, U, cfg.m)
    b = mgt.point_source(cfg, device=dev)
    (x, it, rel), sec, n = solve("mr", lambda: mgt.mr_solve(
        D, b, tol=1e-8, max_iters=300000, chunk=100))
    print(f"krylov mr_solve L={cfg.L} c128: {it} iterations to {rel:.3e} "
          f"in {sec:.3f} s ({n} dense_apply launches)")
    check(rel < 1e-8 and abs(it - 1200) <= 100,
          f"mr_solve took {it} iterations to {rel:.3e} (JAX: 1200)")
    out["mr"] = {"iters": it, "rel": rel, "seconds": sec, "launches": n}
    hier, t_setup = timed(torch, lambda: mgt.build_hierarchy(D, cfg,
                                                             check=False))
    mgo, t_mg = timed(torch, lambda: mgt.solve_chunked(
        hier, b, cfg, max_iters=500, chunk=5))
    del hier
    print(f"  MG solve_chunked(chunk=5) c128: {mgo.iters} cycles to "
          f"{mgo.resmag:.3e} in {t_mg:.3f} s (setup {t_setup:.3f} s); "
          f"cycle_reduction {it / mgo.iters:.1f} (JAX: 15 cycles, 80x)")
    check(mgo.converged, f"MG c128 did not reach 1e-8 ({mgo.resmag:.3e})")
    out["mg"] = {"cycles": mgo.iters, "res": mgo.resmag, "seconds": t_mg,
                 "setup_s": t_setup, "cycle_reduction": it / mgo.iters}

    # 2. even-odd MR on the same operator
    (x, it_eo, rel), sec, n = solve("eo_mr", lambda: mgt.eo_mr_solve(
        D, b, tol=1e-8, max_iters=300000, chunk=100))
    print(f"  eo_mr_solve: {it_eo} Schur iterations to {rel:.3e} in "
          f"{sec:.3f} s ({n} dense_apply launches)")
    check(rel < 1e-8, f"eo_mr_solve reached {rel:.3e}")
    out["eo_mr"] = {"iters": it_eo, "rel": rel, "seconds": sec,
                    "launches": n}
    del U, D, x

    # 3. CGNR + complex128 defect correction, indefinite Wilson m=-0.07 on
    #    beta=32 (scripts/wilson_m007.py part B), native heat-bath
    check(native.available(), "the native heat-bath did not build")
    print("  heat-bath generator: native (tpu_multigrid_torch/utils/native.py)")
    for L in (128, 256):
        theta, t_hb = timed(torch, lambda: native.heatbath_run(
            np.zeros((2, L, L)), 32.0, 100, 4302529))
        U128 = mgt.models.gauge.gauge_from_phases(theta, torch.complex128,
                                                  dev)
        D128 = mgt.models.operators.assemble("wilson", U128, -0.07)
        D64 = mgt.models.operators.assemble("wilson",
                                            U128.to(torch.complex64), -0.07)
        b = torch.zeros((2, L, L), dtype=torch.complex128, device=dev)
        b[0, 2, 2] = 5.0
        res, sec, n = solve(f"cgnr_ir L={L}", lambda: mgt.cgnr_solve_ir(
            D64, D128, b, tol=1e-8, inner_tol=1e-5, inner_max=6000,
            max_outer=8))
        phi = torch.complex(*res["phi_planes"])
        true = float(torch.linalg.vector_norm(
            b - mgt.ops.stencil.apply_D(D128, phi))
            / torch.linalg.vector_norm(b))
        print(f"  cgnr_solve_ir L={L} beta=32 m=-0.07: {res['outer']} outer "
              f"steps, {res['inner_iters']} inner iterations, rel "
              f"{res['rel']:.3e}, true c128 residual {true:.3e}, {sec:.3f} s "
              f"(heat-bath {t_hb:.2f} s; {n} dense_apply launches)")
        check(true < 1e-8 and res["rel"] < 1e-8,
              f"cgnr_solve_ir L={L}: rel {res['rel']:.3e}, true {true:.3e}")
        out[f"cgnr_ir_L{L}"] = {
            "outer": res["outer"], "inner_iters": res["inner_iters"],
            "rel": res["rel"], "true_rel": true, "seconds": sec,
            "heatbath_s": t_hb, "launches": n,
            "plaquette": float(mgt.models.gauge.plaquette(U128).real)}

    # one profiled chunk of 500 inner CGNR iterations at L=256 (complex64)
    b64 = (b / torch.linalg.vector_norm(b)).to(torch.complex64)
    Ddag = mgt.ops.stencil.adjoint_stencil(D64)
    mgt.cgnr_solve(D64, b64, tol=0.0, max_iters=20, chunk=20, Ddag=Ddag)
    with tempfile.TemporaryDirectory(dir=HERE) as tmp, \
            mgt.profiling.trace(tmp) as p:
        _, wall = timed(torch, lambda: mgt.cgnr_solve(
            D64, b64, tol=0.0, max_iters=500, chunk=500, Ddag=Ddag))
    by_name = device_time_by_name(p)
    busy = sum(by_name.values()) / 1e6 / wall
    _, wall_bare = timed(torch, lambda: mgt.cgnr_solve(
        D64, b64, tol=0.0, max_iters=500, chunk=500, Ddag=Ddag))
    print(f"  profiled CGNR chunk (500 iterations, L=256 c64): "
          f"{wall * 1e3:.1f} ms profiled, {wall_bare * 1e3:.1f} ms bare; "
          f"device busy share {busy:.3f}, idle {1 - busy:.3f}")
    for name, us in by_name.most_common(5):
        print(f"    {us / 500:7.2f} us per iteration  {name[:70]}")
    out["cgnr_profile"] = {"ms_per_iter": wall_bare * 1e3 / 500,
                           "ms_per_iter_profiled": wall * 1e3 / 500,
                           "busy_share": busy}
    del U128, D128, D64, b, b64, Ddag, phi

    # 4. FGMRES preconditioned by the flagship hierarchy (complex64)
    bf = mgt.point_source(flag_cfg, device=dev)
    (x, it, rel), sec, n = solve("fgmres", lambda: mgt.fgmres_solve(
        flag_hier, bf, flag_cfg, tol=1e-6))
    print(f"  fgmres_solve on the flagship hierarchy: {it} iterations to "
          f"{rel:.3e} in {sec:.3f} s ({n} dense_apply launches)")
    check(rel < 1e-6, f"fgmres_solve reached {rel:.3e}")
    out["fgmres"] = {"iters": it, "rel": rel, "seconds": sec, "launches": n}
    launches = dict(cs.launches)
    for k in KRYLOV_KERNELS:
        check(launches[k] > 0, f"krylov phase never launched {k}")
    return out, launches


class Stopwatch:
    """Seconds and calls of one function attribute of `owner` while the
    block runs (the card synchronized before the clock stops); the
    attribute is restored after."""

    def __init__(self, torch, owner, name):
        self.torch, self.owner, self.name = torch, owner, name
        self.seconds, self.calls = 0.0, 0

    def __enter__(self):
        self.orig = orig = getattr(self.owner, self.name)

        @functools.wraps(orig)
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = orig(*a, **k)
            if self.torch.cuda.is_initialized():
                self.torch.cuda.synchronize()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.orig)


def run_cli(torch, mgt, argv, out_dir):
    """tpu_multigrid_torch.cli.main(argv + --out-dir) in this process.
    Returns (exit code, what it printed, solve_summary.json, setup
    seconds, ResultsWriter.record seconds and calls)."""
    buf = io.StringIO()
    with Stopwatch(torch, mgt, "build_hierarchy") as setup, \
            Stopwatch(torch, mgt.utils.io.ResultsWriter, "record") as rec, \
            contextlib.redirect_stdout(buf):
        rc = mgt.cli.main(argv + ["--out-dir", str(out_dir)])
    summary = json.loads((out_dir / "solve_summary.json").read_text())
    return rc, buf.getvalue(), summary, setup.seconds, rec.seconds, rec.calls


def self_test_line(printed, bar, tag):
    """The CLI's 'self-tests: N checks, worst X' line, held to `bar`."""
    line = next(x for x in printed.splitlines() if x.startswith("self-tests:"))
    worst = float(line.split("worst ")[1].split()[0])
    check("(all pass)" in line and worst < bar, f"cli {tag}: {line}")
    return int(line.split()[1]), worst


def check_results_files(out_dir, cfg_L, nlevels, cycles, tag):
    """One line per cycle in every results file, 'it,' first; L^2 * 2
    values on each line of results_phi.txt, all finite."""
    names = (["results_phi.txt", "results_NTL_weights.txt"]
             + [f"results_res_lvl-{l}.txt" for l in range(nlevels + 1)])
    for name in names:
        n = 0
        with open(out_dir / name) as f:
            for n, line in enumerate(f, 1):
                check(line.startswith(f"{n},"), f"cli {tag}: {name} line {n}")
                check("nan" not in line and "inf" not in line,
                      f"cli {tag}: {name} line {n} not finite")
                if name == "results_phi.txt":
                    check(line.count(",") - 1 == 2 * cfg_L * cfg_L,
                          f"cli {tag}: results_phi.txt line {n} holds "
                          f"{line.count(',') - 1} values")
        check(n == cycles, f"cli {tag}: {name} has {n} lines for {cycles} "
              "cycles")


def flagship_argv(L, phase_file, dev, **over):
    """The CLI's flags for the flagship's config on the phases in
    phase_file (heat-bath format), with `over` replacing or adding flags
    (a value None drops the flag)."""
    f = {"L": L, "stencil": "wilson", "m": -0.005, "nlevels": 3,
         "num-iters": 4, "null-iters": 100, "dtype": "complex64",
         "res-threshold": 1e-6, "gauge": "file", "gauge-file": phase_file,
         "platform": str(dev)}
    f.update(over)
    argv = ["--ntl"]
    for k, v in f.items():
        argv += [] if v is None else [f"--{k}", str(v)]
    return argv


def cli_phase(torch, mgt, dev, card, flag, phases):
    """The entry points: tpu_multigrid_torch.cli.main and scan.main in
    process on the card, at the flagship's width, on the flagship's phases
    written to a heat-bath-format phase file. Runs A (stationary, the
    flagship's config: its cycle count and residual; self-tests; results
    files; near-null checkpoint), B (--gen-null 0 from that checkpoint),
    C (complex128, --solver ir to 1e-13), D (--solver fmg, fgmres with
    --roofline, cgnr, eo_mr), E (--resume, twice), F (L=32 gs_lex with
    joint-QR setup: no dense-smoother launch) and G (a two-point mass scan).
    Every output directory lives in a temporary directory, deleted after
    its checks. Returns (summary, launches over the phase)."""
    import shutil
    cs = mgt.ops.cuda_stencil
    L = phases.shape[-1]
    out = {}

    def flags(**over):
        return flagship_argv(L, phase_file, dev, **{"checkpoint": nn, **over})

    def run(tag, argv, files=False, converges=True):
        d = tmp / tag
        rc, printed, s, t_setup, t_rec, n_rec = run_cli(torch, mgt, argv, d)
        row = {"rc": rc, "cycles": s["iters"], "res": s["resmag"],
               "converged": s["converged"], "setup_s": t_setup,
               "solve_s": s["seconds"]}
        if n_rec:
            row.update(record_s=t_rec, record_calls=n_rec,
                       record_share=t_rec / s["seconds"])
        print(f"cli {tag}: exit {rc}, {s['iters']} cycles to "
              f"{s['resmag']:.3e}, setup {t_setup:.3f} s, solve "
              f"{s['seconds']:.3f} s"
              + (f" (ResultsWriter.record {t_rec:.3f} s in {n_rec} calls, "
                 f"{row['record_share']:.3f} of the solve)" if n_rec else ""))
        check(rc == (0 if converges else 1) and s["converged"] == converges,
              f"cli {tag}: exit {rc}, {s}")
        if files:
            check_results_files(d, L, 3, s["iters"], tag)
        return row, printed, d

    cs.reset_launches()
    with tempfile.TemporaryDirectory(dir=HERE) as tmpname:
        tmp = Path(tmpname)
        phase_file = tmp / f"phase_{L}.dat"
        nn = tmp / "nn.npz"
        mgt.models.gauge.write_heatbath_file(str(phase_file), phases)

        # A: the flagship through the CLI
        a, printed, d = run("A", flags(), files=True)
        a["self_tests"], a["self_test_worst"] = self_test_line(
            printed, 1e-4, "A")
        check(nn.exists(), "cli A wrote no near-null checkpoint")
        check(a["cycles"] == flag["cycles"]
              and abs(a["res"] / flag["res"] - 1) < 1e-4,
              f"cli A: {a['cycles']} cycles to {a['res']:.6e}; the flagship "
              f"phase took {flag['cycles']} to {flag['res']:.6e}")
        shutil.rmtree(d)
        out["A"] = a

        # B: the near-null vectors from A's checkpoint
        b, _, d = run("B", flags(**{"gen-null": 0}), files=True)
        check(abs(b["cycles"] - a["cycles"]) <= 1,
              f"cli B: {b['cycles']} cycles from the checkpoint, A "
              f"{a['cycles']}")
        print(f"  setup {b['setup_s']:.3f} s from the checkpoint, "
              f"{a['setup_s']:.3f} s generated (A)")
        shutil.rmtree(d)
        out["B"] = b

        # C: the reference's own bar, complex128 to 1e-13
        c, printed, d = run("C", flags(dtype="complex128", solver="ir",
                                       checkpoint=None,
                                       **{"res-threshold": 1e-13}))
        c["self_tests"], c["self_test_worst"] = self_test_line(
            printed, 1e-12, "C")
        check(c["cycles"] <= 40, f"cli C: {c['cycles']} cycles > 40")
        out["C"] = c

        # D: the other solvers. CGNR and EO-MR (no hierarchy) run in
        # complex128: in complex64 their true residual stalls near 1e-6
        for solver in ("fmg", "fgmres", "cgnr", "eo_mr"):
            extra = ["--roofline"] if solver == "fgmres" else []
            dtype = "complex128" if solver in ("cgnr", "eo_mr") else "complex64"
            row, printed, d = run(f"D_{solver}", flags(
                solver=solver, checkpoint=None, dtype=dtype)
                + ["--skip-tests"] + extra)
            if extra:
                row["roofline"] = [x.strip() for x in printed.splitlines()
                                   if x.startswith("  ")]
            out[f"D_{solver}"] = row
        check(out["D_fmg"]["cycles"] <= a["cycles"] + 1,
              f"cli D: fmg took {out['D_fmg']['cycles']} cycles, A "
              f"{a['cycles']}")

        # E: --resume, run twice: the first is cut after 5 cycles, the
        # second starts from its saved state and ends where A ended
        state = tmp / "state.npz"
        e = [run(f"E{i}", flags(checkpoint=None, resume=state,
                                **{"checkpoint-every": 5, "max-iters": mx})
                 + ["--skip-tests"], converges=mx is None)[0]
             for i, mx in ((1, 5), (2, None))]
        check(e[0]["cycles"] == 5 and e[1]["res"] <= e[0]["res"]
              and e[1]["cycles"] == 5 * math.ceil(a["cycles"] / 5),
              f"cli E: resumed run {e[1]} after {e[0]}")
        out["E"] = e

        # F: lexicographic GS (no kernel) with joint-QR setup, complex128
        n0 = dict(cs.launches)
        f, _, d = run("F", ["--L", "32", "--stencil", "wilson", "--m", "0.05",
                            "--nlevels", "2", "--ntl", "--num-iters", "4",
                            "--null-iters", "40", "--dtype", "complex128",
                            "--res-threshold", "1e-10", "--gauge", "random",
                            "--smoother", "gs_lex", "--null-joint-qr",
                            "--platform", str(dev)], files=False)
        f["launches"] = {k: v - n0[k] for k, v in cs.launches.items()
                         if v != n0[k]}
        for k in ("dense_update", "dense_update_tiled", "links_update",
                  "links_update_tiled"):
            check(cs.launches[k] == n0[k], f"cli F: gs_lex launched {k}")
        out["F"] = f

        # G: a two-point mass scan
        t0 = time.perf_counter()
        rc = mgt.scan.main(["--L", str(L), "--stencil", "laplace",
                            "--m", "0.01,0.04", "--nlevels", "3",
                            "--dtype", "complex64", "--res-threshold", "1e-6",
                            "--platform", str(dev),
                            "--out-dir", str(tmp / "G")])
        rows = [json.loads(x) for x in
                (tmp / "G" / "scan_summary.jsonl").read_text().splitlines()]
        print(f"cli G (scan): exit {rc}, "
              + "; ".join(f"m={r['m']}: {r['iters']} cycles to "
                          f"{r['resmag']:.3e}, setup {r['setup_seconds']:.3f}"
                          f" s, solve {r['solve_seconds']:.3f} s"
                          for r in rows)
              + f"; {time.perf_counter() - t0:.3f} s")
        check(rc == 0 and len(rows) == 2 and all(r["converged"] for r in rows)
              and rows[1]["iters"] <= rows[0]["iters"],
              f"cli G: scan exit {rc}, {rows}")
        out["G"] = rows
    launches = dict(cs.launches)
    print(f"  cli launches {launches}")
    for k in CLI_KERNELS:
        check(launches[k] > 0, f"cli phase never launched {k}")
    return out, launches


def rel_diff(a, b):
    """max |a - b| / max |b|."""
    return float((a - b).abs().max() / b.abs().max())


def batched_phase(torch, mgt, dev, cfg, hier, n_rhs, n_cyc, reps, single,
                  kernels, tag):
    """solve_batched: n_rhs right-hand sides (complex normal from
    default_rng(cfg.seed + n_rhs)) through n_cyc cycles of the one
    hierarchy, with the launch counters set to 0 just before it and read
    just after; each solution against its own unbatched n_cyc-cycle solve
    (rel. 1e-4); ms a batched cycle; one profiled batched cycle launches
    exactly what one unbatched cycle launched (`single`: the unbatched phase's
    summary). Returns (summary, launches)."""
    cs = mgt.ops.cuda_stencil
    rng = np.random.default_rng(cfg.seed + n_rhs)
    shape = (n_rhs, 2, cfg.L, cfg.L)
    bs = torch.from_numpy(rng.normal(size=shape)
                          + 1j * rng.normal(size=shape)).to(dev, cfg.cdtype)
    cs.reset_launches()
    (phi, res), sec = timed(torch, lambda: mgt.solve_batched(hier, bs, cfg,
                                                             n_cyc))
    launches = dict(cs.launches)
    check(tuple(phi.shape) == shape
          and bool(torch.isfinite(torch.view_as_real(phi)).all()),
          f"batched {tag}: solutions not finite of shape {shape}")
    check(bool(np.isfinite(res).all()) and float(res.max()) < 1e-3,
          f"batched {tag}: relative residuals {res}")
    for k in kernels:
        check(launches[k] > 0, f"batched {tag}: never launched {k}")
    worst = 0.0
    for i in range(n_rhs):
        phis = mgt.zero_fields(cfg, dev)
        for _ in range(n_cyc):
            phis, _ = mgt.cycle(hier, phis, bs[i], cfg)
        worst = max(worst, rel_diff(phi[i], phis[0]))
    check(worst < 1e-4, f"batched {tag}: a right-hand side differs from its "
          f"own unbatched solve by {worst:.3e}")

    def cycles():
        phis = mgt.zero_fields(cfg, dev, n_rhs)
        for _ in range(n_cyc):
            phis, _ = mgt.cycle(hier, phis, bs, cfg)

    ms = cuda_ms(torch, cycles, reps=reps) / n_cyc
    want = single["cycle"]["port_launches"]
    cyc = cycle_launches(torch, mgt, dev, cfg, hier, ms, want,
                         f"batched x{n_rhs} {tag}", b=bs)
    check(cyc["port_launches"] == want, f"batched {tag}: a cycle launched "
          f"{cyc['port_launches']}, an unbatched cycle {want}")
    out = {"L": cfg.L, "rhs": n_rhs, "cycles": n_cyc,
           "max_rel_res": float(res.max()), "solve_s": sec,
           "max_rel_diff_vs_unbatched": worst, "ms_per_cycle": ms,
           "unbatched_ms_per_cycle": single["ms_per_cycle"],
           "rhs_per_s": n_rhs * 1e3 / (ms * n_cyc), "cycle": cyc,
           "launches": launches}
    print(f"batched {tag} x{n_rhs} c64: {n_cyc} cycles, max rel residual "
          f"{out['max_rel_res']:.3e}, max rel diff vs unbatched {worst:.3e}; "
          f"{ms:.3f} ms a batched cycle vs {n_rhs} x "
          f"{single['ms_per_cycle']:.3f} = "
          f"{n_rhs * single['ms_per_cycle']:.3f} ms unbatched; "
          f"{out['rhs_per_s']:.1f} RHS/s at {n_cyc} cycles")
    return out, launches


def chebyshev_phase(torch, mgt, dev, cfg, hier, max_cycles=40, n_cyc=10,
                    reps=5):
    """eigs.chebyshev_config on the flagship hierarchy (lambda_max of
    D0^-1 D on every level by power iteration), then the Chebyshev-smoothed
    solve_chunked(chunk=1) to the flagship's threshold, with the launch
    counters set to 0 before the estimate; the plain path on the same
    hierarchy within one cycle. Returns the summary."""
    cs = mgt.ops.cuda_stencil
    b = mgt.point_source(cfg, device=dev)
    cs.reset_launches()
    cc, t_eig = timed(torch, lambda: mgt.eigs.chebyshev_config(cfg, hier))
    out, sec = timed(torch, lambda: mgt.solve_chunked(
        hier, b, cc, max_iters=max_cycles, chunk=1))
    launches = dict(cs.launches)
    plain = mgt.solve_chunked(hier, b, cc.replace(pallas="off"),
                              max_iters=max_cycles, chunk=1)

    def cycles():
        phis = mgt.zero_fields(cc, dev)
        for _ in range(n_cyc):
            phis, _ = mgt.cycle(hier, phis, b, cc)

    ms = cuda_ms(torch, cycles, reps=reps) / n_cyc
    print(f"chebyshev L={cfg.L}: lambda_max per level "
          + ", ".join(f"{x:.4f}" for x in cc.cheby_lmax)
          + f" ({t_eig:.3f} s); {out.iters} cycles to {out.resmag:.3e} in "
          f"{sec:.3f} s, {ms:.3f} ms a cycle; plain path {plain.iters} "
          f"cycles to {plain.resmag:.3e}; launches {launches}")
    check(math.isfinite(out.resmag) and out.converged,
          f"chebyshev did not reach {cfg.res_threshold} in {max_cycles} "
          f"cycles ({out.iters}, {out.resmag:.3e})")
    check(plain.converged and abs(plain.iters - out.iters) <= 1,
          f"chebyshev: kernel path {out.iters} cycles, plain {plain.iters}")
    for k in CHEBYSHEV_KERNELS:
        check(launches[k] > 0, f"chebyshev never launched {k}")
    return {"lmax": list(cc.cheby_lmax), "eig_s": t_eig,
            "cycles": out.iters, "res": out.resmag, "solve_s": sec,
            "ms_per_cycle": ms, "plain_cycles": plain.iters,
            "launches": launches}


def ensemble_phase(torch, mgt, dev, B=8, L=128, n_cyc=18):
    """bench.py's ensemble phase on the card: Wilson L=128, m=-0.005, 2
    levels, NTL, 4 sweeps, 60 near-null sweeps, complex64, B gauges of
    phases 0.2 N(0,1) from default_rng(cfg.seed) (a second ensemble for
    the warm setup), the point source, 18 cycles, through
    build_hierarchies_batched and solve_ensemble with the launch counters
    set to 0 before the setup. Max relative residual < 1e-5 (bench.py's
    bar); each configuration equal to its own unbatched solve (rel. 1e-4);
    one ensemble cycle launches what one configuration's cycle launches.
    Returns the summary."""
    cs = mgt.ops.cuda_stencil
    ens = mgt.solver.ensemble
    cfg = mgt.MGConfig(L=L, stencil="wilson", m=-0.005, nlevels=2, ntl=True,
                       num_iters=4, null_iters=60, dtype="complex64",
                       res_threshold=1e-6, smoother="rbgs")
    rng = np.random.default_rng(cfg.seed)

    def gauges():
        ph = np.stack([0.2 * rng.normal(size=(2, L, L)) for _ in range(B)])
        return mgt.models.gauge.gauge_from_phases(ph, cfg.cdtype, dev)

    Us, Us2 = gauges(), gauges()
    b = mgt.point_source(cfg, device=dev)
    bs = b.expand(B, *b.shape).contiguous()
    cs.reset_launches()
    hier_b, t_setup = timed(torch, lambda: mgt.build_hierarchies_batched(
        Us, cfg))
    _, t_setup_warm = timed(torch, lambda: mgt.build_hierarchies_batched(
        Us2, cfg))
    (phi, res), t_cold = timed(torch, lambda: mgt.solve_ensemble(
        hier_b, bs, cfg, n_cyc))
    (phi, res), t_warm = timed(torch, lambda: mgt.solve_ensemble(
        hier_b, bs, cfg, n_cyc))
    launches = dict(cs.launches)
    check(bool(np.isfinite(res).all()) and float(res.max()) < 1e-5,
          f"ensemble: relative residuals {res} after {n_cyc} cycles")
    for k in ENSEMBLE_KERNELS:
        check(launches[k] > 0, f"ensemble never launched {k}")
    worst = 0.0
    for i in range(B):
        h = ens.unstack_hierarchy(hier_b, i)
        phis = mgt.zero_fields(cfg, dev)
        for _ in range(n_cyc):
            phis, _ = mgt.cycle(h, phis, b, cfg)
        worst = max(worst, rel_diff(phi[i], phis[0]))
    check(worst < 1e-4, f"ensemble: a configuration differs from its own "
          f"solve by {worst:.3e}")
    h0 = ens.unstack_hierarchy(hier_b, 0)
    cs.reset_launches()
    mgt.cycle(h0, mgt.zero_fields(cfg, dev), b, cfg)
    want = {k: v for k, v in cs.launches.items() if v}
    ms = cuda_ms(torch, lambda: mgt.cycle(
        hier_b, mgt.zero_fields(cfg, dev, B), bs, cfg), reps=10)
    cyc = cycle_launches(torch, mgt, dev, cfg, hier_b, ms, want,
                         f"ensemble x{B}", b=bs)
    check(cyc["port_launches"] == want, f"ensemble: a cycle launched "
          f"{cyc['port_launches']}, one configuration's {want}")
    out = {"B": B, "L": L, "n_cycles": n_cyc, "max_rel_res": float(res.max()),
           "setup_s": t_setup, "setup_warm_s": t_setup_warm,
           "solve_cold_s": t_cold, "solve_warm_s": t_warm,
           "configs_per_s_warm": B / t_warm, "ms_per_cycle": ms,
           "max_rel_diff_vs_single": worst, "cycle": cyc,
           "launches": launches}
    print(f"ensemble8 L={L} x{B} c64: setup {t_setup:.3f} s cold, "
          f"{t_setup_warm:.3f} s warm; solve {n_cyc} cycles {t_cold:.3f} s "
          f"cold, {t_warm:.3f} s warm ({B / t_warm:.2f} configs/s); max rel "
          f"residual {out['max_rel_res']:.3e}; max rel diff vs one "
          f"configuration's solve {worst:.3e}; {ms:.3f} ms a cycle")
    return out


def geo_phase(torch, mgt, dev):
    """The CLI's geometric programs in process on the card: gen 1 at the
    reference's own size by --geo-ir to sum|r| < 1e-7 (bench.py's geo2048;
    at most 5 cycles: JAX's 4, the compiled C++ reference's 5), run twice
    (cold, warm), and gen 2 at L=32 with lexicographic GS, t_flag 0 and 1
    (GEO2_CYCLES each)."""
    out = {}
    with tempfile.TemporaryDirectory(dir=HERE) as tmpname:
        tmp = Path(tmpname)
        gen1 = ["--mode", "geo", "--geo-ir", "--L", "2048", "--m", "0.002",
                "--nlevels", "9", "--num-iters", "20", "--res-threshold",
                "1e-7", "--max-iters", "12", "--platform", str(dev)]
        for run in ("cold", "warm"):
            rc, _, s, *_ = run_cli(torch, mgt, gen1, tmp / f"geo_{run}")
            row = {"rc": rc, "cycles": s["iters"], "res_l1": s["res_l1"],
                   "seconds": s["seconds"],
                   "s_per_cycle": s["seconds"] / s["iters"],
                   "history": s["history"]}
            print(f"geo L=2048 --geo-ir ({run}): exit {rc}, {s['iters']} "
                  f"cycles to sum|r| {s['res_l1']:.3e} in {s['seconds']:.3f} "
                  f"s ({row['s_per_cycle']:.4f} s a cycle); history "
                  + ", ".join(f"{h:.3e}" for h in s["history"]))
            check(rc == 0 and s["converged"] and s["iters"] <= 5,
                  f"geo L=2048: exit {rc}, {s['iters']} cycles to "
                  f"{s['res_l1']:.3e}")
            out[f"geo2048_{run}"] = row
        for t_flag in (0, 1):
            argv = ["--mode", "geo2", "--L", "32", "--m", "0.5", "--nlevels",
                    "3", "--num-iters", "4", "--smoother", "gs_lex",
                    "--res-threshold", "1e-12", "--max-iters", "100",
                    "--platform", str(dev)] + (["--ntl"] if t_flag else [])
            rc, _, s, *_ = run_cli(torch, mgt, argv, tmp / f"geo2_{t_flag}")
            print(f"geo2 L=32 gs_lex t_flag {t_flag}: exit {rc}, {s['iters']}"
                  f" cycles to sum|r| {s['res_l1']:.3e} in {s['seconds']:.3f}"
                  " s")
            check(rc == 0 and s["iters"] == GEO2_CYCLES,
                  f"geo2 t_flag {t_flag}: exit {rc}, {s['iters']} cycles "
                  f"(the CPU count {GEO2_CYCLES})")
            out[f"geo2_t{t_flag}"] = {"rc": rc, "cycles": s["iters"],
                                      "res_l1": s["res_l1"],
                                      "seconds": s["seconds"]}
    return out


def mesh_phase(torch, mgt, dev, cfg, phases, cli_cycles, n_cyc=5, reps=3):
    """The distributed path (parallel/) at world size 1: a one-rank NCCL
    group on the card and scripts/torch_mesh_bench.run_mesh on the
    flagship: its setup by build_hierarchy_sharded (the flagship's starts:
    the generator seeded with cfg.seed; timed in turns with the
    single-device build_hierarchy) and its solve by make_sharded_solver to
    1e-6, with the launch counters set to 0 just before the solve and read
    just after (the tile levels run plain torch; the replicated coarsest
    level and its NTL copies run dense_update, and no links kernel runs).
    Held to the single-device solve on the same hierarchy with links off
    (dense level 0): the same cycle count, phi within 1e-4. Then ms a
    cycle of each, CUDA events, and the CLI with --mesh 1,1 on the
    flagship's phases: the cycle count of CLI run A. Returns the phase's
    summary."""
    import torch.distributed as dist
    from tpu_multigrid_torch.parallel import multihost
    sys.path.insert(0, str(HERE / "scripts"))
    from torch_mesh_bench import run_mesh
    cs = mgt.ops.cuda_stencil
    U = mgt.models.gauge.gauge_from_phases(phases, cfg.cdtype, dev)
    D = mgt.models.operators.assemble(cfg.stencil, U, cfg.m)
    b = mgt.point_source(cfg, device=dev)
    check(multihost.initialize(world_size=1, backend="nccl"),
          "mesh: no process group")
    try:
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              f"mesh: {dist.get_backend()} group of "
              f"{dist.get_world_size()}")
        out = run_mesh((1, 1), cfg, dev, D, b, n_cyc, reps)
    finally:
        dist.destroy_process_group()
    launches = out["launches_solve"]
    print(f"mesh (1, 1) over nccl on {dev}: sharded levels "
          f"{out['sharded_levels']}; setup {out['setup_s']:.3f} s (first "
          f"{out['setup_first_s']:.3f} s; single-device build_hierarchy, "
          f"check=False, in turns: {out['setup_single_s']:.3f} s; peak "
          f"{out['setup_peak_gib']:.3f} against "
          f"{out['setup_single_peak_gib']:.3f} GiB); "
          f"{out['cycles']} cycles to {out['res']:.3e} in "
          f"{out['solve_s']:.3f} s; single-device (links off) "
          f"{out['single_cycles']} cycles to {out['single_res']:.3e}; phi "
          f"rel diff {out['phi_rel_diff']:.2e}; launches in the solve "
          f"{launches}")
    print(f"  per cycle {out['ms_per_cycle_overlap']:.3f} ms sharded "
          f"(plain torch on the tiles; concat baseline "
          f"{out['ms_per_cycle_concat']:.3f}), "
          f"{out['ms_per_cycle_single']:.3f} ms single-device on the "
          f"kernels, links off (CUDA events, median of {reps} x {n_cyc} "
          "cycles)")
    check(out["res"] < cfg.res_threshold
          and out["cycles"] == out["single_cycles"],
          f"mesh: {out['cycles']} cycles to {out['res']:.3e}, "
          f"single-device {out['single_cycles']}")
    check(out["phi_rel_diff"] < 1e-4,
          f"mesh: phi rel diff {out['phi_rel_diff']:.2e}")
    check(launches.get("dense_update", 0) > 0,
          "mesh: the solve never launched dense_update")
    check(not any(k.startswith("links") for k in launches),
          f"mesh: the solve launched a links kernel: {launches}")

    with tempfile.TemporaryDirectory(dir=HERE) as tmpname:
        tmp = Path(tmpname)
        phase_file = tmp / "phase.dat"
        mgt.models.gauge.write_heatbath_file(str(phase_file), phases)
        cs.reset_launches()
        rc, _, s, t_cli_setup, _, _ = run_cli(torch, mgt, flagship_argv(
            cfg.L, phase_file, dev) + ["--mesh", "1,1", "--skip-tests"],
            tmp / "out")
    print(f"cli --mesh 1,1: exit {rc}, {s['iters']} cycles to "
          f"{s['resmag']:.3e}, setup {t_cli_setup:.3f} s, solve "
          f"{s['seconds']:.3f} s (run A: {cli_cycles} cycles)")
    check(rc == 0 and s["converged"] and s["iters"] == cli_cycles,
          f"cli --mesh 1,1: exit {rc}, {s}; run A took {cli_cycles}")
    check(not dist.is_initialized(), "cli --mesh 1,1 left its group")
    check(cs.launches["dense_update"] > 0,
          "cli --mesh 1,1 never launched dense_update")
    out["cli"] = {"rc": rc, "cycles": s["iters"], "res": s["resmag"],
                  "setup_s": t_cli_setup, "solve_s": s["seconds"]}
    return out


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; nothing measured")
    sys.path.insert(0, str(HERE))
    import tpu_multigrid_torch as mgt
    check(Path(mgt.__file__).resolve().parent.parent == HERE,
          f"tpu_multigrid_torch imported from {mgt.__file__}, not this checkout")
    cs = mgt.ops.cuda_stencil
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; {name}")
    t_start = time.perf_counter()

    built, t_build = timed(torch, lambda: (cs.build(), cs._library())[0])
    print(f"kernel build + load: {t_build:.2f} s ({built.name})")

    per_kernel, vs_global, kernel_rows = run_kernel_cases(torch, mgt, dev)
    print(f"kernel cases done at {time.perf_counter() - t_start:.1f} s")

    # ---- the flagship (L=256) on the global kernels ----
    cfg, gauges = flagship(torch, mgt, dev)
    hier, flag, flag_launches = solve_phase(
        torch, mgt, dev, cfg, gauges, FLAGSHIP_KERNELS, max_cycles=30,
        n_cyc=10, reps=5, warm_check=True)
    solve_l = flag["launches_solve"]
    check(solve_l["links_residual_norm"] == flag["cycles"]
          and solve_l["links_residual"] == 0,
          f"the flagship's {flag['cycles']} checks launched "
          f"{solve_l['links_residual_norm']} links_residual_norm and "
          f"{solve_l['links_residual']} links_residual")
    flag["cycle"] = cycle_launches(
        torch, mgt, dev, cfg, hier, flag["ms_per_cycle"], FLAGSHIP_CYCLE,
        "flagship", FIRST_DESIGN_CYCLE_OPS)
    flag["check"] = check_phase(torch, mgt, dev, cfg, hier)
    flag["solve_ir"] = ir_phase(torch, mgt, dev, cfg, gauges[0][0], hier)
    batched, batched_launches = batched_phase(
        torch, mgt, dev, cfg, hier, 8, 10, 5, flag, FLAGSHIP_KERNELS,
        "L=256")
    cheb = chebyshev_phase(torch, mgt, dev, cfg, hier)
    flag_cfg, flag_hier, flag_phases = cfg, hier, gauges[0][0]
    del gauges, hier
    print(f"flagship done at {time.perf_counter() - t_start:.1f} s")

    # ---- the large flagship (L=2048) on the x-tiled kernels ----
    cfg, gauges = flagship(torch, mgt, dev, L=2048, nlevels=6)
    hier, large, large_launches = solve_phase(
        torch, mgt, dev, cfg, gauges, LARGE_KERNELS, max_cycles=100,
        n_cyc=4, reps=3, warm_check=False)
    phases0 = gauges[0][0]
    del gauges
    solve_l = large["launches_solve"]
    check(solve_l["links_residual_norm"] == large["cycles"]
          and solve_l["links_residual_tiled"] == large["cycles"],
          f"the large flagship's checks launched {solve_l}: want B5b once a "
          "cycle and links_residual_norm once a check")
    large["cycle"] = cycle_launches(
        torch, mgt, dev, cfg, hier, large["ms_per_cycle"], LARGE_CYCLE,
        "large flagship")
    large["check"] = check_phase(torch, mgt, dev, cfg, hier, reps=10)
    large["solve_ir"] = ir_phase(torch, mgt, dev, cfg, phases0, hier)
    large_b, large_b_launches = batched_phase(
        torch, mgt, dev, cfg, hier, 2, 8, 3, large, LARGE_KERNELS, "L=2048")
    del hier
    torch.cuda.synchronize()
    large["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"large flagship done at {time.perf_counter() - t_start:.1f} s; "
          f"peak device memory {large['peak_mem_gb']:.2f} GiB")

    small_check(torch, mgt, dev)
    block8, block8_launches = block8_phase(torch, mgt, dev)

    # ---- the SpMV path: the stencil stream, then the Krylov solvers ----
    spmv, spmv_launches = spmv_phase(torch, mgt, dev, card)
    print(f"spmv done at {time.perf_counter() - t_start:.1f} s")
    krylov, _ = krylov_phase(torch, mgt, dev, flag_cfg,
                                           flag_hier)
    del flag_hier
    print(f"krylov done at {time.perf_counter() - t_start:.1f} s")

    # ---- the entry points: the CLI and the scan ----
    t_cli = time.perf_counter()
    cli, cli_launches = cli_phase(torch, mgt, dev, card, flag, flag_phases)
    cli["seconds"] = time.perf_counter() - t_cli
    print(f"cli done at {time.perf_counter() - t_start:.1f} s "
          f"({cli['seconds']:.1f} s)")

    # ---- the distributed path at world size 1 ----
    mesh = mesh_phase(torch, mgt, dev, flag_cfg, flag_phases,
                      cli["A"]["cycles"])
    print(f"mesh done at {time.perf_counter() - t_start:.1f} s")

    # ---- the ensemble, and the CLI's geometric programs ----
    ensemble = ensemble_phase(torch, mgt, dev)
    print(f"ensemble done at {time.perf_counter() - t_start:.1f} s")
    geo = geo_phase(torch, mgt, dev)
    print(f"geo done at {time.perf_counter() - t_start:.1f} s")
    # each kernel's launches on the main path that runs it: the flagship's
    # solve, else the large flagship's, else the SpMV phase
    phase_launches = {k: spmv_launches for k in SPMV_KERNELS}
    phase_launches.update({k: large_launches for k in LARGE_KERNELS
                           if k.endswith("_tiled")})
    phase_launches.update({k: flag_launches for k in FLAGSHIP_KERNELS})
    phase_launches.update({k: block8_launches for k in BLOCK8_KERNELS})

    batched_cycle = dict(batched["cycle"]["port_launches"],
                         **large_b["cycle"]["port_launches"])
    kernels = [{"name": k, "route": "cuda", "source": SOURCES[k],
                "replaces": REPLACES[k],
                "launches": phase_launches[k][k],
                "cli_launches": cli_launches[k],
                **{f: per_kernel[k][f] for f in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms", "library", "case", "device_us",
                    "device_us_cold", "device_us_cold_clean",
                    "bound_share_cold", "copy_us_cold", "cold_over_copy",
                    "unfused_ms", "unfused_device_us",
                    "unfused_device_us_cold")
                   if f in per_kernel[k]},
                **({"batched": dict(per_kernel[k]["batched"],
                                    cycle_launches=batched_cycle.get(k, 0))}
                   if "batched" in per_kernel[k] else {})}
               for k in REPLACES]
    for k in BATCHED_KERNELS:
        check((batched_launches if k in FLAGSHIP_KERNELS
               else large_b_launches)[k] > 0, f"batched never launched {k}")
    print(json.dumps({"flagship": flag, "card": card}))
    print(json.dumps({"large_flagship": large, "card": card}))
    print(json.dumps({"tiled_vs_global": vs_global, "card": card}))
    print(json.dumps({"kernel_rows": kernel_rows, "card": card}))
    print(json.dumps({"krylov": krylov, "card": card}))
    print(json.dumps({"cli": cli, "card": card}))
    print(json.dumps({"batched": {"L256": batched, "L2048": large_b},
                      "card": card}))
    print(json.dumps({"chebyshev": cheb, "card": card}))
    print(json.dumps({"ensemble8": ensemble, "card": card}))
    print(json.dumps({"geo": geo, "card": card}))
    print(json.dumps({"block8": block8, "card": card}))
    print(json.dumps({"mesh": mesh, "card": card}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
