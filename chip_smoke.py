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
  complex64, to 1e-6, on the global kernels, then by solve_ir to 1e-8 and
  1e-13;
- the large flagship: the same at L=2048 with 6 levels (coarsest 32), on
  the x-tiled kernels at levels 0-3, to 1e-6, then by solve_ir (complex64
  cycles, exact complex128 defect) to 1e-8 and 1e-13.

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

It checks convergence, that each solve went through every kernel of its
path (launch counters, set to 0 before the path and read after it), that
the plain path on the same hierarchy takes the same number of cycles
(within one), and that the kernel path agrees with the plain path on a
small complex128 problem.

Any failed check raises, and the exit code is then non-zero. The last
line of standard output is one JSON object, {"ok": true, "device": ...};
the line before it is a JSON object with one entry per kernel. Without a
CUDA device, or outside the repository, it fails and prints no result.
"""
import collections
import contextlib
import functools
import io
import json
import math
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPLACES = {
    "links_update": "tpu_multigrid/ops/pallas_stencil.py:669",
    "links_residual": "tpu_multigrid/ops/pallas_stencil.py:662",
    "dense_update": "tpu_multigrid/ops/pallas_stencil.py:125",
    "links_update_tiled": "tpu_multigrid/ops/pallas_stencil.py:711",
    "links_residual_tiled": "tpu_multigrid/ops/pallas_stencil.py:703",
    "dense_update_tiled": "tpu_multigrid/ops/pallas_stencil.py:358",
    "links_apply": "tpu_multigrid/ops/pallas_stencil.py:656",
    "dense_apply": "tpu_multigrid/ops/pallas_stencil.py:64",
    "links_apply_tiled": "tpu_multigrid/ops/pallas_stencil.py:695",
    "dense_apply_tiled": "tpu_multigrid/ops/pallas_stencil.py:236",
}
SOURCES = {k: "tpu_multigrid_torch/csrc/" + ("stencil_tiled.cu" if
                                             k.endswith("_tiled") else
                                             "stencil.cu")
           for k in REPLACES}
FLAGSHIP_KERNELS = ("links_update", "links_residual", "dense_update")
LARGE_KERNELS = ("links_update_tiled", "links_residual_tiled",
                 "dense_update_tiled", "dense_update")
SPMV_KERNELS = ("dense_apply_tiled", "links_apply", "links_apply_tiled")
KRYLOV_KERNELS = ("dense_apply",)
CLI_KERNELS = ("links_update", "links_residual", "dense_update",
               "dense_apply")
L2_BYTES = 50 * 2**20
BARS = {"complex64": 2e-5, "complex128": 1e-12}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


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
    """(kernel, label, dtype, kernel_fn, plain_fn, global_fn or None) at the
    paths' shapes; global_fn runs the global kernel at a tiled case's
    shape. The first complex64 case of each kernel is its main shape."""
    cs = mgt.ops.cuda_stencil
    gs = mgt.ops.gauge_stencil
    sm = mgt.ops.smoothers
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

    def links_cases(L, tag, dtype, tiled, tile=None):
        U, phi, r = links(L, dtype), c((2, L, L), dtype), c((2, L, L), dtype)
        if tiled:
            res = functools.partial(cs.wilson_u_residual_tiled, tile=tile)
            upd = functools.partial(cs.wilson_u_smooth_tiled, tile=tile)
            kr, ku = "links_residual_tiled", "links_update_tiled"
            gres, gupd = cs.wilson_u_residual, cs.wilson_u_smooth
        else:
            res, upd, gres, gupd = (cs.wilson_u_residual, cs.wilson_u_smooth,
                                    None, None)
            kr, ku = "links_residual", "links_update"
        out = [(kr, f"{'B5b' if tiled else 'B2'} residual {tag}", dtype,
                lambda: res(U, m, phi, r),
                lambda: gs.residual_u("wilson", U, m, phi, r),
                gres and (lambda: gres(U, m, phi, r)))]
        for kind in ("rbgs", "jacobi"):
            name = ("B5a" if tiled else "B1") + f" {kind} x4 {tag}"
            out.append((ku, name, dtype,
                        lambda k=kind: upd(U, m, phi, r, 4, k),
                        lambda k=kind: gs.smooth_u("wilson", U, m, phi, r, 4,
                                                   k),
                        gupd and (lambda k=kind: gupd(U, m, phi, r, 4, k))))
        return out

    def apply_cases(B, n, L, tag, dtype, tiled, tile=None):
        """The dense SpMV: B7a (global) or B7b (x-tiled), D and v batched
        by B when B is given."""
        D, v = stencil(B, n, L, dtype), c(((B,) if B else ()) + (n, L, L),
                                          dtype)
        fn = (functools.partial(cs.dense_apply_tiled, tile=tile) if tiled
              else cs.dense_apply)
        return [("dense_apply_tiled" if tiled else "dense_apply",
                 f"{'B7b' if tiled else 'B7a'} apply {tag}", dtype,
                 lambda: fn(D, v), lambda: mgt.ops.stencil.apply_D(D, v),
                 (lambda: cs.dense_apply(D, v)) if tiled and tile is None
                 else None)]

    def links_apply_cases(L, tag, dtype, tiled, tile=None):
        """The links SpMV D_U v: B8 (global) or B5c (x-tiled)."""
        U, v = links(L, dtype), c((2, L, L), dtype)
        fn = (functools.partial(cs.wilson_u_apply_tiled, tile=tile) if tiled
              else cs.wilson_u_apply)
        return [("links_apply_tiled" if tiled else "links_apply",
                 f"{'B5c' if tiled else 'B8'} apply {tag}", dtype,
                 lambda: fn(U, m, v), lambda: gs.apply_wilson_u(U, m, v),
                 (lambda: cs.wilson_u_apply(U, m, v)) if tiled and tile is None
                 else None)]

    def dense_cases(B, n, L, shared, tag, kinds, dtype, tiled, tile=None):
        D, Dinv = dense(None if shared else B, n, L, dtype)
        lead = (B,) if B else ()
        phi = c(lead + (n, L, L), dtype)
        r = c((n, L, L) if shared else lead + (n, L, L), dtype)
        fn = (functools.partial(cs.dense_smooth_tiled, tile=tile) if tiled
              else cs.dense_smooth)
        out = []
        for kind in kinds:
            name = ("B6 " if tiled else ("B3 " if kind == "rbgs" else "B4 ")
                    ) + f"{kind} x4 {tag}"
            out.append(("dense_update_tiled" if tiled else "dense_update",
                        name, dtype,
                        lambda k=kind: fn(D, Dinv, phi, r, 4, k),
                        lambda k=kind: sm.smooth_plain(D, Dinv, phi, r, 4, k),
                        (lambda k=kind: cs.dense_smooth(D, Dinv, phi, r, 4, k))
                        if tiled and tile is None else None))
        return out

    cases = []
    for dtype in (torch.complex64, torch.complex128):
        # the flagship (L=256) on the global kernels
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
        # the SpMV path: the first case of each kernel is its main shape
        cases += apply_cases(None, 2, 256, "n=2 L=256 (MR, CGNR)", dtype,
                             tiled=False)
        cases += apply_cases(4, 4, 32, "n=4 L=32 batch 4", dtype,
                             tiled=False)
        cases += links_apply_cases(256, "L=256", dtype, tiled=False)
        cases += apply_cases(None, 2, 2048, "n=2 L=2048 (stencil stream)",
                             dtype, tiled=True)
        cases += apply_cases(None, 4, 1024, "n=4 L=1024", dtype, tiled=True)
        cases += links_apply_cases(2048, "L=2048", dtype, tiled=True)
        if dtype == torch.complex64:
            cases += apply_cases(None, 2, 4096, "n=2 L=4096", dtype,
                                 tiled=True)
            cases += links_apply_cases(4096, "L=4096", dtype, tiled=True)
        for tile in ((8, 8), (6, 12)):
            tag = f"L=32 tile {tile[0]}x{tile[1]}"
            cases += apply_cases(4, 4, 32, "n=4 batch 4 " + tag, dtype,
                                 tiled=True, tile=tile)
            cases += apply_cases(None, 2, 32, "n=2 " + tag, dtype,
                                 tiled=True, tile=tile)
            cases += links_apply_cases(32, tag, dtype, tiled=True, tile=tile)
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


def run_kernel_cases(torch, mgt, dev):
    """Each kernel against its plain version (and a tiled kernel beside the
    global one) at the paths' shapes. Returns the per-kernel entries of the
    kernels line (complex64) and the tiled-vs-global times."""
    per_kernel = {k: {"max_abs_err": 0.0, "ms": None, "plain_ms": None}
                  for k in REPLACES}
    vs_global = []
    for kern, label, dtype, fk, fp, fg in kernel_cases(torch, mgt, dev):
        got, want = fk(), fp()
        torch.cuda.synchronize()
        abs_err = float((got - want).abs().max())
        rel = abs_err / float(want.abs().max())
        ms, plain_ms = cuda_ms(torch, fk), cuda_ms(torch, fp)
        dt = str(dtype).replace("torch.", "")
        line = (f"  {kern:20s} {label:42s} {dt:10s} rel_err {rel:.3e} "
                f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
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
        print(line)
        if dt == "complex64":
            e = per_kernel[kern]
            e["max_abs_err"] = max(e["max_abs_err"], abs_err)
            if e["ms"] is None:          # the first case is the path's main shape
                e["ms"], e["plain_ms"] = ms, plain_ms
    return per_kernel, vs_global


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


def ir_phase(torch, mgt, dev, cfg, phases, hier):
    """solve_ir on the complex64 hierarchy with the exact complex128
    level-0 operator (assembled from the same phases) to 1e-8 and 1e-13,
    two inner cycles per outer step."""
    cfg128 = cfg.replace(dtype="complex128")
    U128 = mgt.models.gauge.gauge_from_phases(phases, cfg128.cdtype, dev)
    D_outer = mgt.models.operators.assemble(cfg.stencil, U128, cfg.m)
    del U128
    b = mgt.point_source(cfg128, device=dev)
    summary = {}
    for thr in (1e-8, 1e-13):
        out, sec = timed(torch, lambda: mgt.solve_ir(
            hier, b, cfg128.replace(res_threshold=thr), inner_cycles=2,
            max_iters=200, D_outer=D_outer))
        print(f"  solve_ir to {thr:g}: {len(out.history)} outer steps, "
              f"{out.iters} cycles, res {out.resmag:.3e}, {sec:.3f} s")
        check(out.converged, f"solve_ir did not reach {thr:g} "
              f"({out.iters} cycles, {out.resmag:.3e})")
        check(out.phi.dtype == torch.complex128
              and bool(torch.isfinite(torch.view_as_real(out.phi)).all()),
              "solve_ir solution not finite complex128")
        summary[f"{thr:g}"] = {"outer_steps": len(out.history),
                               "cycles": out.iters, "res": out.resmag,
                               "seconds": sec}
    return summary


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


def device_time_by_name(prof_obj):
    """Microseconds of device time (kernels, copies) by event name in a
    torch.profiler run; one stream, so the events do not overlap."""
    from torch.autograd import DeviceType
    us = collections.Counter()
    for e in prof_obj.events():
        if e.device_type == DeviceType.CUDA:
            us[e.name] += (getattr(e, "device_time_total", None)
                           or getattr(e, "cuda_time_total", 0.0))
    return us


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
        f = {"L": L, "stencil": "wilson", "m": -0.005, "nlevels": 3,
             "num-iters": 4, "null-iters": 100, "dtype": "complex64",
             "res-threshold": 1e-6, "gauge": "file", "gauge-file": phase_file,
             "checkpoint": nn, "platform": str(dev)}
        f.update(over)
        argv = ["--ntl"]
        for k, v in f.items():
            argv += [] if v is None else [f"--{k}", str(v)]
        return argv

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

    per_kernel, vs_global = run_kernel_cases(torch, mgt, dev)
    print(f"kernel cases done at {time.perf_counter() - t_start:.1f} s")

    # ---- the flagship (L=256) on the global kernels ----
    cfg, gauges = flagship(torch, mgt, dev)
    hier, flag, flag_launches = solve_phase(
        torch, mgt, dev, cfg, gauges, FLAGSHIP_KERNELS, max_cycles=30,
        n_cyc=10, reps=5, warm_check=True)
    flag["solve_ir"] = ir_phase(torch, mgt, dev, cfg, gauges[0][0], hier)
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
    large["solve_ir"] = ir_phase(torch, mgt, dev, cfg, phases0, hier)
    del hier
    torch.cuda.synchronize()
    large["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"large flagship done at {time.perf_counter() - t_start:.1f} s; "
          f"peak device memory {large['peak_mem_gb']:.2f} GiB")

    small_check(torch, mgt, dev)

    # ---- the SpMV path: the stencil stream, then the Krylov solvers ----
    spmv, spmv_launches = spmv_phase(torch, mgt, dev, card)
    print(f"spmv done at {time.perf_counter() - t_start:.1f} s")
    krylov, krylov_launches = krylov_phase(torch, mgt, dev, flag_cfg,
                                           flag_hier)
    del flag_hier
    print(f"krylov done at {time.perf_counter() - t_start:.1f} s")

    # ---- the entry points: the CLI and the scan ----
    t_cli = time.perf_counter()
    cli, cli_launches = cli_phase(torch, mgt, dev, card, flag, flag_phases)
    cli["seconds"] = time.perf_counter() - t_cli
    print(f"cli done at {time.perf_counter() - t_start:.1f} s "
          f"({cli['seconds']:.1f} s)")
    phase_launches = {k: spmv_launches for k in SPMV_KERNELS}
    phase_launches.update({k: krylov_launches for k in KRYLOV_KERNELS})
    phase_launches.update({k: large_launches for k in LARGE_KERNELS
                           if k.endswith("_tiled")})
    phase_launches.update({k: flag_launches for k in FLAGSHIP_KERNELS})

    kernels = [{"name": k, "route": "cuda", "source": SOURCES[k],
                "replaces": REPLACES[k],
                "launches": phase_launches[k][k],
                "cli_launches": cli_launches[k],
                "max_abs_err": per_kernel[k]["max_abs_err"],
                "ms": per_kernel[k]["ms"], "plain_ms": per_kernel[k]["plain_ms"]}
               for k in REPLACES]
    print(json.dumps({"flagship": flag, "card": card}))
    print(json.dumps({"large_flagship": large, "card": card}))
    print(json.dumps({"tiled_vs_global": vs_global, "card": card}))
    print(json.dumps({"krylov": krylov, "card": card}))
    print(json.dumps({"cli": cli, "card": card}))
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
