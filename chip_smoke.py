#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (tpu_multigrid_torch) on one GPU.

    python3 chip_smoke.py

From the root of a checkout, with one CUDA card. It builds the port's
hand-written kernels from csrc/, holds each kernel against its plain torch
version on the card at the flagship's shapes (timing both with CUDA
events), then drives the flagship solve through the package's entry points
(MGConfig, assemble, build_hierarchy(..., U=U), solve_chunked): Wilson,
L=256, m=-0.005, 3 levels, NTL with 4 quadrant copies and min-res
weights, red-black GS x4, 100 near-null sweeps, complex64, to 1e-6. It
checks convergence, that the solve went through every kernel of the path
(launch counters), and that the kernel path agrees with the plain path on
a small complex128 problem.

Any failed check raises, and the exit code is then non-zero. The last
line of standard output is one JSON object, {"ok": true, "device": ...};
the line before it is a JSON object with one entry per kernel. Without a
CUDA device, or outside the repository, it fails and prints no result.
"""
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
REPLACES = {
    "links_update": "tpu_multigrid/ops/pallas_stencil.py:669",
    "links_residual": "tpu_multigrid/ops/pallas_stencil.py:662",
    "dense_update": "tpu_multigrid/ops/pallas_stencil.py:125",
}
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
    """(kernel, label, dtype, kernel_fn, plain_fn) at the path's shapes."""
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

    def dense(B, n, L, dtype):
        D = 0.25 * c(((B,) if B else ()) + (5, n, n, L, L), dtype)
        D[..., 0, :, :, :, :] += 4.0 * torch.eye(
            n, dtype=dtype, device=dev)[:, :, None, None]
        return D, mgt.ops.stencil.site_inverse(D[..., 0, :, :, :, :])

    cases = []
    for dtype in (torch.complex64, torch.complex128):
        L = 256
        U, phi, r = links(L, dtype), c((2, L, L), dtype), c((2, L, L), dtype)
        cases.append(("links_residual", "B2 residual L=256", dtype,
                      lambda U=U, phi=phi, r=r: cs.wilson_u_residual(U, m, phi, r),
                      lambda U=U, phi=phi, r=r: gs.residual_u("wilson", U, m, phi, r)))
        for kind, tag in (("rbgs", "B1 rbgs x4 L=256"),
                          ("jacobi", "B1/B4 jacobi x4 L=256")):
            cases.append(("links_update", tag, dtype,
                          lambda U=U, phi=phi, r=r, k=kind:
                          cs.wilson_u_smooth(U, m, phi, r, 4, k),
                          lambda U=U, phi=phi, r=r, k=kind:
                          gs.smooth_u("wilson", U, m, phi, r, 4, k)))
        # (batch, n, L, D shared by the batch?, label)
        shapes = [(None, 4, 128, False, "B3 rbgs x4 n=4 L=128 (level 1)"),
                  (None, 4, 64, False, "B3 rbgs x4 n=4 L=64 (level 2)"),
                  (4, 4, 32, False, "B3 rbgs x4 n=4 L=32 batch 4 (NTL copies)"),
                  (2, 2, 256, True, "B3 rbgs x4 n=2 L=256 k=2 shared D (setup)"),
                  (2, 4, 128, True, "B3 rbgs x4 n=4 L=128 k=2 shared D (setup)")]
        for B, n, L, shared, tag in shapes:
            D, Dinv = dense(None if shared else B, n, L, dtype)
            lead = (B,) if B else ()
            phi = c(lead + (n, L, L), dtype)
            r = c((n, L, L) if shared else lead + (n, L, L), dtype)
            kinds = ("rbgs", "jacobi") if (B is None and L == 128) else ("rbgs",)
            for kind in kinds:
                label = tag if kind == "rbgs" else "B4 jacobi x4 n=4 L=128"
                cases.append(("dense_update", label, dtype,
                              lambda D=D, Dinv=Dinv, phi=phi, r=r, k=kind:
                              sm.smooth(D, Dinv, phi, r, 4, k),
                              lambda D=D, Dinv=Dinv, phi=phi, r=r, k=kind:
                              sm.smooth(D, Dinv, phi, r, 4, k, pallas="off")))
    return cases


def flagship(torch, mgt, dev, dtype="complex64", L=256, nlevels=3,
             null_iters=100, res_threshold=1e-6):
    """The config of bench.py's solve256 phase, and its two gauges."""
    cfg = mgt.MGConfig(L=L, stencil="wilson", m=-0.005, nlevels=nlevels,
                       ntl=True, num_iters=4, null_iters=null_iters,
                       dtype=dtype, res_threshold=res_threshold,
                       smoother="rbgs")
    rng = np.random.default_rng(cfg.seed)
    gauges = []
    for _ in range(2):
        U = mgt.models.gauge.gauge_from_phases(
            0.2 * rng.normal(size=(2, L, L)), cfg.cdtype, dev)
        gauges.append((U, mgt.models.operators.assemble(cfg.stencil, U, cfg.m)))
    return cfg, gauges


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

    t0 = time.perf_counter()
    built = cs.build()
    cs._library()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s ({built.name})")

    # ---- each kernel against its plain version at the path's shapes ----
    per_kernel = {k: {"max_abs_err": 0.0, "ms": None, "plain_ms": None}
                  for k in REPLACES}
    for kern, label, dtype, fk, fp in kernel_cases(torch, mgt, dev):
        got, want = fk(), fp()
        torch.cuda.synchronize()
        abs_err = float((got - want).abs().max())
        rel = abs_err / float(want.abs().max())
        ms, plain_ms = cuda_ms(torch, fk), cuda_ms(torch, fp)
        torch.cuda.synchronize()
        dt = str(dtype).replace("torch.", "")
        print(f"  {kern:15s} {label:44s} {dt:10s} rel_err {rel:.3e} "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms")
        check(rel < BARS[dt], f"{kern} {label} {dt}: rel err {rel:.3e} "
              f">= {BARS[dt]}")
        if dt == "complex64":
            e = per_kernel[kern]
            e["max_abs_err"] = max(e["max_abs_err"], abs_err)
            if e["ms"] is None:          # the first case is the path's main shape
                e["ms"], e["plain_ms"] = ms, plain_ms

    # ---- the flagship solve through the entry points ----
    cfg, gauges = flagship(torch, mgt, dev)
    (U, D), (Ub, Db) = gauges
    b = mgt.point_source(cfg, device=dev)
    cs.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hier = mgt.build_hierarchy(D, cfg, U=U)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    setup_launches = dict(cs.launches)
    t0 = time.perf_counter()
    out = mgt.solve_chunked(hier, b, cfg, max_iters=30, chunk=1)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = dict(cs.launches)
    solve_launches = {k: launches[k] - setup_launches[k] for k in launches}

    print(f"flagship L={cfg.L} nlevels={cfg.nlevels} NTL x{cfg.n_copies} "
          f"{cfg.dtype}: setup {t_setup:.3f} s (first, incl. checks); "
          f"{out.iters} cycles to {out.resmag:.3e} in {t_solve:.3f} s")
    print(f"  launches in setup {setup_launches}; in solve {solve_launches}")
    check(out.converged and out.iters <= 30,
          f"flagship did not reach {cfg.res_threshold} in 30 cycles "
          f"({out.iters}, {out.resmag:.3e})")
    check(tuple(out.phi.shape) == (2, cfg.L, cfg.L)
          and out.phi.dtype == torch.complex64, "solution shape / dtype")
    check(bool(torch.isfinite(torch.view_as_real(out.phi)).all()),
          "solution not finite")
    for k in REPLACES:
        check(solve_launches[k] > 0, f"solve never launched {k}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mgt.build_hierarchy(Db, cfg, U=Ub)
    torch.cuda.synchronize()
    t_setup_warm = time.perf_counter() - t0

    def cycles(hier, cfg, n):
        phis = mgt.zero_fields(cfg, dev)
        for _ in range(n):
            phis, _ = mgt.cycle(hier, phis, b, cfg)

    n_cyc = 10
    ms_cycle = cuda_ms(torch, lambda: cycles(hier, cfg, n_cyc), reps=5) / n_cyc
    plain_cfg = cfg.replace(pallas="off")
    ms_cycle_plain = cuda_ms(torch, lambda: cycles(hier, plain_cfg, n_cyc),
                             reps=5) / n_cyc
    plain = mgt.solve_chunked(hier, b, plain_cfg, max_iters=30, chunk=1)
    print(f"  setup warm (second gauge) {t_setup_warm:.3f} s; per cycle "
          f"{ms_cycle:.3f} ms on the kernels, {ms_cycle_plain:.3f} ms on the "
          f"plain versions (CUDA events, median of 5 x {n_cyc} cycles)")
    print(f"  plain path on the same hierarchy: {plain.iters} cycles to "
          f"{plain.resmag:.3e}")
    check(plain.converged and abs(plain.iters - out.iters) <= 1,
          f"kernel path {out.iters} cycles vs plain path {plain.iters}")

    # ---- kernel path == plain path on a small complex128 problem ----
    small, ((Us, Ds), _) = flagship(torch, mgt, dev, dtype="complex128", L=32,
                                    nlevels=2, null_iters=16,
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

    kernels = [{"name": k, "route": "cuda",
                "source": "tpu_multigrid_torch/csrc/stencil.cu",
                "replaces": REPLACES[k], "launches": launches[k],
                "max_abs_err": per_kernel[k]["max_abs_err"],
                "ms": per_kernel[k]["ms"], "plain_ms": per_kernel[k]["plain_ms"]}
               for k in REPLACES]
    summary = {"cycles": out.iters, "res": out.resmag, "setup_s": t_setup,
               "setup_warm_s": t_setup_warm, "ms_per_cycle": ms_cycle,
               "ms_per_cycle_plain": ms_cycle_plain, "card": card}
    print(json.dumps({"flagship": summary}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
