#!/usr/bin/env python3
"""Same-card comparison of two designs of the port's smoother kernels
(links_update, dense_update and the x-tiled links_update_tiled,
dense_update_tiled) on one CUDA card.

    python3 scripts/torch_smoother_ab.py OTHER_DIR [--out FILE]

OTHER_DIR holds another version of the `tpu_multigrid_torch` package
(for example the first design's, unpacked with
`git archive <commit> tpu_multigrid_torch | tar -x -C OTHER_DIR`); it is
loaded beside this checkout's package under its own module name and builds
its own kernels. On one flagship hierarchy (built by this checkout), it
times runs of 10 cycles of each design in three rounds of turns (other,
this, this, other; 11 runs a turn; the median of each design's runs) and
profiles one cycle of each: the device ops, the device time, the idle
share of the unprofiled cycle and the port's kernel launches. Then, on
the same seeded inputs, complex64, at the flagship's shapes (links rbgs x4
at L=256; dense rbgs x4 at n=4 L=128, L=64, the 4 NTL copies at L=32 and
setup at n=2 L=256 with k=2 sharing D; dense Jacobi x4 at n=4 L=128) and
the large flagship's x-tiled shapes (links rbgs x4 at L=2048; dense rbgs
x4 at n=4 L=1024, 512 and 256, and setup at n=2 L=2048 with k=2 sharing
D), it times one wrapper call of each design in the same turns (21 calls a
turn, each between CUDA events), profiles ten calls of each for the device
time a call, and reports the largest difference between their results,
the launches of a call and, where a package counts them
(cuda_stencil.rb_sweeps), the dense red-black sweeps by the launch that
ran them (two a column-march pass, one a launch).

Then the large flagship (the same config at L=2048, 6 levels): on one
hierarchy built by this checkout, runs of 4 cycles of each design's cycle
code in three rounds of turns (5 runs a turn), one profiled cycle of
each (its launches, B6's among them, and red-black sweeps by launch),
and the warm setup seconds of each design's build_hierarchy on a
second gauge (after one unmeasured build each), in one round of turns.
Where both designs take a batch of right-hand sides (solve_batched), a
batched cycle of each on the same hierarchy, 8 right-hand sides at L=256
and 2 at L=2048, in turns, with one profiled batched cycle of each.
The single calls also take the cycle's residuals at the flagship's
shapes as each design makes them: level 0's residual and its restriction
(nc=4, 2 x 2 blocks), the dense residual at n=4 L=128 and L=64, and the
min-res apply on the 4 copies at n=4 L=64 (launches: all of the call's);
then the links apply (B8) at L=256 and 1024, the unfused links residual
(B2) at L=256 and 512, and the level-0 convergence check at L=256 and
2048 (cuda_stencil.wilson_u_residual_norm where the package has it, else
B2 then the two float64 norms).
Last, the links apply at L=256 (links_apply, B8) beside torch.sparse.mm
on the operator as a CSR matrix (chip_smoke.stencil_csr): wrapper ms in
turns, and device microseconds a call from the profiler (ten calls a turn,
three rounds of turns).

With --residuals-only it runs only those residual calls, and where both
designs take the dense SpMV's groups (cuda_stencil.dense_groups) also the
batched ones: level 0's fused residual-restriction of 8 right-hand sides,
the level-1 residual of 8 right-hand sides on one D (n=4 L=128), the
min-res apply on the 32 copies of 8 right-hand sides on one D and on the
32 copies of an ensemble of 8 configurations, 4 a D (n=4 L=64), and B2
and the check on 8 right-hand sides at L=256 (r batched; B2 also with r
shared). For each
call, wrapper ms and device microseconds a call in three rounds of turns,
warm and cold (the L2 flushed before each call, as chip_smoke.py's kernel
table reads it).

Prints one JSON object (with the card's name and power limit) as its last
line, and writes it to FILE too when --out is given.
"""
import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent


def load_package(pkg_dir: Path, name: str):
    spec = importlib.util.spec_from_file_location(
        name, pkg_dir / "__init__.py",
        submodule_search_locations=[str(pkg_dir)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def cuda_times(torch, fn, reps):
    """Milliseconds of `reps` runs of fn, each between its own pair of CUDA
    events, after one warm-up run."""
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
    return times


def in_turns(torch, other, this, reps, rounds=3):
    """(other ms, this ms, medians of each turn): `rounds` rounds of turns
    other, this, this, other, `reps` runs a turn; each design's ms is the
    median of all its runs (the host's jitter moves single turns)."""
    runs = {other: [], this: []}
    turns = []
    for _ in range(rounds):
        for f in (other, this, this, other):
            t = cuda_times(torch, f, reps)
            runs[f] += t
            turns.append(statistics.median(t))
    return (statistics.median(runs[other]), statistics.median(runs[this]),
            turns)


def profiled(torch, fn, reps=1):
    """(device ops, device seconds, wall seconds) of `reps` runs of fn under
    torch.profiler, after one run outside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in p.events() if e.device_type == DeviceType.CUDA]
    busy = sum(getattr(e, "device_time_total", None)
               or getattr(e, "cuda_time_total", 0.0) for e in events) / 1e6
    return len(events), busy, wall


def rb_sweeps(cs) -> dict:
    """The dense x-tiled red-black sweeps by the launch that ran them
    (cuda_stencil.rb_sweeps: two a column-march pass, or one a launch),
    where the package counts them."""
    return dict(getattr(cs, "rb_sweeps", {}))


def profile_cycle(torch, cs, cycle, ms_per_cycle):
    """One cycle under the profiler (cycle() resets the launch counters
    first): device ops, device time and the idle share of the unprofiled
    ms_per_cycle, the kernel launches and the red-black sweeps by launch."""
    ops, busy, wall = profiled(torch, cycle)
    return {"device_ops": ops, "device_ms": busy * 1e3,
            "busy_share_profiled": busy / wall, "wall_ms_profiled": wall * 1e3,
            "idle_share": 1 - busy * 1e3 / ms_per_cycle,
            "launches": {k: v for k, v in cs.launches.items() if v},
            "rb_sweeps": rb_sweeps(cs)}


def device_us_in_turns(torch, other, this, calls=10, rounds=3):
    """(other, this) median device microseconds a call: `calls` calls under
    the profiler a turn, turns other, this, this, other."""
    got = {other: [], this: []}
    for _ in range(rounds):
        for f in (other, this, this, other):
            got[f].append(profiled(torch, f, calls)[1] / calls * 1e6)
    return statistics.median(got[other]), statistics.median(got[this])


def batched_cycles(torch, this, other, cfgs, hier, n_rhs, k, reps, dev):
    """ms a batched cycle of each design on one hierarchy: n_rhs
    right-hand sides (complex normal from default_rng(seed + n_rhs)), runs
    of k cycles in three rounds of turns of `reps` runs; one profiled batched
    cycle of each; the largest difference of their solutions. None when
    the other design has no batch axis."""
    if not hasattr(other, "solve_batched"):
        return None
    cfg = cfgs[this]
    rng = np.random.default_rng(cfg.seed + n_rhs)
    shape = (n_rhs, 2, cfg.L, cfg.L)
    bs = torch.from_numpy(rng.normal(size=shape) + 1j * rng.normal(
        size=shape)).to(dev, cfg.cdtype)

    def cycles(p):
        def run():
            phis = this.zero_fields(cfg, dev, n_rhs)
            for _ in range(k):
                phis, _ = p.cycle(hier, phis, bs, cfgs[p])
            return phis
        return run

    def one_cycle(p):
        state = [this.zero_fields(cfg, dev, n_rhs)]

        def run():
            p.ops.cuda_stencil.reset_launches()
            state[0], _ = p.cycle(hier, state[0], bs, cfgs[p])
        return run

    got_o, got_t = cycles(other)()[0], cycles(this)()[0]
    diff = float((got_t - got_o).abs().max() / got_o.abs().max())
    ms_o, ms_t, turns = in_turns(torch, cycles(other), cycles(this), reps)
    out = {"rhs": n_rhs, "other_ms_per_cycle": ms_o / k,
           "this_ms_per_cycle": ms_t / k, f"turns_ms_{k}_cycles": turns,
           "rel_diff": diff,
           "other_profile": profile_cycle(torch, other.ops.cuda_stencil,
                                          one_cycle(other), ms_o / k),
           "this_profile": profile_cycle(torch, this.ops.cuda_stencil,
                                         one_cycle(this), ms_t / k)}
    print(f"batched cycle L={cfg.L} x{n_rhs}: other {ms_o / k:.4f} ms, this "
          f"{ms_t / k:.4f} ms ({k} cycles a run, 3 rounds of turns of {reps}"
          f" runs); rel diff {diff:.2e}")
    for key in ("other", "this"):
        pr = out[f"{key}_profile"]
        print(f"  {key}: {pr['device_ops']} device ops, "
              f"{pr['device_ms']:.4f} ms of device time a cycle, idle "
              f"{pr['idle_share']:.3f}; launches {pr['launches']}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("--residuals-only", action="store_true",
                    help="only the cycle's residual calls, warm and cold")
    ns = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_smoother_ab: no CUDA device")
    sys.path.insert(0, str(HERE))
    import tpu_multigrid_torch as this
    other = load_package(ns.other.resolve() / "tpu_multigrid_torch",
                         "tmg_other")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    dt = torch.complex64
    rng = np.random.default_rng(20261016)
    m = -0.005

    def c(shape):
        return torch.from_numpy(rng.normal(size=shape)
                                + 1j * rng.normal(size=shape)).to(dev, dt)

    def dense(B, n, L, shared):
        lead = () if B is None else (B,)
        D = 0.25 * c(((1,) if shared or B is None else lead)
                     + (5, n, n, L, L))
        D[:, 0] += 4.0 * torch.eye(n, dtype=dt, device=dev)[:, :, None, None]
        Dinv = this.ops.stencil.site_inverse(D[:, 0])
        if shared or B is None:
            D, Dinv = D[0], Dinv[0]
        return (D, Dinv, c(lead + (n, L, L)),
                c((n, L, L) if shared or B is None else lead + (n, L, L)))

    if ns.residuals_only:
        cases = residual_cases(this, other, c, dense, rng, dev)
        if all(hasattr(p.ops.cuda_stencil, "dense_groups")
               for p in (this, other)):
            cases += batched_residual_cases(c, dense, rng, dev)
        out = {"card": card,
               "residual_calls": residual_calls(torch, this, other, cases)}
        if ns.out is not None:
            ns.out.parent.mkdir(parents=True, exist_ok=True)
            ns.out.write_text(json.dumps(out, indent=1))
        print(json.dumps(out))
        return

    # the flagship cycle first (one hierarchy, each package's cycle
    # code), then the single calls
    cfgs = {p: p.MGConfig(L=256, stencil="wilson", m=m, nlevels=3, ntl=True,
                          num_iters=4, null_iters=100, dtype="complex64",
                          res_threshold=1e-6, smoother="rbgs")
            for p in (other, this)}
    cfg = cfgs[this]
    ph = 0.2 * np.random.default_rng(cfg.seed).normal(size=(2, 256, 256))
    Uf = this.models.gauge.gauge_from_phases(ph, cfg.cdtype, dev)
    hier = this.build_hierarchy(
        this.models.operators.assemble("wilson", Uf, m), cfg, U=Uf)
    b = this.point_source(cfg, device=dev)

    def cycles(p, k):
        def run():
            phis = this.zero_fields(cfg, dev)
            for _ in range(k):
                phis, _ = p.cycle(hier, phis, b, cfgs[p])
            return phis
        return run

    def one_cycle(p):
        """A cycle on from a running solution, the counters reset first."""
        state = [this.zero_fields(cfg, dev)]

        def run():
            p.ops.cuda_stencil.reset_launches()
            state[0], _ = p.cycle(hier, state[0], b, cfgs[p])
        return run

    res = {p: float(this.ops.stencil.residual(
        hier.levels[0].D, cycles(p, 10)()[0], b).norm() / b.norm())
        for p in (other, this)}
    ms_o, ms_t, turns = in_turns(torch, cycles(other, 10), cycles(this, 10),
                                 reps=11)
    cycle = {"other_ms_per_cycle": ms_o / 10, "this_ms_per_cycle": ms_t / 10,
             "turns_ms_10_cycles": turns,
             "other_res_10": res[other], "this_res_10": res[this],
             "other_profile": profile_cycle(torch, other.ops.cuda_stencil,
                                            one_cycle(other), ms_o / 10),
             "this_profile": profile_cycle(torch, this.ops.cuda_stencil,
                                           one_cycle(this), ms_t / 10)}
    print(f"flagship cycle: other {ms_o / 10:.4f} ms, this {ms_t / 10:.4f} "
          f"ms (10 cycles a run, 3 rounds of turns of 11 runs); residual "
          f"after 10: {res[other]:.6e} / {res[this]:.6e}")
    for k in ("other", "this"):
        pr = cycle[f"{k}_profile"]
        print(f"  {k}: {pr['device_ops']} device ops, {pr['device_ms']:.4f} "
              f"ms of device time a cycle, idle {pr['idle_share']:.3f} of the "
              f"unprofiled cycle; launches {pr['launches']}")
    cycle["batched"] = batched_cycles(torch, this, other, cfgs, hier, 8, 10,
                                      5, dev)

    rows = []
    U = torch.polar(torch.ones(2, 256, 256, dtype=torch.float64),
                    torch.from_numpy(0.2 * rng.normal(size=(2, 256, 256)))
                    ).to(dev, dt)
    phi, r = c((2, 256, 256)), c((2, 256, 256))
    cases = [("B1 links rbgs x4 L=256", "links_update",
              lambda p: p.ops.cuda_stencil.wilson_u_smooth(U, m, phi, r, 4,
                                                           "rbgs"))]
    for tag, kind, (B, n, L, shared) in (
            ("B3 rbgs x4 n=4 L=128 (level 1)", "rbgs", (None, 4, 128, False)),
            ("B3 rbgs x4 n=4 L=64 (level 2)", "rbgs", (None, 4, 64, False)),
            ("B3 rbgs x4 n=4 L=32 batch 4 (NTL copies)", "rbgs",
             (4, 4, 32, False)),
            ("B3 rbgs x4 n=2 L=256 k=2 shared D (setup)", "rbgs",
             (2, 2, 256, True)),
            ("B4 jacobi x4 n=4 L=128", "jacobi", (None, 4, 128, False))):
        ops = dense(B, n, L, shared)
        cases.append((tag, "dense_update",
                      lambda p, o=ops, k=kind: p.ops.cuda_stencil.dense_smooth(
                          *o, 4, k)))
    # the large flagship's x-tiled shapes
    Ul = torch.polar(torch.ones(2, 2048, 2048, dtype=torch.float64),
                     torch.from_numpy(0.2 * rng.normal(size=(2, 2048, 2048)))
                     ).to(dev, dt)
    phil, rl = c((2, 2048, 2048)), c((2, 2048, 2048))
    cases.append(("B5a links rbgs x4 L=2048", "links_update_tiled",
                  lambda p: p.ops.cuda_stencil.wilson_u_smooth_tiled(
                      Ul, m, phil, rl, 4, "rbgs")))
    for tag, (B, n, L, shared) in (
            ("B6 rbgs x4 n=4 L=1024 (level 1)", (None, 4, 1024, False)),
            ("B6 rbgs x4 n=4 L=512 (level 2)", (None, 4, 512, False)),
            ("B6 rbgs x4 n=4 L=256 (level 3)", (None, 4, 256, False)),
            ("B6 rbgs x4 n=2 L=2048 k=2 shared D (setup)", (2, 2, 2048, True))):
        ops = dense(B, n, L, shared)
        cases.append((tag, "dense_update_tiled",
                      lambda p, o=ops: p.ops.cuda_stencil.dense_smooth_tiled(
                          *o, 4, "rbgs")))
    cases += residual_cases(this, other, c, dense, rng, dev)
    for tag, kernel, fn in cases:
        got_o, got_t = fn(other), fn(this)
        torch.cuda.synchronize()
        diff = float((got_t - got_o).abs().max() / got_o.abs().max())
        for pkg in (other, this):
            pkg.ops.cuda_stencil.reset_launches()
        fn(other)
        fn(this)
        n_o = sum(other.ops.cuda_stencil.launches.values())
        n_t = sum(this.ops.cuda_stencil.launches.values())
        rb_o = rb_sweeps(other.ops.cuda_stencil)
        rb_t = rb_sweeps(this.ops.cuda_stencil)
        ms_o, ms_t, turns = in_turns(torch, lambda: fn(other),
                                     lambda: fn(this), reps=21)
        dev_o = profiled(torch, lambda: fn(other), 10)[1] * 1e5
        dev_t = profiled(torch, lambda: fn(this), 10)[1] * 1e5
        rows.append({"case": tag, "other_ms": ms_o, "this_ms": ms_t,
                     "turns_ms": turns, "other_launches": n_o,
                     "this_launches": n_t, "other_rb_sweeps": rb_o,
                     "this_rb_sweeps": rb_t, "other_device_us": dev_o,
                     "this_device_us": dev_t, "rel_diff": diff})
        print(f"{tag:44s} other {ms_o:.4f} ms ({n_o} launches, device "
              f"{dev_o:.1f} us)  this {ms_t:.4f} ms ({n_t}, device "
              f"{dev_t:.1f} us)  rel diff {diff:.2e}"
              + (f"  red-black sweeps by launch {rb_o} / {rb_t}"
                 if rb_o or rb_t else ""), flush=True)

    del cases, ops, Ul, phil, rl
    large = large_flagship(torch, this, other, dev)
    b8 = links_apply_vs_library(torch, this, other, dev, rng)
    out = {"card": card, "kernels": rows, "flagship_cycle": cycle,
           "large_flagship": large, "links_apply_vs_sparse_mm": b8}
    if ns.out is not None:
        ns.out.parent.mkdir(parents=True, exist_ok=True)
        ns.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out))


def spmv_of(p):
    """The module of package p that dispatches the dense SpMV and residual
    (apply_D, residual): ops.dispatch where p has it, else
    ops.cuda_stencil (None where p has neither)."""
    return getattr(p.ops, "dispatch", None) or (
        p.ops.cuda_stencil if hasattr(p.ops.cuda_stencil, "residual")
        else None)


def residual_cases(this, other, c, dense, rng, dev):
    """The cycle's residual calls at the flagship's shapes, as each design
    makes them (a `cases` row: tag, kernel, fn(package)): level 0's
    residual and its restriction (the fused kernel where the package has
    it, else B2 then the plain restriction), the dense residual at n=4
    L=128 and L=64 (the dispatched residual where the package has one,
    spmv_of, else the plain stencil.residual), and the min-res apply on
    the 4 copies at n=4 L=64 on a shared D (dense_apply)."""
    m, L = -0.005, 256
    U = links(rng, L, dev)
    phi, r, pn = c((2, L, L)), c((2, L, L)), c((4, 2, L, L))

    def fused(p):
        cs = p.ops.cuda_stencil
        if hasattr(cs, "wilson_u_residual_restrict"):
            return cs.wilson_u_residual_restrict(U, m, phi, r, pn, 1, 2, 2)
        return p.ops.transfer.restrict(pn, cs.wilson_u_residual(U, m, phi, r),
                                       1, 2, 2)

    def dense_residual(ops):
        D, _, v, rr = ops

        def run(p):
            return (spmv_of(p) or p.ops.stencil).residual(D, v, rr)
        return run

    D64, _, _, _ = dense(None, 4, 64, False)
    xs = c((4, 4, 64, 64))
    U1024, v1024 = links(rng, 1024, dev), c((2, 1024, 1024))
    U512, phi512, r512 = links(rng, 512, dev), c((2, 512, 512)), c((2, 512,
                                                                     512))
    U2048, phi2048, r2048 = (links(rng, 2048, dev), c((2, 2048, 2048)),
                             c((2, 2048, 2048)))
    return [("B2 residual + restrict L=256 nc=4 2x2", "links_residual",
             fused),
            ("B7a residual n=4 L=128 (level 1)", "dense_residual",
             dense_residual(dense(None, 4, 128, False))),
            ("B7a residual n=4 L=64 (level 2)", "dense_residual",
             dense_residual(dense(None, 4, 64, False))),
            ("B7a min-res apply x4 n=4 L=64 shared D", "dense_apply",
             lambda p: p.ops.cuda_stencil.dense_apply(D64, xs)),
            ("B8 links apply L=256", "links_apply",
             lambda p: p.ops.cuda_stencil.wilson_u_apply(U, m, phi)),
            ("B8 links apply L=1024", "links_apply",
             lambda p: p.ops.cuda_stencil.wilson_u_apply(U1024, m, v1024)),
            ("B2 residual L=256", "links_residual",
             lambda p: p.ops.cuda_stencil.wilson_u_residual(U, m, phi, r)),
            ("B2 residual L=512", "links_residual",
             lambda p: p.ops.cuda_stencil.wilson_u_residual(U512, m, phi512,
                                                            r512)),
            ("level-0 check L=256", "links_residual_norm",
             lambda p: level0_check(p, U, m, phi, r)),
            ("level-0 check L=2048", "links_residual_norm",
             lambda p: level0_check(p, U2048, m, phi2048, r2048))]


def links(rng, L, dev):
    """U(1) links of phases 0.2 N(0, 1), complex64."""
    import torch
    return torch.polar(torch.ones(2, L, L, dtype=torch.float64),
                       torch.from_numpy(0.2 * rng.normal(size=(2, L, L)))
                       ).to(dev, torch.complex64)


def level0_check(p, U, m, phi, b):
    """||b - D_U phi|| / ||b|| as package p computes it: its one-launch
    check where it has one, else its links residual (x-tiled past the L2,
    u_mode) and two float64 norms."""
    import torch
    cs = p.ops.cuda_stencil
    if hasattr(cs, "wilson_u_residual_norm"):
        return cs.wilson_u_residual_norm(U, m, phi, b)
    tiled = cs.u_mode(phi.shape[-1], phi.dtype) == "tiled"
    res = (cs.wilson_u_residual_tiled if tiled
           else cs.wilson_u_residual)(U, m, phi, b)

    def norm(x):
        return torch.sqrt(torch.sum(x.abs() ** 2, dim=(-3, -2, -1),
                                    dtype=torch.float64))
    return (norm(res) / norm(b)).to(b.real.dtype)


def batched_residual_cases(c, dense, rng, dev):
    """The residual calls of a batched cycle (8 right-hand sides on the
    flagship's hierarchy) and of an ensemble's (8 configurations, 4 copies
    a configuration at the min-res), as `cases` rows."""
    m, L = -0.005, 256
    U = links(rng, L, dev)
    phi, r, pn = c((8, 2, L, L)), c((8, 2, L, L)), c((4, 2, L, L))
    D128, _, _, _ = dense(None, 4, 128, False)
    v128, r128 = c((8, 4, 128, 128)), c((8, 4, 128, 128))
    D64, _, _, _ = dense(None, 4, 64, False)
    D64e, _, _, _ = dense(8, 4, 64, False)
    xs = c((32, 4, 64, 64))
    return [("B2 residual + restrict L=256 nc=4 2x2 batch 8",
             "links_residual_restrict",
             lambda p: p.ops.cuda_stencil.wilson_u_residual_restrict(
                 U, m, phi, r, pn, 1, 2, 2)),
            ("B7a residual n=4 L=128 batch 8 shared D", "dense_residual",
             lambda p: spmv_of(p).residual(D128, v128, r128)),
            ("B7a min-res apply x32 n=4 L=64 shared D", "dense_apply",
             lambda p: p.ops.cuda_stencil.dense_apply(D64, xs)),
            ("B7a min-res apply x32 n=4 L=64 on 8 D", "dense_apply",
             lambda p: p.ops.cuda_stencil.dense_apply(D64e, xs)),
            ("B2 residual L=256 batch 8", "links_residual",
             lambda p: p.ops.cuda_stencil.wilson_u_residual(U, m, phi, r)),
            ("B2 residual L=256 batch 8 shared r", "links_residual",
             lambda p: p.ops.cuda_stencil.wilson_u_residual(U, m, phi,
                                                            r[0])),
            ("level-0 check L=256 batch 8", "links_residual_norm",
             lambda p: level0_check(p, U, m, phi, r))]


def residual_calls(torch, this, other, cases, rounds=3):
    """Each case of each design: the largest difference of their results,
    the launches of a call, wrapper ms (in_turns) and device microseconds
    a call, warm and cold (chip_smoke.device_us, with and without an L2
    flush before each call), in `rounds` rounds of turns other, this,
    this, other; the median of each design's turns."""
    sys.path.insert(0, str(HERE))
    from chip_smoke import L2_FLUSH_BYTES, device_us
    flush = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                        device="cuda").bitwise_not_
    rows = []
    for tag, kernel, fn in cases:
        got_o, got_t = fn(other), fn(this)
        torch.cuda.synchronize()
        diff = float((got_t - got_o).abs().max() / got_o.abs().max())
        launches = {}
        for p in (other, this):
            p.ops.cuda_stencil.reset_launches()
            fn(p)
            launches[p] = sum(p.ops.cuda_stencil.launches.values())
        ms_o, ms_t, _ = in_turns(torch, lambda: fn(other), lambda: fn(this),
                                 reps=21)
        us = {(p, cold): [] for p in (other, this) for cold in (False, True)}
        for _ in range(rounds):
            for p in (other, this, this, other):
                for cold in (False, True):
                    us[p, cold].append(device_us(
                        torch, lambda p=p: fn(p), flush=flush if cold
                        else None))

        def med(p, cold):
            got = [u for u in us[p, cold] if u is not None]
            return statistics.median(got) if got else None

        row = {"case": tag, "kernel": kernel, "rel_diff": diff,
               "other_launches": launches[other],
               "this_launches": launches[this], "other_ms": ms_o,
               "this_ms": ms_t, "other_device_us": med(other, False),
               "this_device_us": med(this, False),
               "other_device_us_cold": med(other, True),
               "this_device_us_cold": med(this, True),
               "turns_device_us": {f"{'this' if p is this else 'other'}_"
                                   f"{'cold' if cold else 'warm'}": v
                                   for (p, cold), v in us.items()}}
        rows.append(row)
        print(f"{tag:48s} device us warm other {row['other_device_us']} / "
              f"this {row['this_device_us']}, cold other "
              f"{row['other_device_us_cold']} / this "
              f"{row['this_device_us_cold']}; ms {ms_o:.4f} / {ms_t:.4f}; "
              f"launches {launches[other]} / {launches[this]}; rel diff "
              f"{diff:.2e}", flush=True)
    return rows


def large_flagship(torch, this, other, dev):
    """The large flagship (L=2048, 6 levels): ms per cycle of each design
    on one hierarchy, in turns; one profiled cycle of each; warm setup
    seconds of each design in one round of turns."""
    m = -0.005
    cfgs = {p: p.MGConfig(L=2048, stencil="wilson", m=m, nlevels=6, ntl=True,
                          num_iters=4, null_iters=100, dtype="complex64",
                          res_threshold=1e-6, smoother="rbgs")
            for p in (other, this)}
    cfg = cfgs[this]
    rng = np.random.default_rng(cfg.seed)
    gauges = []
    for _ in range(2):
        U = this.models.gauge.gauge_from_phases(
            0.2 * rng.normal(size=(2, 2048, 2048)), cfg.cdtype, dev)
        gauges.append((U, this.models.operators.assemble("wilson", U, m)))
    (U, D), (Ub, Db) = gauges
    hier = this.build_hierarchy(D, cfg, U=U, check=False)
    b = this.point_source(cfg, device=dev)

    def cycles(p, k):
        def run():
            phis = this.zero_fields(cfg, dev)
            for _ in range(k):
                phis, _ = p.cycle(hier, phis, b, cfgs[p])
            return phis
        return run

    def one_cycle(p):
        state = [this.zero_fields(cfg, dev)]

        def run():
            p.ops.cuda_stencil.reset_launches()
            state[0], _ = p.cycle(hier, state[0], b, cfgs[p])
        return run

    res = {p: float(this.ops.stencil.residual(
        hier.levels[0].D, cycles(p, 4)()[0], b).norm() / b.norm())
        for p in (other, this)}
    ms_o, ms_t, turns = in_turns(torch, cycles(other, 4), cycles(this, 4),
                                 reps=5)
    out = {"other_ms_per_cycle": ms_o / 4, "this_ms_per_cycle": ms_t / 4,
           "turns_ms_4_cycles": turns, "other_res_4": res[other],
           "this_res_4": res[this],
           "other_profile": profile_cycle(torch, other.ops.cuda_stencil,
                                          one_cycle(other), ms_o / 4),
           "this_profile": profile_cycle(torch, this.ops.cuda_stencil,
                                         one_cycle(this), ms_t / 4)}
    print(f"large flagship cycle: other {ms_o / 4:.4f} ms, this "
          f"{ms_t / 4:.4f} ms (4 cycles a run, 3 rounds of turns of 5 runs);"
          f" residual after 4: {res[other]:.6e} / {res[this]:.6e}")
    for k in ("other", "this"):
        pr = out[f"{k}_profile"]
        print(f"  {k}: {pr['device_ops']} device ops, {pr['device_ms']:.4f} "
              f"ms of device time a cycle, idle {pr['idle_share']:.3f}; "
              f"launches {pr['launches']} (B6: "
              f"{pr['launches'].get('dense_update_tiled', 0)}); red-black "
              f"sweeps by launch {pr['rb_sweeps']}")
    out["batched"] = batched_cycles(torch, this, other, cfgs, hier, 2, 4, 3,
                                    dev)
    del hier

    def setup(p):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        h = p.build_hierarchy(Db, cfgs[p], U=Ub, check=False)
        torch.cuda.synchronize()
        del h
        return time.perf_counter() - t0

    for p in (other, this):          # first builds: kernels, caches
        setup(p)
    warm = {other: [], this: []}
    for p in (other, this, this, other):
        warm[p].append(setup(p))
    out.update(other_setup_warm_s=warm[other], this_setup_warm_s=warm[this])
    print(f"large flagship warm setup (second gauge, check=False): other "
          f"{warm[other]} s, this {warm[this]} s")
    return out


def links_apply_vs_library(torch, this, other, dev, rng):
    """B8 (links_apply) at L=256 beside torch.sparse.mm on the operator as
    one CSR matrix: wrapper ms in turns, device us a call in turns."""
    sys.path.insert(0, str(HERE))
    from chip_smoke import stencil_csr
    m, L = -0.005, 256
    U = links(rng, L, dev)
    v = torch.from_numpy(rng.normal(size=(2, L, L))
                         + 1j * rng.normal(size=(2, L, L))).to(
                             dev, torch.complex64)
    A = stencil_csr(torch, this.models.operators.assemble("wilson", U, m))

    def kernel():
        return this.ops.cuda_stencil.wilson_u_apply(U, m, v)

    def library():
        return torch.sparse.mm(A, v.reshape(-1, 1))

    diff = float((library().reshape(v.shape) - kernel()).abs().max()
                 / kernel().abs().max())
    lib_ms, ker_ms, turns = in_turns(torch, library, kernel, reps=21)
    lib_us, ker_us = device_us_in_turns(torch, library, kernel)
    print(f"B8 links apply L=256: kernel {ker_ms:.4f} ms ({ker_us:.2f} us on "
          f"the device), torch.sparse.mm {lib_ms:.4f} ms ({lib_us:.2f} us); "
          f"rel diff {diff:.1e}")
    return {"kernel_ms": ker_ms, "library_ms": lib_ms, "turns_ms": turns,
            "kernel_device_us": ker_us, "library_device_us": lib_us,
            "rel_diff": diff}


if __name__ == "__main__":
    main()
