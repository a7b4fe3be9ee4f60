"""Command-line driver of the PyTorch port (counterpart of
tpu_multigrid/cli.py), mirroring the reference program's phases
(mgrid_ntl.cpp:29-73): config -> gauge -> operator assembly -> near-null
setup -> self-tests -> outer solve -> results files.

Two invocation styles:
  python -m tpu_multigrid_torch.cli 64 20 2 1 0.002 2 1 4     (reference argv:
      L num_iters block gen_null m nlevels t_flag n_copies)
  python -m tpu_multigrid_torch.cli --L 64 --stencil laplace --m 0.002 ...

The flags, printed lines, files and exit code are the JAX CLI's. Where
torch differs: --platform names the torch device (default cuda; a missing
device is an error, never a silent CPU run); --debug-nans raises
FloatingPointError at the first non-finite residual read back;
--no-compile-cache does nothing. --mode geo|geo2 run the gen-1 / gen-2
geometric programs (solver/geometric.py) in float64 on that device.
--mesh is not ported yet and is rejected.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

# the ROADMAP item that will bring the flag this port rejects for now
_NOT_PORTED = {"mesh": "A12 (parallel/ on torch.distributed)"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu_multigrid_torch",
                                description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--mode", choices=["adaptive", "geo", "geo2"],
                   default="adaptive",
                   help="adaptive: final-generation program (default); "
                        "geo: gen-1 geometric MG (2D_laplace_Mgrid.cpp); "
                        "geo2: gen-2 geometric non-telescoping prototype "
                        "(--ntl sets its t_flag, --ntl-combine avg_coarse "
                        "selects the single-interpolation variant)")
    p.add_argument("--geo-ir", action="store_true", dest="geo_ir",
                   help="geo mode: mixed-precision solve (float32 V-cycles "
                        "inside a float64 defect-correction loop)")
    p.add_argument("--L", type=int, default=64)
    p.add_argument("--stencil", choices=["laplace", "wilson"],
                   default="wilson")
    p.add_argument("--m", type=float, default=-0.07)
    p.add_argument("--nlevels", type=int, default=2)
    p.add_argument("--block", type=int, default=2)
    p.add_argument("--num-iters", type=int, default=20)
    p.add_argument("--smoother", choices=["jacobi", "rbgs", "gs_lex"],
                   default="rbgs")
    p.add_argument("--ntl", action="store_true")
    p.add_argument("--n-copies", type=int, default=4)
    p.add_argument("--no-min-res", action="store_true")
    p.add_argument("--ntl-combine", default="auto",
                   choices=["auto", "minres", "avg_prolong", "avg_coarse"])
    p.add_argument("--gen-null", type=int, default=1,
                   help="1: generate near-null; 0: read from checkpoint")
    p.add_argument("--null-iters", type=int, default=500)
    p.add_argument("--res-threshold", type=float, default=1e-13)
    p.add_argument("--max-iters", type=int, default=50000)
    p.add_argument("--quad", type=int, default=1)
    p.add_argument("--beta", type=float, default=32.0)
    p.add_argument("--seed", type=int, default=4302529)
    p.add_argument("--dtype", choices=["complex64", "complex128"],
                   default="complex128")
    p.add_argument("--gauge", choices=["identity", "random", "heatbath",
                                       "file"], default="identity")
    p.add_argument("--gauge-file", type=str, default=None,
                   help="phase file (heat-bath format) to read links from")
    p.add_argument("--heatbath-sweeps", type=int, default=100)
    p.add_argument("--out-dir", type=str, default=".")
    p.add_argument("--skip-tests", action="store_true")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="near-null checkpoint path (.npz or reference .txt)")
    p.add_argument("--platform", type=str, default="cuda",
                   help="torch device: cuda (default), cuda:K or cpu; a "
                        "missing device is an error")
    p.add_argument("--solver", choices=["stationary", "fgmres", "ir",
                                        "fmg", "eo_mr", "cgnr"],
                   default="stationary",
                   help="outer iteration: stationary MG cycles (reference "
                        "behavior), MG-preconditioned flexible GMRES, "
                        "mixed-precision iterative refinement (complex128 "
                        "defect, complex64 inner cycles), full multigrid "
                        "(FMG nested-iteration start), even-odd "
                        "Schur-preconditioned minimal residual or CGNR (no "
                        "MG hierarchy used by the last two)")
    p.add_argument("--ir-inner-cycles", type=int, default=2,
                   help="MG cycles per iterative-refinement outer step")
    p.add_argument("--ndof-coarse", type=int, default=None,
                   help="coarse dof per site (default: 2 laplace/4 wilson)")
    p.add_argument("--roofline", action="store_true",
                   help="print the per-kernel roofline table before solving")
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError at the first non-finite "
                        "residual read back (the torch analogue of "
                        "jax_debug_nans, the reference's NaN guard)")
    p.add_argument("--resume", type=str, default=None, metavar="STATE.npz",
                   help="checkpoint the solver state here every "
                        "--checkpoint-every cycles and resume from it if "
                        "present (utils.checkpoint.solve_resumable)")
    p.add_argument("--checkpoint-every", type=int, default=50)
    p.add_argument("--mesh", type=str, default=None, metavar="MX,MY",
                   help="distributed solve on an MX x MY device mesh: not "
                        f"ported yet, {_NOT_PORTED['mesh']}")
    p.add_argument("--no-compile-cache", action="store_true",
                   help="accepted and ignored: the port compiles no XLA "
                        "programs, so it has no on-disk compilation cache")
    p.add_argument("--links", choices=["auto", "on", "off"], default="auto",
                   help="level-0 links-only (spin-projected) path: auto = "
                        "complex64 only (default), on = any dtype, off = "
                        "dense stencil everywhere")
    p.add_argument("--no-halo-overlap", action="store_true",
                   help="distributed solves only (MGConfig.halo_overlap)")
    p.add_argument("--null-joint-qr", action="store_true",
                   help="jointly orthonormalize near-null candidates "
                        "during generation (robust on <=4^2 setup "
                        "levels; see ops/nearnull.relax_null_vectors)")
    return p


def parse_args(argv):
    from .config import MGConfig, from_reference_argv
    # Reference positional style: 8 bare numbers.
    if len(argv) >= 8 and all(not a.startswith("-") for a in argv[:8]):
        return from_reference_argv(argv[:8]), build_parser().parse_args(
            argv[8:])
    ns = build_parser().parse_args(argv)
    cfg = MGConfig(
        L=ns.L, stencil=ns.stencil, m=ns.m, nlevels=ns.nlevels,
        block_x=ns.block, block_y=ns.block, num_iters=ns.num_iters,
        smoother=ns.smoother, ntl=ns.ntl, n_copies=ns.n_copies,
        min_res=not ns.no_min_res, ntl_combine=ns.ntl_combine,
        gen_null=bool(ns.gen_null),
        null_iters=ns.null_iters, res_threshold=ns.res_threshold,
        max_iters=ns.max_iters, quad=ns.quad, beta=ns.beta, seed=ns.seed,
        dtype=ns.dtype, ndof_coarse=ns.ndof_coarse, links=ns.links,
        halo_overlap=not ns.no_halo_overlap,
        null_joint_qr=ns.null_joint_qr)
    return cfg, ns


def _device(ns):
    """The torch device --platform names; a parser error (exit 2) when it
    is not a CPU or an available CUDA device."""
    import torch
    try:
        dev = torch.device(ns.platform)
    except RuntimeError:
        dev = None
    if dev is None or dev.type not in ("cpu", "cuda"):
        build_parser().error(f"--platform {ns.platform!r}: expected cpu, "
                             "cuda or cuda:K")
    if dev.type == "cuda" and not (torch.cuda.is_available() and (
            dev.index is None or dev.index < torch.cuda.device_count())):
        build_parser().error(f"--platform {ns.platform}: no such CUDA "
                             "device here (pass --platform cpu to run on "
                             "the CPU)")
    return dev


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _check_finite(x: float, what: str):
    if not math.isfinite(x):
        raise FloatingPointError(f"--debug-nans: non-finite {what} ({x})")


def _run_geometric(ns, dev) -> int:
    """The gen-1 / gen-2 geometric programs (real scalar field, no gauge,
    no hierarchy; the sum|r| norm), with the JAX CLI's lines, summary and
    exit code."""
    from .solver import geometric as geo

    if ns.mode == "geo":
        cfg = geo.GeoConfig(L=ns.L, m=ns.m, nlevels=ns.nlevels,
                            num_iters=ns.num_iters,
                            res_threshold=ns.res_threshold,
                            smoother=ns.smoother)
        b = geo.geo_source(cfg, dev)
        solve = geo.geo_solve_ir if ns.geo_ir else geo.geo_solve
    else:
        combine = "single" if ns.ntl_combine == "avg_coarse" else "divide"
        cfg = geo.Geo2Config(L=ns.L, m=ns.m, nlevels=ns.nlevels,
                             num_iters=ns.num_iters,
                             res_threshold=ns.res_threshold,
                             smoother=ns.smoother, t_flag=ns.ntl,
                             n_copies=min(ns.n_copies, 4), quad=ns.quad,
                             combine=combine)
        b = geo.geo2_source(cfg, dev)
        solve = geo.geo2_solve
    print(f"mode={ns.mode} L={cfg.L} m={cfg.m} nlevels={cfg.nlevels} "
          f"num_iters={cfg.num_iters} smoother={cfg.smoother}")
    t0 = time.time()
    _, iters, res, hist = solve(b, cfg, max_iters=ns.max_iters)
    _sync(dev)
    dt = time.time() - t0
    converged = res < cfg.res_threshold
    status = "converged" if converged else "NOT converged"
    print(f"{status} in {iters} cycles, sum|r| = {res:.3e}, {dt:.1f}s")
    os.makedirs(ns.out_dir, exist_ok=True)
    with open(f"{ns.out_dir}/solve_summary.json", "w") as f:
        json.dump({"mode": ns.mode, "L": cfg.L, "m": cfg.m,
                   "nlevels": cfg.nlevels, "iters": iters,
                   "res_l1": res, "converged": bool(converged),
                   "seconds": dt, "history": list(map(float, hist))}, f)
    return 0 if converged else 1


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    cfg, ns = parse_args(argv)
    if ns.mesh:
        build_parser().error(f"--mesh {ns.mesh} is not ported yet: "
                             f"ROADMAP {_NOT_PORTED['mesh']}")
    dev = _device(ns)
    if ns.mode != "adaptive":
        return _run_geometric(ns, dev)

    import torch
    import tpu_multigrid_torch as mgt
    from .models import gauge as G
    from .utils import io as mio

    print(f"stencil={cfg.stencil} L={cfg.L} m={cfg.m} nlevels={cfg.nlevels} "
          f"ntl={cfg.ntl} smoother={cfg.smoother} dtype={cfg.dtype}")
    print("level sizes:", cfg.sizes, "n_dof:", cfg.n_dof)

    # Gauge field.
    if ns.gauge == "identity":
        U = G.identity_gauge(cfg.L, cfg.cdtype, dev)
    elif ns.gauge == "random":
        U = G.random_gauge(cfg.L, torch.Generator().manual_seed(cfg.seed),
                           0.2, cfg.cdtype, dev)
    elif ns.gauge == "heatbath":
        th = G.heatbath_ensemble(cfg.L, cfg.beta, ns.heatbath_sweeps,
                                 cfg.seed)
        U = G.gauge_from_phases(th, cfg.cdtype, dev)
    else:
        U = G.read_heatbath_file(ns.gauge_file, cfg.L, cfg.cdtype, dev)
    plaq = complex(G.plaquette(U).item())
    print(f"plaquette: {plaq.real:.6f} + {plaq.imag:.2e}i")

    D = mgt.models.operators.assemble(cfg.stencil, U, cfg.m)

    # Near-null setup (optionally from checkpoint, like gen_null=0).
    phi_null_init = None
    if not cfg.gen_null:
        path = ns.checkpoint or mio.near_null_filename(cfg)
        print(f"reading near-null checkpoint {path}")
        phi_null_init = (mio.load_near_null_npz(path)
                         if path.endswith(".npz")
                         else mio.load_near_null_text(path, cfg))

    t0 = time.time()
    # U= -> level-0 links-only path in complex64 solves (cfg.links)
    hier = mgt.build_hierarchy(D, cfg, phi_null_init=phi_null_init, U=U)
    _sync(dev)
    print(f"setup done in {time.time() - t0:.1f}s")

    if cfg.gen_null and ns.checkpoint:
        saver = (mio.save_near_null_npz if ns.checkpoint.endswith(".npz")
                 else mio.save_near_null_text)
        saver(ns.checkpoint, [hier.levels[l].phi_null
                              for l in range(cfg.nlevels)])
        print(f"wrote near-null checkpoint {ns.checkpoint}")

    # Self-test pass (reference f_MG_tests runs before every solve).
    if not ns.skip_tests:
        checks = mgt.testing.run_mg_tests(hier, cfg)
        worst = max(checks.values())
        bad = {k: v for k, v in checks.items()
               if v > mgt.testing.epsilon_for(cfg)}
        print(f"self-tests: {len(checks)} checks, worst {worst:.3e}"
              + (f"  FAILURES: {bad}" if bad else "  (all pass)"))
        if ns.debug_nans:
            _check_finite(sum(checks.values()), "self-test value")

    if ns.roofline:
        tab = mgt.profiling.roofline_table(
            cfg, hier.levels[0].D, mgt.point_source(cfg, device=dev))
        peak = tab["peak_bytes_per_s"]
        print(f"roofline ({tab['device']}, peak "
              + (f"{peak / 1e9:.0f} GB/s):" if peak else "not known):"))
        for row in tab["rows"]:
            frac = (f"{row['bw_frac'] * 100:6.1f}% of peak"
                    if row["bw_frac"] is not None else "")
            print(f"  {row['name']:16s} {row['sec'] * 1e6:9.1f} us  "
                  f"{row['bytes'] / 1e6:8.2f} MB  {frac}")

    b = mgt.point_source(cfg, device=dev)
    writer = mio.ResultsWriter(cfg, ns.out_dir)
    t0 = time.time()
    if ns.resume:
        from .utils.checkpoint import solve_resumable
        out = solve_resumable(hier, b, cfg, ns.resume,
                              checkpoint_every=ns.checkpoint_every)
    elif ns.solver == "fgmres":
        phi, iters, rel = mgt.fgmres_solve(hier, b, cfg)
        out = mgt.SolveResult(phi=phi, iters=iters, resmag=rel,
                              converged=rel < cfg.res_threshold)
    elif ns.solver == "ir":
        out = mgt.solve_ir(hier, b, cfg, inner_cycles=ns.ir_inner_cycles)
    elif ns.solver == "fmg":
        out = mgt.solve_fmg(hier, b, cfg)
    elif ns.solver == "cgnr":
        # indefinite-capable: CG on the normal equations (krylov.py)
        phi, iters, rel = mgt.cgnr_solve(hier.levels[0].D, b,
                                         tol=cfg.res_threshold,
                                         max_iters=cfg.max_iters, chunk=500)
        out = mgt.SolveResult(phi=phi, iters=iters, resmag=rel,
                              converged=rel < cfg.res_threshold)
    elif ns.solver == "eo_mr":
        phi, iters, rel = mgt.eo_mr_solve(hier.levels[0].D, b,
                                          tol=cfg.res_threshold,
                                          max_iters=cfg.max_iters, chunk=200)
        out = mgt.SolveResult(phi=phi, iters=iters, resmag=rel,
                              converged=rel < cfg.res_threshold)
    else:
        out = mgt.solve_with_history(hier, b, cfg, writer=writer)
    _sync(dev)
    dt = time.time() - t0
    writer.write_scaling_summary(out.iters)
    writer.close()
    if ns.debug_nans:
        # every solver stops at the first non-finite residual it reads back
        _check_finite(out.resmag, f"residual after {out.iters} iterations")

    status = "converged" if out.converged else "NOT converged"
    print(f"{status} in {out.iters} cycles, rel residual {out.resmag:.3e}, "
          f"{dt:.1f}s")
    with open(f"{ns.out_dir}/solve_summary.json", "w") as f:
        json.dump({"L": cfg.L, "m": cfg.m, "stencil": cfg.stencil,
                   "nlevels": cfg.nlevels, "ntl": cfg.ntl,
                   "iters": out.iters, "resmag": out.resmag,
                   "converged": out.converged, "seconds": dt,
                   "plaquette": [plaq.real, plaq.imag]}, f)
    return 0 if out.converged else 1


if __name__ == "__main__":
    sys.exit(main())
