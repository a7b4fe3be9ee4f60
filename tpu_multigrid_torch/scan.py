"""Parameter-scan orchestrator (counterpart of tpu_multigrid/scan.py): the
analog of the reference's submission notebook
(code/0_submit_2d_laplace.ipynb cells 3-7), which loops
`./a.out L m nlevels n_iters` over nested parameter lists and accumulates
one summary line per run in results_gen_scaling.txt for the
scaling-analysis notebooks (SURVEY.md §2.1, §5.5).

The scan runs in one process; every point appends the reference-format
scaling line (through utils.io.ResultsWriter) and a machine-readable
scan_summary.jsonl row.

Usage (comma-separated values expand into a cartesian product):

  python -m tpu_multigrid_torch.scan --L 128 --m 0.002,0.004,0.01 \
      --nlevels 1,3 --num-iters 20 --stencil laplace --out-dir scans

Points that diverge or hit max-iters are recorded (converged=false), and
a point that raises is recorded with its error; neither stops the scan,
as in the notebook. --platform names the torch device (default cuda; a
missing device is an error).
"""
from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import sys
import time


def _intlist(s):
    return [int(x) for x in s.split(",")]


def _floatlist(s):
    return [float(x) for x in s.split(",")]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu_multigrid_torch.scan",
                                description=__doc__)
    p.add_argument("--L", type=_intlist, default=[64])
    p.add_argument("--m", type=_floatlist, default=[0.002])
    p.add_argument("--nlevels", type=_intlist, default=[2])
    p.add_argument("--num-iters", type=_intlist, default=[20])
    p.add_argument("--n-copies", type=_intlist, default=[4])
    p.add_argument("--stencil", choices=["laplace", "wilson"],
                   default="laplace")
    p.add_argument("--smoother", default="rbgs")
    p.add_argument("--ntl", action="store_true")
    p.add_argument("--block", type=int, default=2)
    p.add_argument("--null-iters", type=int, default=500)
    p.add_argument("--res-threshold", type=float, default=1e-13)
    p.add_argument("--max-iters", type=int, default=50000)
    p.add_argument("--dtype", choices=["complex64", "complex128"],
                   default="complex128")
    p.add_argument("--seed", type=int, default=4302529)
    p.add_argument("--beta", type=float, default=32.0)
    p.add_argument("--gauge", choices=["identity", "random", "heatbath"],
                   default="identity")
    p.add_argument("--heatbath-sweeps", type=int, default=100)
    p.add_argument("--out-dir", default="scans")
    p.add_argument("--platform", default="cuda",
                   help="torch device: cuda (default), cuda:K or cpu")
    return p


def run_point(cfg, gauge_kind: str, heatbath_sweeps: int, out_dir: str,
              device):
    """One scan point: gauge -> operator -> hierarchy -> solve_chunked.

    Returns the summary dict; appends the reference scaling line
    (results_gen_scaling.txt, modules_main.h:472 format)."""
    import torch
    import tpu_multigrid_torch as mgt
    from .cli import _sync
    from .models import gauge as G
    from .utils import io as mio

    if gauge_kind == "identity":
        U = G.identity_gauge(cfg.L, cfg.cdtype, device)
    elif gauge_kind == "random":
        U = G.random_gauge(cfg.L, torch.Generator().manual_seed(cfg.seed),
                           0.2, cfg.cdtype, device)
    else:
        th = G.heatbath_ensemble(cfg.L, cfg.beta, heatbath_sweeps, cfg.seed)
        U = G.gauge_from_phases(th, cfg.cdtype, device)
    D = mgt.models.operators.assemble(cfg.stencil, U, cfg.m)

    t0 = time.time()
    hier = mgt.build_hierarchy(D, cfg, check=False, U=U)
    _sync(device)
    t_setup = time.time() - t0
    b = mgt.point_source(cfg, device=device)
    t0 = time.time()
    out = mgt.solve_chunked(hier, b, cfg, max_iters=cfg.max_iters, chunk=10)
    _sync(device)
    t_solve = time.time() - t0

    writer = mio.ResultsWriter(cfg, out_dir, jsonl=False)
    writer.write_scaling_summary(out.iters)
    writer.close()
    return {"L": cfg.L, "m": cfg.m, "stencil": cfg.stencil,
            "nlevels": cfg.nlevels, "num_iters": cfg.num_iters,
            "ntl": cfg.ntl, "n_copies": cfg.n_copies,
            "iters": int(out.iters), "resmag": float(out.resmag),
            "converged": bool(out.converged),
            "setup_seconds": t_setup, "solve_seconds": t_solve}


def main(argv=None) -> int:
    ns = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    from .cli import _device
    from .config import MGConfig
    device = _device(ns)

    os.makedirs(ns.out_dir, exist_ok=True)
    summary_path = os.path.join(ns.out_dir, "scan_summary.jsonl")
    n_fail = 0
    points = list(itertools.product(ns.L, ns.m, ns.nlevels, ns.num_iters,
                                    ns.n_copies))
    for i, (L, m, nlevels, num_iters, n_copies) in enumerate(points):
        nlevels = min(nlevels, int(math.log2(L) / math.log2(ns.block)) - 1)
        cfg = MGConfig(L=L, stencil=ns.stencil, m=m, nlevels=nlevels,
                       block_x=ns.block, block_y=ns.block,
                       num_iters=num_iters, smoother=ns.smoother,
                       ntl=ns.ntl, n_copies=n_copies,
                       null_iters=ns.null_iters,
                       res_threshold=ns.res_threshold,
                       max_iters=ns.max_iters, dtype=ns.dtype,
                       seed=ns.seed, beta=ns.beta)
        tag = (f"[{i + 1}/{len(points)}] L={L} m={m} nlevels={nlevels} "
               f"num_iters={num_iters} n_copies={n_copies}")
        try:
            row = run_point(cfg, ns.gauge, ns.heatbath_sweeps, ns.out_dir,
                            device)
            print(f"{tag}: {'converged' if row['converged'] else 'STALLED'} "
                  f"in {row['iters']} cycles ({row['solve_seconds']:.1f}s)",
                  flush=True)
        except Exception as e:  # record and continue, like the notebook
            n_fail += 1
            row = {"L": L, "m": m, "nlevels": nlevels,
                   "num_iters": num_iters, "n_copies": n_copies,
                   "error": str(e)[:300]}
            print(f"{tag}: ERROR {str(e)[:120]}", flush=True)
        with open(summary_path, "a") as f:
            f.write(json.dumps(row) + "\n")
    print(f"scan done: {len(points) - n_fail}/{len(points)} points ok "
          f"-> {summary_path}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    sys.exit(main())
