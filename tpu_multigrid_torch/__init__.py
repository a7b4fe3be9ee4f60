"""tpu_multigrid_torch — the PyTorch/CUDA port of `tpu_multigrid`, the
adaptive multigrid solver for 2D lattice operators (gauged Laplace and
Wilson-Dirac). The JAX package is the reference; this package mirrors its
module layout, function names and tensor layouts, and runs the smoother
path and the SpMV path (the operator application inside `mr_solve`,
`eo_mr_solve`, `cgnr_solve`, `cgnr_solve_ir` and `fgmres_solve`) through
hand-written CUDA kernels (ops/cuda_stencil.py) on CUDA tensors. Its
entry points are the JAX package's: `python -m tpu_multigrid_torch.cli`
(the reference program's phases, self-tests and results files) and
`python -m tpu_multigrid_torch.scan`. It never imports jax.

Quick start::

    import numpy as np, torch
    import tpu_multigrid_torch as mgt
    cfg = mgt.MGConfig(L=256, stencil="wilson", m=-0.005, nlevels=3,
                       ntl=True, num_iters=4, null_iters=100,
                       dtype="complex64", res_threshold=1e-6)
    rng = np.random.default_rng(cfg.seed)
    U = mgt.models.gauge.gauge_from_phases(
        0.2 * rng.normal(size=(2, cfg.L, cfg.L)), cfg.cdtype, "cuda")
    D = mgt.models.operators.assemble(cfg.stencil, U, cfg.m)
    hier = mgt.build_hierarchy(D, cfg, U=U)
    out = mgt.solve_chunked(hier, mgt.point_source(cfg, device="cuda"),
                            cfg, chunk=1)

Indefinite Wilson (m=-0.07 on a beta=32 heat-bath ensemble) by CGNR with
complex128 defect correction::

    th = mgt.models.gauge.heatbath_ensemble(128, 32.0, 100, seed=4302529)
    U = mgt.models.gauge.gauge_from_phases(th, torch.complex128, "cuda")
    D128 = mgt.models.operators.assemble("wilson", U, -0.07)
    b = torch.zeros((2, 128, 128), dtype=torch.complex128, device="cuda")
    b[0, 2, 2] = 5.0
    out = mgt.cgnr_solve_ir(D128.to(torch.complex64), D128, b, tol=1e-8)

A batch of right-hand sides on one hierarchy (one kernel launch a call
for the whole batch), an ensemble of gauge configurations, and the
Chebyshev smoother on intervals from the spectral estimators::

    phi, res = mgt.solve_batched(hier, bs, cfg, n_cycles=10)   # bs [B, 2, L, L]
    hier_b = mgt.build_hierarchies_batched(Us, cfg)            # Us [B, 2, L, L]
    phi, res = mgt.solve_ensemble(hier_b, bs, cfg, n_cycles=18)
    out = mgt.solve(hier, b, mgt.eigs.chebyshev_config(cfg, hier))

The gen-1 / gen-2 geometric programs are `mgt.geometric` (also
`python -m tpu_multigrid_torch.cli --mode geo|geo2`), the 1D solvers
`mgt.one_d`.
"""
from . import config, models, ops, profiling, solver, utils  # noqa: F401
from . import testing  # noqa: F401
from .config import MGConfig, from_reference_argv
from .ops import cuda_stencil  # noqa: F401
from .solver.hierarchy import (Hierarchy, LevelOps, NTLOps, build_hierarchy,
                               build_ntl, zero_fields, point_source,
                               cast_hierarchy)
from .solver.cycles import (v_cycle, ntl_cycle, gamma_cycle, cycle,
                            fmg_init, min_res_weights)
from .solver.driver import (solve, solve_chunked, solve_ir, solve_fmg,
                            solve_with_history, solve_batched, mr_solve,
                            SolveResult)
from .solver.ensemble import build_hierarchies_batched, solve_ensemble
from .solver.eo import eo_mr_solve
from .solver.krylov import fgmres_solve, cgnr_solve, cgnr_solve_ir
from .solver import eigs, geometric, one_d  # noqa: F401

__version__ = "0.1.0"


def __getattr__(name):
    # the entry-point modules load on first access, so that
    # `python -m tpu_multigrid_torch.cli` does not find itself imported
    if name in ("cli", "scan"):
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
