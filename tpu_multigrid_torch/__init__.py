"""tpu_multigrid_torch — the PyTorch/CUDA port of `tpu_multigrid`, the
adaptive multigrid solver for 2D lattice operators (gauged Laplace and
Wilson-Dirac). The JAX package is the reference; this package mirrors its
module layout, function names and tensor layouts, and runs the smoother
path and the SpMV path (the operator application inside `mr_solve`,
`eo_mr_solve`, `cgnr_solve`, `cgnr_solve_ir` and `fgmres_solve`) through
hand-written CUDA kernels (ops/cuda_stencil.py) on CUDA tensors. It never
imports jax.

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
"""
from . import config, models, ops, profiling, solver, utils  # noqa: F401
from .config import MGConfig
from .ops import cuda_stencil  # noqa: F401
from .solver.hierarchy import (Hierarchy, LevelOps, NTLOps, build_hierarchy,
                               build_ntl, zero_fields, point_source,
                               cast_hierarchy)
from .solver.cycles import v_cycle, ntl_cycle, cycle, min_res_weights
from .solver.driver import (solve, solve_chunked, solve_ir,
                            solve_with_history, mr_solve, SolveResult)
from .solver.eo import eo_mr_solve
from .solver.krylov import fgmres_solve, cgnr_solve, cgnr_solve_ir

__version__ = "0.1.0"
