"""tpu_multigrid_torch — the PyTorch/CUDA port of `tpu_multigrid`, the
adaptive multigrid solver for 2D lattice operators (gauged Laplace and
Wilson-Dirac). The JAX package is the reference; this package mirrors its
module layout, function names and tensor layouts, and runs the smoother
path through hand-written CUDA kernels (ops/cuda_stencil.py) on CUDA
tensors. It never imports jax.

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
"""
from . import config, models, ops, solver, utils  # noqa: F401
from .config import MGConfig
from .ops import cuda_stencil  # noqa: F401
from .solver.hierarchy import (Hierarchy, LevelOps, NTLOps, build_hierarchy,
                               build_ntl, zero_fields, point_source,
                               cast_hierarchy)
from .solver.cycles import v_cycle, ntl_cycle, cycle, min_res_weights
from .solver.driver import (solve, solve_chunked, solve_ir,
                            solve_with_history, SolveResult)

__version__ = "0.1.0"
