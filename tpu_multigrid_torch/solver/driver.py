"""Outer solve drivers (counterpart of tpu_multigrid/solver/driver.py;
reference f_perform_MG, modules_main.h:442-481): iterate MG cycles until
the relative level-0 residual drops below cfg.res_threshold, stopping on
divergence (> cfg.div_threshold) or a non-finite residual.

`solve_ir` reaches the reference's 1e-13 from a complex64 hierarchy by
mixed-precision iterative refinement; `solve_fmg` starts the cycles from
the full-multigrid guess; `solve_with_history` records the residual and
the NTL weights of every cycle (and the reference's results files through
a utils.io.ResultsWriter); `mr_solve` is the unpreconditioned baseline.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..config import MGConfig
from ..ops import cuda_stencil
from ..ops.stencil import residual
from .cycles import cycle, fmg_init, residual_norm_ratio0
from .hierarchy import Hierarchy, cast_hierarchy, zero_fields


@dataclasses.dataclass
class SolveResult:
    phi: torch.Tensor        # level-0 solution, on the solve's device
    iters: int
    resmag: float
    converged: bool
    # residual per recorded step; one entry per `history_stride` cycles
    # (stride 1 except solve_ir, which records once per host check of
    # `inner_cycles` * `outer_chunk` cycles)
    history: Optional[np.ndarray] = None
    history_stride: int = 1
    ntl_weights: Optional[np.ndarray] = None      # [iters, n_copies]
    level_residuals: Optional[list] = None


def _stop(resmag: float, cfg: MGConfig) -> bool:
    return (resmag < cfg.res_threshold or resmag > cfg.div_threshold
            or not math.isfinite(resmag))


def solve(hier: Hierarchy, b: torch.Tensor, cfg: MGConfig,
          phis0=None, max_iters: Optional[int] = None) -> SolveResult:
    """Cycle until converged, checking the residual after every cycle."""
    max_iters = max_iters or cfg.max_iters
    phis = phis0 if phis0 is not None else zero_fields(cfg, b.device)
    it, res = 0, 1.0
    while it < max_iters and cfg.res_threshold < res < cfg.div_threshold:
        phis, _ = cycle(hier, phis, b, cfg)
        res = float(residual_norm_ratio0(hier, phis[0], b, cfg))
        it += 1
    return SolveResult(phi=phis[0], iters=it, resmag=res,
                       converged=res < cfg.res_threshold)


def solve_chunked(hier: Hierarchy, b: torch.Tensor, cfg: MGConfig,
                  phis0=None, max_iters: Optional[int] = None,
                  chunk: int = 10) -> SolveResult:
    """Run `chunk` cycles between host convergence checks (the iteration
    count is reported at chunk granularity, as in the JAX package)."""
    max_iters = max_iters or cfg.max_iters
    phis = phis0 if phis0 is not None else zero_fields(cfg, b.device)
    it = 0
    resmag = float("inf")
    while it < max_iters:
        for _ in range(chunk):
            phis, _ = cycle(hier, phis, b, cfg)
        it += chunk
        resmag = float(residual_norm_ratio0(hier, phis[0], b, cfg))
        if _stop(resmag, cfg):
            break
    return SolveResult(phi=phis[0], iters=it, resmag=resmag,
                       converged=resmag < cfg.res_threshold)


def solve_fmg(hier: Hierarchy, b: torch.Tensor, cfg: MGConfig,
              n_vcycles: int = 1, max_iters: Optional[int] = None,
              chunk: int = 10) -> SolveResult:
    """Full-multigrid solve: the FMG initial guess (cycles.fmg_init), then
    solve_chunked. The reported `iters` counts the FMG sweep as one
    cycle."""
    phis0 = fmg_init(hier, b, cfg, n_vcycles)
    out = solve_chunked(hier, b, cfg, phis0=phis0, max_iters=max_iters,
                        chunk=chunk)
    return dataclasses.replace(out, iters=out.iters + 1)


def solve_ir(hier: Hierarchy, b: torch.Tensor, cfg: MGConfig,
             inner_cycles: int = 2, max_iters: Optional[int] = None,
             inner_dtype: str = "complex64", D_outer=None,
             outer_chunk: int = 1) -> SolveResult:
    """Mixed-precision iterative refinement (defect correction).

    The outer loop runs in cfg.dtype (complex128 for the reference's 1e-13
    criterion): r = b - D_outer phi and the update are exact. Each outer
    step runs `inner_cycles` MG cycles in `inner_dtype` on the normalized
    defect D e = r / |r| (in complex64 on the hand kernels), so the true
    residual contracts by the inner cycles' factor per step.

    The hierarchy may be built in cfg.dtype (its inner view is a cast) or
    directly in `inner_dtype`, with the exact level-0 operator passed as
    `D_outer` (converted to cfg.dtype on b's device; default: the
    hierarchy's level-0 D). The host reads the residual back every
    `outer_chunk` outer steps; history holds one entry per read-back, with
    history_stride = inner_cycles * outer_chunk.
    """
    max_iters = max_iters or cfg.max_iters
    cfg_in = cfg.replace(dtype=inner_dtype)
    hier_in = cast_hierarchy(hier, cfg_in.cdtype)
    if D_outer is None:
        D_outer = hier.levels[0].D
    if not isinstance(D_outer, torch.Tensor):
        D_outer = torch.from_numpy(np.array(D_outer))
    D_outer = D_outer.to(device=b.device, dtype=cfg.cdtype)
    phi = torch.zeros((cfg.n_dof[0], cfg.L, cfg.L), dtype=cfg.cdtype,
                      device=b.device)
    r = b
    bn = torch.sqrt(torch.sum(b.abs() ** 2))

    def step(phi, r):
        rn = torch.sqrt(torch.sum(r.abs() ** 2))
        safe = torch.where(rn > 0, rn, torch.ones_like(rn))
        r_in = (r / safe).to(cfg_in.cdtype)
        es = zero_fields(cfg_in, b.device)
        for _ in range(inner_cycles):
            es, _ = cycle(hier_in, es, r_in, cfg_in)
        phi = phi + safe * es[0].to(phi.dtype)
        return phi, residual(D_outer, phi, b)

    history = []
    resmag = float("inf")
    outer = 0
    while outer * inner_cycles < max_iters:
        for _ in range(outer_chunk):
            phi, r = step(phi, r)
        outer += outer_chunk
        resmag = float(torch.sqrt(torch.sum(r.abs() ** 2)) / bn)
        history.append(resmag)
        if _stop(resmag, cfg):
            break
    return SolveResult(phi=phi, iters=outer * inner_cycles, resmag=resmag,
                       converged=resmag < cfg.res_threshold,
                       history=np.asarray(history),
                       history_stride=inner_cycles * outer_chunk)


def solve_with_history(hier: Hierarchy, b: torch.Tensor, cfg: MGConfig,
                       phis0=None, max_iters: Optional[int] = None,
                       writer=None) -> SolveResult:
    """Cycle until converged, recording the relative residual and the NTL
    weights of every cycle; `writer` (utils.io.ResultsWriter, the
    reference's per-iteration output surface) records cycles 1,
    1 + write_interval, ..."""
    max_iters = max_iters or cfg.max_iters
    phis = phis0 if phis0 is not None else zero_fields(cfg, b.device)
    history, weights = [], []
    resmag = float("inf")
    it = 0
    for it in range(1, max_iters + 1):
        phis, a = cycle(hier, phis, b, cfg)
        resmag = float(residual_norm_ratio0(hier, phis[0], b, cfg))
        history.append(resmag)
        weights.append(a.cpu().numpy())
        if writer is not None and (it - 1) % cfg.write_interval == 0:
            writer.record(it, hier, phis, b, weights[-1])
        if _stop(resmag, cfg):
            break
    return SolveResult(phi=phis[0], iters=it, resmag=resmag,
                       converged=resmag < cfg.res_threshold,
                       history=np.asarray(history),
                       ntl_weights=np.asarray(weights))


def mr_solve(D, b, tol: float = 1e-8, max_iters: int = 100000,
             chunk: int = 1000):
    """Unpreconditioned minimal-residual iteration — the baseline the MG
    solve must beat by >= 5x in cycle count (BASELINE.json north star).

    x_{k+1} = x_k + alpha r_k with alpha = <D r, r> / <D r, D r>, alpha
    and the norm in the field's dtype. `chunk` steps run between host
    convergence checks, so the count keeps the JAX package's chunk
    granularity. D r is cuda_stencil.apply_D: the SpMV kernel on CUDA
    tensors, the plain version on CPU ones. Returns (x, iters, relres),
    x a tensor on b's device.
    """
    return mr_iterate(lambda v: cuda_stencil.apply_D(D, v), b, b, tol,
                      max_iters, chunk)


def mr_iterate(op, r, b, tol: float, max_iters: int, chunk: int):
    """Minimal-residual steps x += alpha r, r -= alpha op(r) from x = 0 and
    residual r, alpha = <op r, r> / <op r, op r> in the field's dtype;
    `chunk` steps between host checks of ||r|| / ||b||. Returns
    (x, iters, rel)."""
    bn = float(torch.sqrt(torch.sum(b.abs() ** 2)))
    x = torch.zeros_like(r)
    it = 0
    rel = 1.0
    while it < max_iters:
        for _ in range(chunk):
            Ar = op(r)
            alpha = (torch.sum(torch.conj(Ar) * r)
                     / torch.sum(torch.conj(Ar) * Ar))
            x = x + alpha * r
            r = r - alpha * Ar
        it += chunk
        rel = float(torch.sqrt(torch.sum(r.abs() ** 2))) / bn
        if rel < tol or not math.isfinite(rel):
            break
    return x, it, rel
