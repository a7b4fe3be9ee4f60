"""Outer solve drivers (counterpart of tpu_multigrid/solver/driver.py;
reference f_perform_MG, modules_main.h:442-481): iterate MG cycles until
the relative level-0 residual drops below cfg.res_threshold, stopping on
divergence (> cfg.div_threshold) or a non-finite residual.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from ..config import MGConfig
from .cycles import cycle, residual_norm_ratio0
from .hierarchy import Hierarchy, zero_fields


@dataclasses.dataclass
class SolveResult:
    phi: torch.Tensor        # level-0 solution, on the solve's device
    iters: int
    resmag: float
    converged: bool


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
        if resmag < cfg.res_threshold or resmag > cfg.div_threshold \
                or not math.isfinite(resmag):
            break
    return SolveResult(phi=phis[0], iters=it, resmag=resmag,
                       converged=resmag < cfg.res_threshold)
