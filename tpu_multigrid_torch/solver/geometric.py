"""Generations 1 and 2: geometric multigrid for the free 2D Laplace
equation on a real scalar field (counterpart of
tpu_multigrid/solver/geometric.py; the reference's
code/1_laplace_scalar/2D_laplace_Mgrid.cpp and
code/2_scalar_2d_nontelescoping/telescoping_2d_laplace_Mgrid.cpp).

- operator:  (A phi)(x) = (1/a^2) [ sum_ngb phi - (4 + m^2 a^2) phi ]
  (m enters squared, unlike the adaptive generations)
- lattice spacing doubles per level: a[l] = 2 a[l-1]
- restriction: 4-point block average of the residual; prolongation:
  piecewise-constant injection, additive
- smoother: phi <- scale (sum_ngb phi - r a^2), scale = 1/(4 + m^2 a^2)
- convergence: SUM of |r| (absolute L1, not relative) < threshold
- gen 1: the coarsest level's residual is computed but never smoothed
- gen 2: quadrant-offset transfers, and with t_flag the coarsest
  residual projected 4 ways, the relaxed copies averaged.

No kernel: plain torch on the fields' device (the JAX package runs these
on plain XLA). The lexicographic smoother is the exact in-place
trajectory, by the anti-diagonal wavefront of ops.smoothers.gs_lex_sweep.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.transfer import from_block_frame, to_block_frame


@dataclasses.dataclass(frozen=True)
class GeoConfig:
    """Gen-1 program parameters; defaults = the reference's hardcoded run
    (L=2048, m=0.002, 9 levels, 20 sweeps, threshold 1e-14). omega damps
    Jacobi only (1.0: the reference's undamped trajectory)."""
    L: int = 2048
    m: float = 0.002
    nlevels: int = 9
    num_iters: int = 20
    max_iters: int = 10000
    res_threshold: float = 1.0e-14
    smoother: str = "rbgs"        # 'jacobi' | 'rbgs' | 'gs_lex'
    omega: float = 1.0
    dtype: str = "float64"

    @property
    def sizes(self) -> Tuple[int, ...]:
        return tuple(self.L // (2 ** l) for l in range(self.nlevels + 1))

    @property
    def spacings(self) -> Tuple[float, ...]:
        return tuple(float(2 ** l) for l in range(self.nlevels + 1))

    @property
    def scales(self) -> Tuple[float, ...]:
        return tuple(1.0 / (4.0 + self.m ** 2 * a * a) for a in self.spacings)

    @property
    def rdtype(self) -> torch.dtype:
        return torch.float64 if self.dtype == "float64" else torch.float32


def _ngb_sum(phi):
    return (torch.roll(phi, -1, -2) + torch.roll(phi, 1, -2)
            + torch.roll(phi, -1, -1) + torch.roll(phi, 1, -1))


def geo_residual(phi, b, level: int, cfg: GeoConfig):
    a = cfg.spacings[level]
    return b - (1.0 / (a * a)) * (_ngb_sum(phi) - phi / cfg.scales[level])


def geo_residue_l1(phi, b, cfg: GeoConfig):
    """Reference norm: sum |r| at level 0 (2D_laplace_Mgrid.cpp:44-48)."""
    return torch.sum(torch.abs(geo_residual(phi, b, 0, cfg)))


def geo_residual_floor(phi, b, cfg: GeoConfig) -> float:
    """First-order rounding floor of the computed sum|r| for this phi in
    its own dtype: eps times the sum over sites of the magnitudes of the
    residual expression's terms. Thresholds below it are unreachable
    whatever the solver (the JAX package's geo_residual_floor)."""
    a = cfg.spacings[0]
    mag = (torch.abs(b) + (1.0 / (a * a))
           * (_ngb_sum(torch.abs(phi)) + torch.abs(phi) / cfg.scales[0]))
    return float(torch.finfo(phi.dtype).eps * torch.sum(mag))


def _geo_sweep(phi, r, level, cfg, parity=None, omega=1.0):
    a = cfg.spacings[level]
    upd = cfg.scales[level] * (_ngb_sum(phi) - r * a * a)
    if omega != 1.0:
        upd = phi + omega * (upd - phi)
    if parity is None:
        return upd
    return torch.where(parity, upd, phi)


def geo_smooth(phi, r, level: int, n_sweeps: int, cfg: GeoConfig):
    L = phi.shape[-1]
    ar = torch.arange(L, device=phi.device)
    diag = ar[:, None] + ar[None, :]
    for _ in range(n_sweeps):
        if cfg.smoother == "jacobi":
            phi = _geo_sweep(phi, r, level, cfg, omega=cfg.omega)
        elif cfg.smoother == "gs_lex":
            # the reference's in-place lexicographic relax (order for x {
            # for y }) by its anti-diagonal wavefront
            for d in range(2 * L - 1):
                phi = torch.where(diag == d, _geo_sweep(phi, r, level, cfg),
                                  phi)
        else:  # red-black GS
            red = (diag % 2) == 0
            phi = _geo_sweep(phi, r, level, cfg, red)
            phi = _geo_sweep(phi, r, level, cfg, ~red)
    return phi


def geo_restrict(res):
    """4-point average: [L, L] -> [L/2, L/2]."""
    L = res.shape[-1]
    return 0.25 * res.reshape(L // 2, 2, L // 2, 2).sum(dim=(1, 3))


def geo_prolong(coarse):
    """Constant injection: [Lc, Lc] -> [2Lc, 2Lc]."""
    Lc = coarse.shape[-1]
    out = coarse[:, None, :, None].expand(Lc, 2, Lc, 2)
    return out.reshape(2 * Lc, 2 * Lc)


def geo_vcycle(phis: Tuple, b, cfg: GeoConfig) -> Tuple:
    """One gen-1 V-cycle (2D_laplace_Mgrid.cpp:171-184)."""
    n = cfg.nlevels
    phis = list(phis)
    rs = [b] + [None] * n
    for l in range(n):
        phis[l] = geo_smooth(phis[l], rs[l], l, cfg.num_iters, cfg)
        rs[l + 1] = geo_restrict(geo_residual(phis[l], rs[l], l, cfg))
        phis[l + 1] = torch.zeros_like(phis[l + 1])
    # reference quirk: the coarsest level is never smoothed (the up loop
    # starts at nlevels-1)
    for l in range(n - 1, -1, -1):
        phis[l] = geo_smooth(phis[l], rs[l], l, cfg.num_iters, cfg)
        if l > 0:
            phis[l - 1] = phis[l - 1] + geo_prolong(phis[l])
            phis[l] = torch.zeros_like(phis[l])
    return tuple(phis)


@dataclasses.dataclass(frozen=True)
class Geo2Config(GeoConfig):
    """Gen-2 program parameters; defaults = its hardcoded values
    (telescoping_2d_laplace_Mgrid.cpp:186-276: gs_flag=1, n_copies=2,
    quad=1, threshold 1e-13, max_iters 5000). combine 'divide': each copy
    interpolated with its own quadrant, then the WHOLE fine field divided
    by n_copies (the main program); 'single': the _singleinterpolation
    variant (the first n_single copies averaged, interpolated once)."""
    L: int = 256
    m: float = 0.002
    nlevels: int = 6
    num_iters: int = 20
    max_iters: int = 5000
    res_threshold: float = 1.0e-13
    smoother: str = "gs_lex"
    t_flag: bool = True
    n_copies: int = 2
    quad: int = 1
    combine: str = "divide"
    n_single: int = 1


def quad_restrict(rt, quad: int):
    """Quadrant-offset 4-point average (f_projection, :74-110): the plain
    2x2 block average in that quadrant's block frame."""
    return geo_restrict(to_block_frame(rt, quad))


def quad_prolong(coarse, quad: int):
    """Adjoint quadrant-offset constant injection (f_interpolate,
    :112-143)."""
    return from_block_frame(geo_prolong(coarse), quad)


def geo2_vcycle(phis: Tuple, b, cfg: Geo2Config) -> Tuple:
    """One gen-2 cycle (telescoping_2d_laplace_Mgrid.cpp:277-316):
    quadrant-aware transfers; the coarsest level IS relaxed on the way up;
    with t_flag, the coarsest residual is projected 4 independent ways and
    the relaxed copies are recombined by averaging."""
    n = cfg.nlevels
    phis = list(phis)
    rs = [b] + [None] * n
    r_tel = None
    for l in range(n):
        phis[l] = geo_smooth(phis[l], rs[l], l, cfg.num_iters, cfg)
        rt = geo_residual(phis[l], rs[l], l, cfg)
        if l == n - 1 and cfg.t_flag:
            # projected 4 ways (always all 4, even when fewer copies are
            # used on the way up)
            r_tel = [quad_restrict(rt, q) for q in (1, 2, 3, 4)]
        else:
            rs[l + 1] = quad_restrict(rt, cfg.quad)
            phis[l + 1] = torch.zeros_like(phis[l + 1])
    if cfg.t_flag and n > 0:
        zc = torch.zeros_like(phis[n])   # phi_tel reset every cycle
        if cfg.combine == "divide":
            for i in range(cfg.n_copies):
                pt = geo_smooth(zc, r_tel[i], n, cfg.num_iters, cfg)
                phis[n - 1] = phis[n - 1] + quad_prolong(pt, i + 1)
            # reference quirk: the division hits the ENTIRE fine field
            phis[n - 1] = phis[n - 1] / cfg.n_copies
        else:   # 'single'
            acc = torch.zeros_like(phis[n])
            for i in range(cfg.n_single):
                pt = geo_smooth(zc, r_tel[i], n, cfg.num_iters, cfg)
                acc = acc + pt / cfg.n_single
            phis[n - 1] = phis[n - 1] + quad_prolong(acc, cfg.quad)
    elif n > 0:
        phis[n] = geo_smooth(phis[n], rs[n], n, cfg.num_iters, cfg)
        phis[n - 1] = phis[n - 1] + quad_prolong(phis[n], cfg.quad)
        phis[n] = torch.zeros_like(phis[n])
    for l in range(n - 1, -1, -1):
        phis[l] = geo_smooth(phis[l], rs[l], l, cfg.num_iters, cfg)
        if l > 0:
            phis[l - 1] = phis[l - 1] + quad_prolong(phis[l], cfg.quad)
            phis[l] = torch.zeros_like(phis[l])
    return tuple(phis)


def geo2_source(cfg: Geo2Config, device=None):
    """Center point source r[L/2, L/2] = scale[0] (:263)."""
    b = torch.zeros((cfg.L, cfg.L), dtype=cfg.rdtype, device=device)
    b[cfg.L // 2, cfg.L // 2] = cfg.scales[0]
    return b


def geo_source(cfg: GeoConfig, device=None):
    """Reference sources (2D_laplace_Mgrid.cpp:163)."""
    b = torch.zeros((cfg.L, cfg.L), dtype=cfg.rdtype, device=device)
    for (x, y), v in (((0, 0), 1.0), ((1, 0), 2.0), ((2, 2), 5.0),
                      ((3, 3), 7.5)):
        b[x, y] = v
    return b


def _stop(resmag: float, cfg: GeoConfig) -> bool:
    return (resmag < cfg.res_threshold or resmag > 1e6
            or not math.isfinite(resmag))


def _chunked(vcycle, b, cfg: GeoConfig, max_iters: Optional[int],
             chunk: int):
    """`chunk` cycles from zero between host checks of sum|r|; returns
    (phi, iters, resmag, history), history[k] the sum|r| after chunk
    k + 1."""
    max_iters = max_iters or cfg.max_iters
    phis = tuple(torch.zeros((s, s), dtype=cfg.rdtype, device=b.device)
                 for s in cfg.sizes)
    it, hist, resmag = 0, [], float("inf")
    while it < max_iters:
        for _ in range(chunk):
            phis = vcycle(phis, b, cfg)
        it += chunk
        resmag = float(geo_residue_l1(phis[0], b, cfg))
        hist.append(resmag)
        if _stop(resmag, cfg):
            break
    return phis[0], it, resmag, np.asarray(hist)


def geo_solve(b, cfg: GeoConfig, max_iters: Optional[int] = None,
              chunk: int = 5):
    """Gen-1 solve; returns (phi, iters, resmag, history)."""
    return _chunked(geo_vcycle, b, cfg, max_iters, chunk)


def geo2_solve(b, cfg: Geo2Config, max_iters: Optional[int] = None,
               chunk: int = 5):
    """Gen-2 solve (:271-329); returns (phi, iters, resmag, history)."""
    return _chunked(geo2_vcycle, b, cfg, max_iters, chunk)


def geo_solve_ir(b, cfg: GeoConfig, max_iters: Optional[int] = None,
                 chunk: int = 2, inner_cycles: int = 1):
    """Mixed-precision gen-1 solve: float32 V-cycles as the error solver
    inside a float64 defect-correction outer loop (one float64 residual and
    axpy at level 0 per outer step), which reaches float64-level sum|r|
    with the sweeps in float32. Returns (phi [float64], iters, resmag,
    history); iters counts chunk * inner_cycles a host check."""
    max_iters = max_iters or cfg.max_iters
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    b64 = b.to(torch.float64)
    phi = torch.zeros((cfg.L, cfg.L), dtype=torch.float64, device=b.device)
    it, hist, resmag = 0, [], float("inf")
    while it < max_iters:
        for _ in range(chunk):
            r32 = geo_residual(phi, b64, 0, cfg).to(torch.float32)
            e_phis = tuple(torch.zeros((s, s), dtype=torch.float32,
                                       device=b.device) for s in cfg.sizes)
            for _ in range(inner_cycles):
                e_phis = geo_vcycle(e_phis, r32, cfg32)
            phi = phi + e_phis[0].to(torch.float64)
        it += chunk * inner_cycles
        resmag = float(geo_residue_l1(phi, b64, cfg))
        hist.append(resmag)
        if _stop(resmag, cfg):
            break
    return phi, it, resmag, np.asarray(hist)
