"""Multigrid cycles: telescoping V-cycle and the non-telescoping (NTL)
cycle with minimal-residual recombination of quadrant copies
(counterpart of tpu_multigrid/solver/cycles.py; reference f_MG_simple /
f_MG_ntl, modules_main.h:255-280, 386-439).

Sawtooth V: relax `num_iters` sweeps at each level on the way down (then
restrict the residual) and again on the way up (then prolong and add the
correction). `gamma_cycle` generalizes it to the W-cycle; `fmg_init` is
the full-multigrid initial guess.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import MGConfig
from ..ops import cuda_stencil, gauge_stencil
from ..ops.stencil import apply_D, residual, _sumsq
from ..ops.smoothers import KERNEL_KINDS, smooth
from ..ops.transfer import restrict, prolong
from .hierarchy import Hierarchy


def links_active(cfg: MGConfig, gauge, lvl: int) -> bool:
    """Whether the level-0 links-only (spin-projected) path applies: gauge
    links present, wilson stencil, and cfg.links allows ('auto' restricts
    it to complex64, as in the JAX package)."""
    if gauge is None or lvl != 0 or cfg.stencil != "wilson":
        return False
    if cfg.links == "off":
        return False
    if cfg.links == "on":
        return True
    return cfg.dtype == "complex64"


def _tiled0(phi) -> bool:
    """Whether level 0's links kernels are the x-tiled ones (u_mode)."""
    return cuda_stencil.u_mode(phi.shape[-1], phi.dtype) == "tiled"


def _relax(lev, phi, r, cfg: MGConfig, lvl: int = 0, gauge=None):
    """num_iters sweeps at one level: the links smoother at a links-active
    level 0 for the kinds it has (jacobi, rbgs), else `smooth` on the
    level's dense stencil (gs_lex there runs its plain sweeps), as the
    JAX package's _relax dispatches."""
    if links_active(cfg, gauge, lvl) and cfg.smoother in KERNEL_KINDS:
        if cfg.pallas == "off":
            return gauge_stencil.smooth_u(cfg.stencil, gauge, cfg.m, phi, r,
                                          cfg.num_iters, cfg.smoother,
                                          cfg.omega)
        fn = (cuda_stencil.wilson_u_smooth_tiled if _tiled0(phi)
              else cuda_stencil.wilson_u_smooth)
        return fn(gauge, cfg.m, phi, r, cfg.num_iters, cfg.smoother,
                  cfg.omega)
    return smooth(lev.D, lev.D0inv, phi, r, cfg.num_iters, cfg.smoother,
                  cfg.omega, pallas=cfg.pallas)


def _residual0(lev, phi, r, cfg: MGConfig, lvl: int = 0, gauge=None):
    """Level residual with the links-only path at level 0."""
    if links_active(cfg, gauge, lvl):
        if cfg.pallas == "off":
            return gauge_stencil.residual_u(cfg.stencil, gauge, cfg.m, phi, r)
        fn = (cuda_stencil.wilson_u_residual_tiled if _tiled0(phi)
              else cuda_stencil.wilson_u_residual)
        return fn(gauge, cfg.m, phi, r)
    return residual(lev.D, phi, r)


def residual_norm_ratio0(hier: Hierarchy, phi, b, cfg: MGConfig):
    """||b - D phi|| / ||b|| at level 0, via the links-only residual when
    active (reference f_get_residue_mag, level.h:79-98)."""
    res = _residual0(hier.levels[0], phi, b, cfg, 0, hier.gauge)
    return (torch.sqrt(_sumsq(res)) / torch.sqrt(_sumsq(b))).to(b.real.dtype)


def v_cycle(hier: Hierarchy, phis, b: torch.Tensor, cfg: MGConfig):
    """One telescoping V-cycle (reference f_MG_simple). phis[0] is the
    running fine solution; coarse entries are error corrections."""
    L = hier.levels
    g = hier.gauge
    n = cfg.nlevels
    phis = list(phis)
    rs = [b] + [None] * n
    if n == 0:
        phis[0] = _relax(L[0], phis[0], b, cfg, 0, g)
        return tuple(phis)

    bx, by = cfg.block_x, cfg.block_y
    for l in range(n):
        phis[l] = _relax(L[l], phis[l], rs[l], cfg, l, g)
        res = _residual0(L[l], phis[l], rs[l], cfg, l, g)
        rs[l + 1] = restrict(L[l].phi_null, res, cfg.quad, bx, by)
        phis[l + 1] = torch.zeros_like(phis[l + 1])

    for l in range(n, -1, -1):
        phis[l] = _relax(L[l], phis[l], rs[l], cfg, l, g)
        if l > 0:
            corr = prolong(L[l - 1].phi_null, phis[l], cfg.quad, bx, by)
            phis[l - 1] = phis[l - 1] + corr
            phis[l] = torch.zeros_like(phis[l])
    return tuple(phis)


def gamma_cycle(hier: Hierarchy, phis, b: torch.Tensor, cfg: MGConfig):
    """Recursive gamma-cycle: gamma=1 is the sawtooth V-cycle's step
    sequence; gamma=2 the W-cycle (each coarse problem approximately
    solved by two child cycles; the coarsest once)."""
    L = hier.levels
    g = hier.gauge
    n = cfg.nlevels
    bx, by = cfg.block_x, cfg.block_y
    phis = list(phis)
    gamma = cfg.cycle_gamma

    def at(l, rhs):
        phis[l] = _relax(L[l], phis[l], rhs, cfg, l, g)
        if l == n:
            return
        res = _residual0(L[l], phis[l], rhs, cfg, l, g)
        rc = restrict(L[l].phi_null, res, cfg.quad, bx, by)
        phis[l + 1] = torch.zeros_like(phis[l + 1])
        for _ in range(gamma if l + 1 < n else 1):
            at(l + 1, rc)
        corr = prolong(L[l].phi_null, phis[l + 1], cfg.quad, bx, by)
        phis[l] = phis[l] + corr
        phis[l + 1] = torch.zeros_like(phis[l + 1])
        phis[l] = _relax(L[l], phis[l], rhs, cfg, l, g)

    if n == 0:
        phis[0] = _relax(L[0], phis[0], b, cfg, 0, g)
    else:
        at(0, b)
    return tuple(phis)


def min_res_weights(D_f, r_f, xs: torch.Tensor, cfg: MGConfig):
    """Minimal-residual recombination weights for the NTL copies.

    xs: [n_copies, nf, S, S] prolonged corrections. A_pq = <x_p, D x_q>;
    the source is <x_p, r> (laplace) or <r, D x_p> (wilson) — the
    reference's deliberate asymmetry (modules_main.h:336-340 vs :358-366),
    selectable via cfg.minres_src. Solves the n_copies x n_copies system.
    """
    Dx = apply_D(D_f, xs)
    A = torch.einsum("pnxy,qnxy->pq", torch.conj(xs), Dx)
    mode = cfg.minres_src
    if mode == "auto":
        mode = "r_dot_dx" if cfg.stencil == "wilson" else "x_dot_r"
    if mode == "x_dot_r":
        src = torch.einsum("pnxy,nxy->p", torch.conj(xs), r_f)
    elif mode == "r_dot_dx":
        src = torch.einsum("nxy,pnxy->p", torch.conj(r_f), Dx)
    else:
        raise ValueError(f"bad minres_src {mode!r}")
    return torch.linalg.solve(A, src)


def ntl_cycle(hier: Hierarchy, phis, b: torch.Tensor, cfg: MGConfig):
    """One non-telescoping cycle (reference f_MG_ntl,
    modules_main.h:386-439): at the coarsest transition the residual is
    restricted 4 ways (one per blocking quadrant), the coarse copies are
    smoothed as one batch, and their prolonged corrections recombined.

    Returns (phis, a_weights).
    """
    L = hier.levels
    g = hier.gauge
    ntl = hier.ntl
    n = cfg.nlevels
    phis = list(phis)
    rs = [b] + [None] * n
    bx, by = cfg.block_x, cfg.block_y
    nq = cfg.n_copies

    for l in range(n - 1):
        phis[l] = _relax(L[l], phis[l], rs[l], cfg, l, g)
        res = _residual0(L[l], phis[l], rs[l], cfg, l, g)
        rs[l + 1] = restrict(L[l].phi_null, res, cfg.quad, bx, by)
        phis[l + 1] = torch.zeros_like(phis[l + 1])

    l = n - 1
    phis[l] = _relax(L[l], phis[l], rs[l], cfg, l, g)
    res = _residual0(L[l], phis[l], rs[l], cfg, l, g)
    r_q = torch.stack([restrict(ntl.phi_null[q], res, q + 1, bx, by)
                       for q in range(nq)])

    phi_q0 = torch.zeros((nq,) + tuple(phis[n].shape), dtype=phis[n].dtype,
                         device=phis[n].device)
    phi_q = smooth(ntl.D[:nq], ntl.D0inv[:nq], phi_q0, r_q, cfg.num_iters,
                   cfg.smoother, cfg.omega, pallas=cfg.pallas)

    combine = cfg.ntl_combine
    if combine == "auto":
        combine = "minres" if cfg.min_res else "avg_prolong"
    if combine == "avg_coarse":
        a = torch.full((nq,), 1.0 / nq, dtype=phi_q.dtype, device=phi_q.device)
        corr = prolong(ntl.phi_null[cfg.quad - 1], phi_q.mean(dim=0),
                       cfg.quad, bx, by)
        phis[l] = phis[l] + corr
    else:
        xs = torch.stack([prolong(ntl.phi_null[q], phi_q[q], q + 1, bx, by)
                          for q in range(nq)])
        if combine == "minres":
            a = min_res_weights(L[l].D, rs[l], xs, cfg)
        else:
            a = torch.full((nq,), 1.0 / nq, dtype=xs.dtype, device=xs.device)
        phis[l] = phis[l] + torch.einsum("q,qnxy->nxy", a, xs).contiguous()

    for l in range(n - 1, -1, -1):
        phis[l] = _relax(L[l], phis[l], rs[l], cfg, l, g)
        if l > 0:
            corr = prolong(L[l - 1].phi_null, phis[l], cfg.quad, bx, by)
            phis[l - 1] = phis[l - 1] + corr
            phis[l] = torch.zeros_like(phis[l])
    return tuple(phis), a


def fmg_init(hier: Hierarchy, b: torch.Tensor, cfg: MGConfig,
             n_vcycles: int = 1, coarsest_iters: Optional[int] = None):
    """Full-multigrid (nested-iteration) initial guess, beyond the
    reference: restrict b down the hierarchy (the plain restriction P b,
    consistent with the Galerkin D_c = P D P^dagger), relax the coarsest
    problem `coarsest_iters` (default 4 num_iters) sweeps, then prolong
    upward, refining with `n_vcycles` V-cycles per level. Returns a
    per-level phis tuple whose entry 0 is the initial guess."""
    L = hier.levels
    n = cfg.nlevels
    bx, by = cfg.block_x, cfg.block_y
    if n == 0:
        return (_relax(L[0], torch.zeros_like(b), b, cfg, 0, hier.gauge),)

    def zeros_below(l):
        return tuple(torch.zeros((lev.D.shape[1], lev.D.shape[-1],
                                  lev.D.shape[-1]), dtype=b.dtype,
                                 device=b.device) for lev in L[l + 1:])

    bs = [b]
    for l in range(n):
        bs.append(restrict(L[l].phi_null, bs[l], cfg.quad, bx, by))
    phi = smooth(L[n].D, L[n].D0inv, torch.zeros_like(bs[n]), bs[n],
                 coarsest_iters or 4 * cfg.num_iters, cfg.smoother,
                 cfg.omega, pallas=cfg.pallas)
    for l in range(n - 1, -1, -1):
        phi = prolong(L[l].phi_null, phi, cfg.quad, bx, by)
        sub_h = Hierarchy(levels=L[l:], ntl=None,
                          gauge=hier.gauge if l == 0 else None)
        sub_c = cfg.replace(
            nlevels=n - l, ntl=False,
            cheby_lmax=(cfg.cheby_lmax[l:] if cfg.cheby_lmax else None))
        phis = (phi,) + zeros_below(l)
        for _ in range(n_vcycles):
            phis = v_cycle(sub_h, phis, bs[l], sub_c)
        phi = phis[0]
    return (phi,) + zeros_below(0)


def cycle(hier: Hierarchy, phis, b: torch.Tensor, cfg: MGConfig):
    """Dispatch: NTL if configured, else the V-cycle (or the W-cycle for
    cycle_gamma > 1). Returns (phis, a)."""
    if cfg.ntl and cfg.nlevels > 0:
        return ntl_cycle(hier, phis, b, cfg)
    if cfg.cycle_gamma > 1:
        phis = gamma_cycle(hier, phis, b, cfg)
    else:
        phis = v_cycle(hier, phis, b, cfg)
    return phis, torch.zeros((cfg.n_copies,), dtype=b.dtype, device=b.device)
