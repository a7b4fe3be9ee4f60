"""Multigrid cycles: telescoping V-cycle and the non-telescoping (NTL)
cycle with minimal-residual recombination of quadrant copies
(counterpart of tpu_multigrid/solver/cycles.py; reference f_MG_simple /
f_MG_ntl, modules_main.h:255-280, 386-439).

Sawtooth V: relax `num_iters` sweeps at each level on the way down (then
restrict the residual) and again on the way up (then prolong and add the
correction). `gamma_cycle` generalizes it to the W-cycle; `fmg_init` is
the full-multigrid initial guess.

The V-cycle, the NTL cycle, `min_res_weights` and `residual_norm_ratio0`
take a leading batch axis on `phis` and `b` ([B, n, S, S] at every level),
which the JAX package gets by vmapping them: a batch of right-hand sides
on one hierarchy (solver.driver.solve_batched; the level-0 links kernels
then take the batch with the links shared) or a batch of hierarchies whose
every tensor carries the batch axis too (solver.ensemble). Each kernel
call covers the whole batch in one launch.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config import MGConfig
from ..ops import dispatch
from ..ops.stencil import norm_ratio
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


def _relax(lev, phi, r, cfg: MGConfig, lvl: int = 0, gauge=None):
    """num_iters sweeps at one level: the links form at a links-active level
    0 for the sweeps it has, else the dense stencil, as JAX's _relax."""
    if links_active(cfg, gauge, lvl) and cfg.smoother in ("jacobi", "rbgs"):
        return dispatch.links_smooth(gauge, cfg.m, phi, r, cfg.num_iters,
                                     cfg.smoother, cfg.omega, cfg.pallas)
    return dispatch.smooth(
        lev.D, lev.D0inv, phi, r, cfg.num_iters, cfg.smoother, cfg.omega,
        cfg.pallas, cfg.cheby_intervals[lvl]
        if cfg.smoother == "chebyshev" else None)


def _residual0(lev, phi, r, cfg: MGConfig, lvl: int = 0, gauge=None):
    """Level residual with the links-only form at a links-active level 0."""
    if links_active(cfg, gauge, lvl):
        return dispatch.links_residual(gauge, cfg.m, phi, r, cfg.pallas)
    return dispatch.residual(lev.D, phi, r, cfg.pallas)


def _restricted_residual(lev, phi, r, cfg: MGConfig, lvl: int = 0,
                         gauge=None):
    """restrict(lev.phi_null, the level residual, cfg.quad)."""
    bx, by = cfg.block_x, cfg.block_y
    if links_active(cfg, gauge, lvl):
        return dispatch.links_residual_restrict(
            gauge, cfg.m, phi, r, lev.phi_null, cfg.quad, bx, by, cfg.pallas)
    return dispatch.restrict(lev.phi_null, _residual0(lev, phi, r, cfg),
                             cfg.quad, bx, by, cfg.pallas)


def residual_norm_ratio0(hier: Hierarchy, phi, b, cfg: MGConfig):
    """||b - D phi|| / ||b|| at level 0, via the links-only form when
    active (reference f_get_residue_mag, level.h:79-98); one per batch
    entry for a batch of fields."""
    g = hier.gauge
    if links_active(cfg, g, 0):
        return dispatch.links_residual_norm(g, cfg.m, phi, b, cfg.pallas)
    return norm_ratio(_residual0(hier.levels[0], phi, b, cfg, 0, g), b)


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
        rs[l + 1] = _restricted_residual(L[l], phis[l], rs[l], cfg, l, g)
        phis[l + 1] = torch.zeros_like(phis[l + 1])

    for l in range(n, -1, -1):
        phis[l] = _relax(L[l], phis[l], rs[l], cfg, l, g)
        if l > 0:
            phis[l - 1] = dispatch.prolong(L[l - 1].phi_null, phis[l],
                                           cfg.quad, bx, by, phis[l - 1],
                                           cfg.pallas)
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
        rc = _restricted_residual(L[l], phis[l], rhs, cfg, l, g)
        phis[l + 1] = torch.zeros_like(phis[l + 1])
        for _ in range(gamma if l + 1 < n else 1):
            at(l + 1, rc)
        phis[l] = dispatch.prolong(L[l].phi_null, phis[l + 1], cfg.quad, bx,
                                   by, phis[l], cfg.pallas)
        phis[l + 1] = torch.zeros_like(phis[l + 1])
        phis[l] = _relax(L[l], phis[l], rhs, cfg, l, g)

    if n == 0:
        phis[0] = _relax(L[0], phis[0], b, cfg, 0, g)
    else:
        at(0, b)
    return tuple(phis)


def min_res_weights(D_f, r_f, xs: torch.Tensor, cfg: MGConfig):
    """Minimal-residual recombination weights for the NTL copies.

    xs: [B?, n_copies, nf, S, S] prolonged corrections, r_f [B?, nf, S, S],
    D_f [B?, 5, nf, nf, S, S] (shared or batched). A_pq = <x_p, D x_q>;
    the source is <x_p, r> (laplace) or <r, D x_p> (wilson) — the
    reference's deliberate asymmetry (modules_main.h:336-340 vs :358-366),
    selectable via cfg.minres_src. Solves the n_copies x n_copies system,
    one per batch entry in one call. D x is dispatch.apply_D on the copies
    flattened to one batch axis, each copy of D_f shared by the n_copies
    entries of its field.
    """
    Dx = dispatch.apply_D(D_f, xs.reshape(-1, *xs.shape[-3:]),
                          cfg.pallas).reshape(xs.shape)
    if xs.dim() == 4:
        A = torch.einsum("pnxy,qnxy->pq", torch.conj(xs), Dx)
    else:
        # one product a lattice row, then their sum: as one long product a
        # batch entry it runs on a single block of the card (PERF.md §6)
        A = torch.einsum("...pnxy,...qnxy->...xpq", torch.conj(xs),
                         Dx).sum(dim=-3)
    mode = cfg.minres_src
    if mode == "auto":
        mode = "r_dot_dx" if cfg.stencil == "wilson" else "x_dot_r"
    if mode == "x_dot_r":
        src = torch.einsum("...pnxy,...nxy->...p", torch.conj(xs), r_f)
    elif mode == "r_dot_dx":
        src = torch.einsum("...nxy,...pnxy->...p", torch.conj(r_f), Dx)
    else:
        raise ValueError(f"bad minres_src {mode!r}")
    # solve_ex, unchecked: a singular system gives non-finite weights for
    # its entry alone, as jnp.linalg.solve does, and the card makes no host
    # sync for an error check
    return torch.linalg.solve_ex(A, src).result


def _copy_operators(ntl, nq: int, lead):
    """The first nq NTL copies' D and D0inv, flattened to one batch axis of
    [prod(lead) nq] for the smoother kernels (whose operands have one batch
    stride): as they are where the copies carry the batch axis (a batch of
    hierarchies), else expanded over the fields' batch `lead`, a copy each
    call."""
    D = ntl.D[..., :nq, :, :, :, :, :]
    Dinv = ntl.D0inv[..., :nq, :, :, :, :]
    if D.dim() == 6 and lead:
        D, Dinv = D.expand(*lead, *D.shape), Dinv.expand(*lead, *Dinv.shape)
    return D.reshape(-1, *D.shape[-5:]), Dinv.reshape(-1, *Dinv.shape[-4:])


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
        rs[l + 1] = _restricted_residual(L[l], phis[l], rs[l], cfg, l, g)
        phis[l + 1] = torch.zeros_like(phis[l + 1])

    l = n - 1
    phis[l] = _relax(L[l], phis[l], rs[l], cfg, l, g)
    res = _residual0(L[l], phis[l], rs[l], cfg, l, g)
    lead = tuple(b.shape[:-3])

    # the copies' near-null rows [B?, nq, nc, nf, S, S], copy q at quadrant
    # q + 1; their restrictions [B?, nq, nc, Sc, Sc] (one launch on the
    # card), smoothed as one batch
    null_q = ntl.phi_null[..., :nq, :, :, :, :]
    r_q = dispatch.restrict(null_q, res, None, bx, by, cfg.pallas)
    D_q, Dinv_q = _copy_operators(ntl, nq, lead)
    cheby_n = (cfg.cheby_intervals[n] if cfg.smoother == "chebyshev"
               else None)
    flat = (-1,) + tuple(r_q.shape[-3:])
    phi_q = dispatch.smooth(D_q, Dinv_q, torch.zeros_like(r_q).reshape(flat),
                            r_q.reshape(flat), cfg.num_iters, cfg.smoother,
                            cfg.omega, cfg.pallas, cheby_n).reshape(r_q.shape)

    combine = cfg.ntl_combine
    if combine == "auto":
        combine = "minres" if cfg.min_res else "avg_prolong"
    if combine == "avg_coarse":
        a = torch.full(lead + (nq,), 1.0 / nq, dtype=phi_q.dtype,
                       device=phi_q.device)
        phis[l] = dispatch.prolong(ntl.phi_null[..., cfg.quad - 1, :, :, :, :],
                                   phi_q.mean(dim=-4), cfg.quad, bx, by,
                                   phis[l], cfg.pallas)
    else:
        xs = dispatch.prolong(null_q, phi_q, None, bx, by, pallas=cfg.pallas)
        if combine == "minres":
            a = min_res_weights(L[l].D, rs[l], xs, cfg)
        else:
            a = torch.full(lead + (nq,), 1.0 / nq, dtype=xs.dtype,
                           device=xs.device)
        phis[l] = phis[l] + torch.einsum("...q,...qnxy->...nxy", a,
                                         xs).contiguous()

    for l in range(n - 1, -1, -1):
        phis[l] = _relax(L[l], phis[l], rs[l], cfg, l, g)
        if l > 0:
            phis[l - 1] = dispatch.prolong(L[l - 1].phi_null, phis[l],
                                           cfg.quad, bx, by, phis[l - 1],
                                           cfg.pallas)
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
        bs.append(dispatch.restrict(L[l].phi_null, bs[l], cfg.quad, bx, by,
                                    cfg.pallas))
    cheby_n = (cfg.cheby_intervals[n] if cfg.smoother == "chebyshev"
               else None)
    phi = dispatch.smooth(L[n].D, L[n].D0inv, torch.zeros_like(bs[n]), bs[n],
                          coarsest_iters or 4 * cfg.num_iters, cfg.smoother,
                          cfg.omega, cfg.pallas, cheby_n)
    for l in range(n - 1, -1, -1):
        phi = dispatch.prolong(L[l].phi_null, phi, cfg.quad, bx, by,
                               pallas=cfg.pallas)
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
    return phis, torch.zeros(tuple(b.shape[:-3]) + (cfg.n_copies,),
                             dtype=b.dtype, device=b.device)
