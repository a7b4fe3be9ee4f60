"""Generation-1 1D capability: plain Jacobi / Gauss-Seidel solvers and the
1D geometric multigrid V-cycle (counterpart of
tpu_multigrid/solver/one_d.py; the reference's code/1_laplace_scalar/
1D_laplace_solvers.cpp and 1D_laplace_Mgrid.cpp).

Operator: (A phi)(x) = (1/a^2) [ phi(x+1) + phi(x-1) - (2 + m^2 a^2) phi(x) ]
on the periodic 1D lattice; scale[l] = 1/(2 + m^2 a_l^2), a_l = 2 a_{l-1}.
Restriction 0.5 (r[2x] + r[2x+1]); interpolation constant injection;
smoother phi <- scale (phi(x+1) + phi(x-1) - r a^2). float64 throughout.

The in-place 1D Gauss-Seidel is a strictly sequential chain (no
wavefront), so it runs site by site on the host in float64, the order and
arithmetic of the reference's loop; the rest is plain torch on the
fields' device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class Geo1DConfig:
    L: int = 512
    m: float = 0.005
    nlevels: int = 6
    num_iters: int = 80
    max_iters: int = 10000
    res_threshold: float = 1.0e-15
    smoother: str = "rbgs"   # 'jacobi' | 'rbgs' | 'gs_lex'

    @property
    def sizes(self):
        return tuple(self.L // (2 ** l) for l in range(self.nlevels + 1))

    @property
    def spacings(self):
        return tuple(float(2 ** l) for l in range(self.nlevels + 1))

    @property
    def scales(self):
        return tuple(1.0 / (2.0 + self.m ** 2 * a * a)
                     for a in self.spacings)


def _ngb(phi):
    return torch.roll(phi, -1) + torch.roll(phi, 1)


def residual_1d(phi, b, level, cfg):
    a = cfg.spacings[level]
    return b - (1.0 / (a * a)) * (_ngb(phi) - phi / cfg.scales[level])


def _gs_sweeps(phi, rhs, n_sweeps: int, update):
    """n_sweeps in-place lexicographic sweeps x = 0 .. L-1, phi[x] <-
    update(phi[x+1], phi[x-1], rhs[x]) (periodic), on the host."""
    p, r = phi.tolist(), rhs.tolist()
    L = len(p)
    for _ in range(n_sweeps):
        for x in range(L):
            p[x] = update(p[(x + 1) % L], p[(x - 1) % L], r[x])
    return torch.tensor(p, dtype=phi.dtype, device=phi.device)


def smooth_1d(phi, r, level, n_sweeps, cfg):
    a = cfg.spacings[level]
    s = cfg.scales[level]
    if cfg.smoother == "gs_lex":
        return _gs_sweeps(phi, r, n_sweeps,
                          lambda up, dn, rx: s * (up + dn - rx * a * a))
    par = (torch.arange(phi.shape[0], device=phi.device) % 2) == 0
    for _ in range(n_sweeps):
        if cfg.smoother == "jacobi":
            phi = s * (_ngb(phi) - r * a * a)
        else:  # red-black
            phi = torch.where(par, s * (_ngb(phi) - r * a * a), phi)
            phi = torch.where(~par, s * (_ngb(phi) - r * a * a), phi)
    return phi


def restrict_1d(res):
    L = res.shape[0]
    return 0.5 * res.reshape(L // 2, 2).sum(dim=1)


def prolong_1d(coarse):
    return torch.repeat_interleave(coarse, 2)


def vcycle_1d(phis, b, cfg):
    n = cfg.nlevels
    phis = list(phis)
    rs = [b] + [None] * n
    for l in range(n):
        phis[l] = smooth_1d(phis[l], rs[l], l, cfg.num_iters, cfg)
        rs[l + 1] = restrict_1d(residual_1d(phis[l], rs[l], l, cfg))
        phis[l + 1] = torch.zeros_like(phis[l + 1])
    for l in range(n - 1, -1, -1):
        phis[l] = smooth_1d(phis[l], rs[l], l, cfg.num_iters, cfg)
        if l > 0:
            phis[l - 1] = phis[l - 1] + prolong_1d(phis[l])
            phis[l] = torch.zeros_like(phis[l])
    return tuple(phis)


def solve_1d(b, cfg: Geo1DConfig, max_iters: Optional[int] = None,
             chunk: int = 10):
    """`chunk` V-cycles between host checks of sum|r|; returns (phi,
    iters, resmag)."""
    max_iters = max_iters or cfg.max_iters
    phis = tuple(torch.zeros((s,), dtype=torch.float64, device=b.device)
                 for s in cfg.sizes)
    it, resmag = 0, float("inf")
    while it < max_iters:
        for _ in range(chunk):
            phis = vcycle_1d(phis, b, cfg)
        it += chunk
        resmag = float(torch.sum(torch.abs(residual_1d(phis[0], b, 0, cfg))))
        if (resmag < cfg.res_threshold or resmag > 1e6
                or not math.isfinite(resmag)):
            break
    return phis[0], it, resmag


def jacobi_1d(b, m: float, num_iters: int, L: int):
    """Plain 1D Jacobi on the (2+m^2) diagonal operator
    (1D_laplace_solvers.cpp f_jacobi, :74-93; a=1, b with a minus sign)."""
    phi = torch.zeros((L,), dtype=torch.float64, device=b.device)
    for _ in range(num_iters):
        phi = (_ngb(phi) - b) / (2.0 + m * m)
    return phi


def gauss_seidel_1d(b, m: float, num_iters: int, L: int):
    """Plain in-place 1D Gauss-Seidel (f_gauss, :55-68)."""
    phi = torch.zeros((L,), dtype=torch.float64, device=b.device)
    return _gs_sweeps(phi, b, num_iters,
                      lambda up, dn, bx: (up + dn - bx) / (2 + m * m))
