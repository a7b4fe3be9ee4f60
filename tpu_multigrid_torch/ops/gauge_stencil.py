"""Spin-projected level-0 stencil: the links-only form of the reference's
closed-form level-0 operators (counterpart of
tpu_multigrid/ops/gauge_stencil.py; math in its module docstring).

Each wilson hop needs one half-spinor component:
  +x: a = v0 - v1,  -x: b = v0 + v1,  +y: c = v0 + i v1,  -y: d = v0 - i v1
so a sweep streams U[2, L, L] instead of the dense D[5, 2, 2, L, L].

These are the plain torch versions of the links kernels
(ops/cuda_stencil.py: links_update for smooth_u, links_residual for
residual_u, links_apply for apply_wilson_u, links_residual_norm for
residual_norm_ratio_u); identical math to models.operators.assemble +
ops.stencil.apply_D. Fields are [..., n, L, L] with any leading batch
axes; the links U [2, L, L] are shared by the batch.
"""
from __future__ import annotations

import torch

from .stencil import norm_ratio


def _xp(f):     # value at (x+1, y)
    return torch.roll(f, -1, dims=-2)


def _xm(f):
    return torch.roll(f, 1, dims=-2)


def _yp(f):
    return torch.roll(f, -1, dims=-1)


def _ym(f):
    return torch.roll(f, 1, dims=-1)


def wilson_hop_u(U: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """hop(v)(x) = +1/2 sum_mu [U_mu(x)(1-g_mu)v(x+mu) +
                               U_mu(x-mu)^*(1+g_mu)v(x-mu)]
    (the hop sign is PLUS, as in the reference's stored stencil)."""
    ux, uy = U[0], U[1]
    v0, v1 = v[..., 0, :, :], v[..., 1, :, :]
    ha = ux * _xp(v0 - v1)
    hb = torch.conj(_xm(ux)) * _xm(v0 + v1)
    hc = uy * _yp(v0 + 1j * v1)
    hd = torch.conj(_ym(uy)) * _ym(v0 - 1j * v1)
    out0 = 0.5 * (ha + hb + hc + hd)
    out1 = 0.5 * (-ha + hb - 1j * hc + 1j * hd)
    return torch.stack([out0, out1], dim=-3)


def apply_wilson_u(U: torch.Tensor, m: float, v: torch.Tensor) -> torch.Tensor:
    return (2.0 + m) * v + wilson_hop_u(U, v)


def laplace_hop_u(U: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Hopping part of the gauged Laplace (n=1): sum_mu U v(x+mu) + h.c."""
    w = v[..., 0, :, :]
    out = (U[0] * _xp(w) + torch.conj(_xm(U[0])) * _xm(w)
           + U[1] * _yp(w) + torch.conj(_ym(U[1])) * _ym(w))
    return out[..., None, :, :]


def apply_laplace_u(U: torch.Tensor, m: float, v: torch.Tensor) -> torch.Tensor:
    return -(4.0 + m) * v + laplace_hop_u(U, v)


def apply_u(stencil: str, U, m: float, v):
    return (apply_wilson_u if stencil == "wilson" else apply_laplace_u)(U, m, v)


def residual_u(stencil: str, U, m: float, phi, r):
    """r - D phi in the links-only representation."""
    return r - apply_u(stencil, U, m, phi)


def residual_norm_ratio_u(stencil: str, U, m: float, phi, r):
    """||r - D phi|| / ||r|| per batch entry, in r's real dtype: the links
    residual, then the two float64 norms (the level-0 convergence check)."""
    return norm_ratio(residual_u(stencil, U, m, phi, r), r)


def _hop(stencil: str):
    return wilson_hop_u if stencil == "wilson" else laplace_hop_u


def _diag(stencil: str, m: float) -> float:
    return (2.0 + m) if stencil == "wilson" else -(4.0 + m)


def parity_mask(L: int, dtype, device=None) -> torch.Tensor:
    """(x + y) % 2 over the [L, L] lattice: 0 = red, 1 = black."""
    x = torch.arange(L, device=device)[:, None]
    y = torch.arange(L, device=device)[None, :]
    return ((x + y) % 2).to(dtype)


def jacobi_sweep_u(stencil: str, U, m: float, phi, r, omega: float = 1.0):
    """phi <- -D0^{-1}(hop(phi) - r) with the scalar level-0 diagonal."""
    new = -(_hop(stencil)(U, phi) - r) / _diag(stencil, m)
    if omega == 1.0:
        return new
    return phi + omega * (new - phi)


def rbgs_sweep_u(stencil: str, U, m: float, phi, r, omega: float = 1.0):
    """Red-black GS sweep (two masked half-updates), links-only."""
    par = parity_mask(phi.shape[-1], phi.real.dtype, phi.device)
    hop = _hop(stencil)
    d = _diag(stencil, m)
    for mask in (1.0 - par, par):
        upd = -(hop(U, phi) - r) / d
        phi = phi + omega * mask[None] * (upd - phi)
    return phi


def smooth_u(stencil: str, U, m: float, phi, r, n_sweeps: int,
             kind: str = "rbgs", omega: float = 1.0):
    """n_sweeps links-only smoother sweeps."""
    fn = jacobi_sweep_u if kind == "jacobi" else rbgs_sweep_u
    for _ in range(n_sweeps):
        phi = fn(stencil, U, m, phi, r, omega)
    return phi
