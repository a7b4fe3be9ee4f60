"""Gauge-covariant 5-point stencil application (SpMV) and residuals
(counterpart of tpu_multigrid/ops/stencil.py; reference Level::f_apply_D /
f_residue, level.h:61-77, 251-265).

Fields are ``v[..., n, L, L]``; stencils ``D[..., 5, n, n, L, L]``. The
leading ``...`` is an optional batch axis (the NTL coarse copies, the
near-null candidates); a stencil without it is shared by the batch.
"""
from __future__ import annotations

import torch

from ..config import SAME, XP, XM, YP, YM

# Lattice axes: x = -2, y = -1. Site (x+1, y) of field v is roll(v, -1, -2).
_SHIFTS = {XP: (-1, -2), XM: (1, -2), YP: (-1, -1), YM: (1, -1)}


def shift(v: torch.Tensor, d: int) -> torch.Tensor:
    """Return the field of neighbor values in direction d (d in {1..4})."""
    s, ax = _SHIFTS[d]
    return torch.roll(v, s, dims=ax)


def _direction(D: torch.Tensor, d: int) -> torch.Tensor:
    """Block plane D_d[..., n, n, L, L] of a (possibly batched) stencil."""
    return D[..., d, :, :, :, :]


def _site_matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Per-site (n x n) @ (n): M[..., n,n,L,L] v[..., n,L,L] -> [..., n,L,L]."""
    return (M * v.unsqueeze(-4)).sum(dim=-3)


def apply_hop(D: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Off-diagonal part: sum_{mu != 0} D_mu(x) v(x + mu)."""
    out = _site_matvec(_direction(D, XP), shift(v, XP))
    out = out + _site_matvec(_direction(D, XM), shift(v, XM))
    out = out + _site_matvec(_direction(D, YP), shift(v, YP))
    out = out + _site_matvec(_direction(D, YM), shift(v, YM))
    return out


def apply_D(D: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Full SpMV: (D v)(x) = D0(x) v(x) + sum_mu D_mu(x) v(x+mu)."""
    return _site_matvec(_direction(D, SAME), v) + apply_hop(D, v)


def apply_D_unrolled(D: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """apply_D with the dof contractions unrolled into elementwise
    multiply-adds over [L, L] planes (the JAX package's variant for XLA's
    fusion; identical math). `profiling` times it as a plain row."""
    n = v.shape[-3]
    vs = (v, shift(v, XP), shift(v, XM), shift(v, YP), shift(v, YM))
    rows = []
    for i in range(n):
        acc = None
        for d in range(5):
            for j in range(n):
                t = D[..., d, i, j, :, :] * vs[d][..., j, :, :]
                acc = t if acc is None else acc + t
        rows.append(acc)
    return torch.stack(rows, dim=-3)


def residual(D: torch.Tensor, phi: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """r - D phi (reference Level::f_residue, level.h:61-77)."""
    return r - apply_D(D, phi)


def _sumsq(x: torch.Tensor) -> torch.Tensor:
    """Sum of |x|^2, always accumulated in float64 (the JAX package does so
    whenever x64 is on), so the convergence check stays meaningful in
    complex64."""
    return torch.sum(x.abs() ** 2, dtype=torch.float64)


def field_norm(x: torch.Tensor) -> torch.Tensor:
    """||x|| over the field axes [n, L, L], one per batch entry, summed in
    float64 (_sumsq)."""
    if x.dim() == 3:
        return torch.sqrt(_sumsq(x))
    return torch.sqrt(torch.sum(x.abs() ** 2, dim=(-3, -2, -1),
                                dtype=torch.float64))


def norm_ratio(res: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """||res|| / ||r|| per batch entry, in r's real dtype."""
    return (field_norm(res) / field_norm(r)).to(r.real.dtype)


def residual_norm_ratio(D, phi, r) -> torch.Tensor:
    """||r - D phi|| / ||r|| (reference f_get_residue_mag, level.h:79-98)."""
    return norm_ratio(residual(D, phi, r), r)


def adjoint_stencil(D: torch.Tensor) -> torch.Tensor:
    """Stencil of the adjoint: apply_D(adjoint_stencil(D), v) == D^H v.

    (D^H v)(x) = sum_y D(y, x)^H v(y): the same-site block conjugate-
    transposes in place; the +mu block of D^H at x is the -mu block stored
    at x+mu, conjugate-transposed (and vice versa). Valid for any 5-point
    block stencil, with an optional batch axis."""
    def ct(M):
        return torch.conj(M.transpose(-4, -3))

    return torch.stack([
        ct(_direction(D, SAME)),
        ct(shift(_direction(D, XM), XP)),
        ct(shift(_direction(D, XP), XM)),
        ct(shift(_direction(D, YM), YP)),
        ct(shift(_direction(D, YP), YM)),
    ], dim=-5).resolve_conj().contiguous()


def site_inverse(M: torch.Tensor) -> torch.Tensor:
    """Per-site inverse of the diagonal block D0: [..., n,n,L,L] -> same."""
    n = M.shape[-4]
    if n == 1:
        return 1.0 / M
    if n == 2:
        # closed form, as in the JAX package
        a, b = M[..., 0, 0, :, :], M[..., 0, 1, :, :]
        c, d = M[..., 1, 0, :, :], M[..., 1, 1, :, :]
        det = a * d - b * c
        inv = torch.stack([torch.stack([d, -b], dim=-3),
                           torch.stack([-c, a], dim=-3)], dim=-4)
        return inv / det[..., None, None, :, :]
    # inv_ex, unchecked: a singular block gives non-finite entries, as
    # jnp.linalg.inv does
    inv = torch.linalg.inv_ex(torch.movedim(M, (-4, -3), (-2, -1))).inverse
    return torch.movedim(inv, (-2, -1), (-4, -3)).contiguous()


def nnz_per_site(n: int) -> int:
    """Nonzeros of the 5-point block stencil per lattice site."""
    return 5 * n * n
