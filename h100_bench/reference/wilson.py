"""The plain reference: the 2D Wilson-Dirac operator with U(1) links,
written from its definition (reference level.h:161-171), in plain
PyTorch, from the benchmark's own gauge phases. It imports nothing of
the program.

    (D x)(s) = (2 + m) x(s)
             + sum_mu [ 1/2 (1 - g_mu) U_mu(s) x(s + mu)
                      + 1/2 (1 + g_mu) conj(U_mu(s - mu)) x(s - mu) ]

with g_1 = [[0, 1], [1, 0]], g_2 = [[0, -i], [i, 0]], periodic in both
directions. Fields are x[..., 2, L, L] (spin, then the lattice's x and y
axes); phases are [..., 2, L, L] (direction, x, y), U_mu = exp(i phase).
"""
from __future__ import annotations

import torch

_G1 = ((0, 1), (1, 0))
_G2 = ((0, -1j), (1j, 0))


def _projector(g, sign: float, dtype, device):
    """1/2 (1 + sign g) as a [2, 2] tensor."""
    eye = ((1, 0), (0, 1))
    return torch.tensor([[0.5 * (eye[i][j] + sign * g[i][j])
                          for j in range(2)] for i in range(2)],
                        dtype=dtype, device=device)


def links(phases: torch.Tensor, dtype=torch.complex128) -> torch.Tensor:
    """U = exp(i phases), computed in float64, in `dtype`."""
    ph = phases.to(torch.float64)
    return torch.polar(torch.ones_like(ph), ph).to(dtype)


def apply(U: torch.Tensor, m: float, x: torch.Tensor) -> torch.Tensor:
    """D x for links U [..., 2, L, L] and fields x [..., 2, L, L] of one
    complex dtype (a batch axis on either broadcasts)."""
    dt, dev = x.dtype, x.device
    out = (2.0 + m) * x
    for mu, g in ((0, _G1), (1, _G2)):
        axis = -2 if mu == 0 else -1
        u = U[..., mu, :, :].unsqueeze(-3)
        fwd = u * torch.roll(x, -1, dims=axis)
        bwd = torch.conj(torch.roll(u, 1, dims=axis)) * torch.roll(
            x, 1, dims=axis)
        out = out + torch.einsum("ij,...jxy->...ixy",
                                 _projector(g, -1.0, dt, dev), fwd)
        out = out + torch.einsum("ij,...jxy->...ixy",
                                 _projector(g, 1.0, dt, dev), bwd)
    return out


def relres(phases: torch.Tensor, m: float, x: torch.Tensor,
           b: torch.Tensor) -> torch.Tensor:
    """||b - D x|| / ||b|| over each field's spin and sites, in
    complex128 (the fields are cast up; a lower precision stays in its
    values)."""
    U = links(phases)
    r = b.to(torch.complex128) - apply(U, m, x.to(torch.complex128))
    dims = (-3, -2, -1)
    num = torch.sqrt(torch.sum(r.abs() ** 2, dim=dims))
    den = torch.sqrt(torch.sum(b.to(torch.complex128).abs() ** 2, dim=dims))
    return num / den


def point_source(L: int, site, spin: int, value: float = 5.0,
                 dtype=torch.complex128, device=None) -> torch.Tensor:
    """b[2, L, L], `value` at (spin, x, y), zero elsewhere (the
    reference's source, level.h:55-59, at any site)."""
    b = torch.zeros((2, L, L), dtype=dtype, device=device)
    b[spin, site[0], site[1]] = value
    return b
