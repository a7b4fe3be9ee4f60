"""Level-0 lattice operator assembly: gauged Laplace and Wilson-Dirac as
a 5-point block stencil ``D[5, n, n, L, L]`` (directions 0=same, 1=+x,
2=-x, 3=+y, 4=-y). Counterpart of tpu_multigrid/models/operators.py.

  laplace: D0 = -(4+m) I;  D_{+mu} = U_mu(x);  D_{-mu} = U_mu(x-mu)^*
  wilson:  D0 = (2+m) I;   D_{+mu} = U_mu(x) * 1/2 (I - gamma_mu)
           D_{-mu} = U_mu(x-mu)^* * 1/2 (I + gamma_mu)
"""
from __future__ import annotations

import numpy as np
import torch


def gamma_matrices(n: int = 2, dtype=np.complex128):
    """2D Euclidean gamma matrices (reference level.h:161-162)."""
    g1 = np.array([[0, 1], [1, 0]], dtype=dtype)
    g2 = np.array([[0, -1j], [1j, 0]], dtype=dtype)
    return g1, g2


def gamma5(n: int, dtype=np.complex128):
    """Chirality matrix: +1 on the upper half of the dof, -1 on the lower."""
    d = np.ones(n, dtype=dtype)
    d[n // 2:] = -1.0
    return np.diag(d)


def assemble_laplace(U: torch.Tensor, m: float) -> torch.Tensor:
    """Gauged Laplace stencil, n=1: D[5, 1, 1, L, L]."""
    d0 = -(4.0 + m) * torch.ones_like(U[0])
    dxm = torch.conj(torch.roll(U[0], 1, dims=-2))
    dym = torch.conj(torch.roll(U[1], 1, dims=-1))
    D = torch.stack([d0, U[0], dxm, U[1], dym])
    return D[:, None, None, :, :].contiguous()


def assemble_wilson(U: torch.Tensor, m: float) -> torch.Tensor:
    """Wilson-Dirac stencil, n=2: D[5, 2, 2, L, L], hopping terms stored
    with a + sign and projectors 1/2(I -+ gamma) (reference
    level.h:165-171)."""
    g1, g2 = gamma_matrices()
    eye = np.eye(2, dtype=np.complex128)

    def const(a):
        return torch.as_tensor(a, dtype=U.dtype, device=U.device)

    ux, uy = U[0], U[1]
    uxm = torch.conj(torch.roll(ux, 1, dims=-2))
    uym = torch.conj(torch.roll(uy, 1, dims=-1))

    def hop(proj, link):
        return const(proj)[:, :, None, None] * link[None, None]

    d0 = (2.0 + m) * const(eye)[:, :, None, None] * torch.ones_like(ux)[None, None]
    return torch.stack([d0, hop(0.5 * (eye - g1), ux),
                        hop(0.5 * (eye + g1), uxm),
                        hop(0.5 * (eye - g2), uy),
                        hop(0.5 * (eye + g2), uym)])


def assemble(stencil: str, U: torch.Tensor, m: float) -> torch.Tensor:
    if stencil == "laplace":
        return assemble_laplace(U, m)
    if stencil == "wilson":
        return assemble_wilson(U, m)
    raise ValueError(f"unknown stencil {stencil!r}")


def wilson_free_spectrum(L: int, m: float) -> np.ndarray:
    """Analytic free-field Wilson eigenvalues, for validation (reference
    analysis_nbks/spectrum_calc/1_compute_spectrum.ipynb): for each
    momentum (kx, ky),
      lam(k) = (2+m) + cos kx + cos ky +- i sqrt(sin^2 kx + sin^2 ky).
    Returns the 2 L^2 eigenvalues."""
    k = 2.0 * np.pi * np.arange(L) / L
    kx, ky = np.meshgrid(k, k, indexing="ij")
    re = (2.0 + m) + np.cos(kx) + np.cos(ky)
    im = np.sqrt(np.sin(kx) ** 2 + np.sin(ky) ** 2)
    return np.concatenate([(re + 1j * im).ravel(), (re - 1j * im).ravel()])
