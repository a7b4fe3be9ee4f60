"""Numerical-analysis utilities in place of the reference's validation
notebooks (counterpart of tpu_multigrid/analysis.py):

- dense operator materialization and eigenspectra
- analytic free-field spectra for laplace / wilson, and the dense free
  staggered and naive operators
- the mode-resolved (FFT) error decomposition across MG cycles: the plot
  family showing MG killing the low modes plain relaxation stalls on
- convergence histories loaded from the results files and the JSONL
  metrics that utils.io.ResultsWriter writes
"""
from __future__ import annotations

import json
from typing import List, Optional

import numpy as np
import torch

from .config import MGConfig
from .ops.stencil import apply_D


def dense_operator(D: torch.Tensor) -> np.ndarray:
    """Materialize the stencil as a dense (n L^2) x (n L^2) matrix by
    applying it to the standard basis, the basis on a batch axis."""
    s, n, _, L, _ = D.shape
    N = n * L * L
    eye = torch.eye(N, dtype=D.dtype, device=D.device).reshape(N, n, L, L)
    cols = apply_D(D, eye)
    return cols.reshape(N, N).T.cpu().numpy()


def spectrum(D: torch.Tensor) -> np.ndarray:
    """Full eigenvalue spectrum of the (small) operator."""
    return np.linalg.eigvals(dense_operator(D))


def laplace_free_spectrum(L: int, m: float) -> np.ndarray:
    """-(4+m) + 2 cos kx + 2 cos ky over the Brillouin zone."""
    k = 2.0 * np.pi * np.arange(L) / L
    kx, ky = np.meshgrid(k, k, indexing="ij")
    return (-(4.0 + m) + 2 * np.cos(kx) + 2 * np.cos(ky)).ravel()


def wilson_free_spectrum(L: int, m: float,
                         convention: str = "solver") -> np.ndarray:
    """Analytic free-field Wilson eigenvalues over the Brillouin zone.

    convention='solver': the solver's normalization (hopping weight 1/2):
    models.operators.wilson_free_spectrum.
    convention='notebook': the notebook's un-halved variant
    (2+m) + 2 cos kx + 2 cos ky +- 2i sqrt(...), the eigenvalues of its
    own matrix, not the solver's.
    """
    if convention == "solver":
        from .models.operators import wilson_free_spectrum as _wfs
        return _wfs(L, m)
    if convention != "notebook":
        raise ValueError(f"bad convention {convention!r}")
    k = 2.0 * np.pi * np.arange(L) / L
    kx, ky = np.meshgrid(k, k, indexing="ij")
    re = (2.0 + m) + 2 * np.cos(kx) + 2 * np.cos(ky)
    im = 2 * np.sqrt(np.sin(kx) ** 2 + np.sin(ky) ** 2)
    return np.concatenate([(re + 1j * im).ravel(), (re - 1j * im).ravel()])


def staggered_dense(L: int, m: float = 0.0) -> np.ndarray:
    """Dense free staggered-fermion operator (one component per site):
    sum_mu eta_mu(x) [psi(x+mu) - psi(x-mu)]/2 + m, with eta_x = 1,
    eta_y(x) = (-1)^x (the hopping halved to the standard 1/(2a)
    normalization, the mass entering as +m)."""
    A = np.zeros((L * L, L * L), dtype=np.complex128)

    def idx(x, y):
        return x + y * L

    for x in range(L):
        for y in range(L):
            i = idx(x, y)
            eta_y = (-1.0) ** x
            A[i, idx((x + 1) % L, y)] += 0.5
            A[i, idx((x - 1) % L, y)] -= 0.5
            A[i, idx(x, (y + 1) % L)] += 0.5 * eta_y
            A[i, idx(x, (y - 1) % L)] -= 0.5 * eta_y
            A[i, i] += m
    return A


def naive_dense(L: int, m: float = 0.0) -> np.ndarray:
    """Dense free naive-fermion operator (2 spinor components):
    sum_mu gamma_mu [psi(x+mu) - psi(x-mu)]/2 + m, gamma_1 = sigma_x,
    gamma_2 = sigma_y. It shows the doublers the Wilson term removes."""
    g1 = np.array([[0, 1], [1, 0]], dtype=np.complex128)
    g2 = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
    N = 2 * L * L
    A = np.zeros((N, N), dtype=np.complex128)

    def blk(x, y):
        return 2 * (x + y * L)

    for x in range(L):
        for y in range(L):
            i = blk(x, y)
            for (dx, dy, g, s) in ((1, 0, g1, 0.5), (-1, 0, g1, -0.5),
                                   (0, 1, g2, 0.5), (0, -1, g2, -0.5)):
                j = blk((x + dx) % L, (y + dy) % L)
                A[i:i + 2, j:j + 2] += s * g
            A[i:i + 2, i:i + 2] += m * np.eye(2)
    return A


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def mode_error_spectrum(phi, phi_exact) -> np.ndarray:
    """|FFT(error)| per momentum mode, summed over dof: [L, L] real."""
    err = _host(phi) - _host(phi_exact)
    f = np.fft.fft2(err, axes=(-2, -1))
    return np.sqrt((np.abs(f) ** 2).sum(axis=0))


def mode_resolved_convergence(hier, b: torch.Tensor, cfg: MGConfig,
                              n_iters: int = 20,
                              modes: Optional[List[tuple]] = None):
    """Per-mode error amplitudes across MG cycles (solver.cycles.cycle),
    on b's device.

    Returns (modes, history[n_iters, n_modes]), the data behind the
    reference's spectral-analysis notebooks; phi_exact from a dense solve
    (small lattices only).
    """
    from .solver.cycles import cycle
    from .solver.hierarchy import zero_fields

    A = dense_operator(hier.levels[0].D)
    n, L = b.shape[0], b.shape[-1]
    exact = np.linalg.solve(A, _host(b).reshape(-1)).reshape(n, L, L)
    if modes is None:
        modes = [(0, 0), (1, 0), (0, 1), (1, 1), (L // 4, L // 4),
                 (L // 2, L // 2)]
    phis = zero_fields(cfg, b.device)
    hist = []
    for _ in range(n_iters):
        phis, _ = cycle(hier, phis, b, cfg)
        spec = mode_error_spectrum(phis[0], exact)
        hist.append([spec[kx, ky] for (kx, ky) in modes])
    return modes, np.asarray(hist)


def load_results_phi(path: str, L: int, ndof: int):
    """Parse a results_phi.txt / results_res_lvl-*.txt file back into
    [iters, n, L, L] complex (the notebooks' f_get_data)."""
    iters, fields = [], []
    with open(path) as f:
        for line in f:
            parts = [p for p in line.strip().split(",") if p]
            if not parts:
                continue
            iters.append(int(parts[0]))
            vals = []
            for tok in parts[1:]:
                re, _, im = tok.partition("+i")
                vals.append(complex(float(re), float(im)))
            arr = np.asarray(vals).reshape(L, L, ndof)   # x, y, dof
            fields.append(np.transpose(arr, (2, 0, 1)))
    return np.asarray(iters), np.asarray(fields)


def load_metrics_jsonl(path: str):
    rows = []
    with open(path) as f:
        for line in f:
            if line.strip():
                rows.append(json.loads(line))
    return rows
