"""Matrix-free spectral estimators: power iteration and Lanczos
(counterpart of tpu_multigrid/solver/eigs.py).

- `power_extreme`   : largest |lambda| of any operator (power iteration).
- `lanczos_extremes`: extremal eigenvalues of a HERMITIAN operator
  (Lanczos tridiagonalization, no reorthogonalization).
- `hermitian_form`  : D itself for laplace, gamma5 D for wilson.
- `spectral_interval`: (lambda_min, lambda_max) of the Hermitian form.
- `chebyshev_config` / `jacobi_operator_lmax`: the Chebyshev smoother's
  interval, lambda_max of D0^{-1} D on every level.

Every operator apply is dispatch.apply_D (the dense SpMV kernels on
CUDA tensors, the plain stencil.apply_D on CPU ones); the iterations run
on the tensors' device and only the k x k tridiagonal eigenproblem runs on
the host. The random starts come from np.random.default_rng(seed), as in
the JAX package, so the two packages start from the same vectors.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..models.operators import gamma5
from ..ops import dispatch
from ..ops.stencil import _site_matvec


def _norm(v):
    return torch.sqrt(torch.sum(v.abs() ** 2))


def _vdot(v, w):
    return torch.sum(torch.conj(v) * w)


def power_extreme(matvec: Callable, v0: torch.Tensor, iters: int = 50):
    """Largest |lambda| (spectral radius estimate) by power iteration.

    Returns (lmax, v): the Rayleigh-quotient magnitude after `iters`
    normalized applications (a 0-d real tensor), and the final vector."""
    v = v0 / _norm(v0)
    for _ in range(iters):
        w = matvec(v)
        v = w / _norm(w)
    w = matvec(v)
    lam = _vdot(v, w).abs() / torch.sum(v.abs() ** 2)
    return lam, v


def lanczos_tridiag(matvec: Callable, v0: torch.Tensor, k: int = 48):
    """k-step Lanczos for a HERMITIAN operator: returns (alpha[k],
    beta[k-1]) of the tridiagonal projection T_k, as numpy arrays."""
    v_prev = torch.zeros_like(v0)
    v = v0 / _norm(v0)
    beta_prev = torch.zeros((), dtype=v0.real.dtype, device=v0.device)
    tiny = torch.finfo(beta_prev.dtype).tiny
    alphas, betas = [], []
    for _ in range(k):
        w = matvec(v) - beta_prev.to(v.dtype) * v_prev
        alpha = torch.real(_vdot(v, w))
        w = w - alpha.to(v.dtype) * v
        beta = _norm(w)
        safe = torch.clamp(beta, min=tiny)
        v_prev, v, beta_prev = v, w / safe.to(v.dtype), beta
        alphas.append(alpha)
        betas.append(beta)
    return (torch.stack(alphas).cpu().numpy(),
            torch.stack(betas).cpu().numpy()[:-1])


def lanczos_extremes(matvec: Callable, v0: torch.Tensor,
                     k: int = 48) -> Tuple[float, float]:
    """(lambda_min, lambda_max) estimates of a Hermitian operator."""
    alphas, betas = lanczos_tridiag(matvec, v0, k)
    T = np.diag(alphas) + np.diag(betas, 1) + np.diag(betas, -1)
    ev = np.linalg.eigvalsh(T)
    return float(ev[0]), float(ev[-1])


def hermitian_form(D: torch.Tensor, stencil: str) -> Callable:
    """Matvec of the Hermitian form: D (laplace) or gamma5 D (wilson)."""
    n = D.shape[1]
    if stencil == "laplace":
        return lambda v: dispatch.apply_D(D, v)
    g5 = torch.from_numpy(gamma5(n)).to(device=D.device, dtype=D.dtype)
    return lambda v: torch.einsum("ij,jxy->ixy", g5,
                                  dispatch.apply_D(D, v))


def _start(D: torch.Tensor, seed: int) -> torch.Tensor:
    """The JAX package's start vector: complex normal [n, L, L] from
    np.random.default_rng(seed), in D's dtype on D's device."""
    n, L = D.shape[1], D.shape[-1]
    rng = np.random.default_rng(seed)
    v0 = rng.normal(size=(n, L, L)) + 1j * rng.normal(size=(n, L, L))
    return torch.from_numpy(v0).to(device=D.device, dtype=D.dtype)


def spectral_interval(D: torch.Tensor, stencil: str, k: int = 48,
                      seed: int = 0) -> Tuple[float, float]:
    """Extremal eigenvalues of the operator's Hermitian form (D for
    laplace, gamma5 D for wilson), matrix-free: the spectrum edges at any
    lattice size."""
    return lanczos_extremes(hermitian_form(D, stencil), _start(D, seed), k)


def chebyshev_config(cfg, hier, lmin_frac: float = None, iters: int = 40):
    """A copy of `cfg` set up for the Chebyshev smoother: lambda_max of
    D0^{-1} D on every level of `hier` by power iteration, in
    cfg.cheby_lmax. Build the hierarchy with another smoother first (the
    setup needs no intervals), then solve with the returned config:

        hier = mgt.build_hierarchy(D, cfg)
        out = mgt.solve(hier, b, eigs.chebyshev_config(cfg, hier))
    """
    lmaxs = tuple(jacobi_operator_lmax(lev.D, lev.D0inv, iters)
                  for lev in hier.levels)
    kw = {"smoother": "chebyshev", "cheby_lmax": lmaxs}
    if lmin_frac is not None:
        kw["cheby_lmin_frac"] = lmin_frac
    return cfg.replace(**kw)


def jacobi_operator_lmax(D: torch.Tensor, D0inv: torch.Tensor,
                         iters: int = 40, seed: int = 0) -> float:
    """Largest |lambda| of the Jacobi-preconditioned operator
    A = D0^{-1} D: the upper end of the Chebyshev smoother's interval."""
    lam, _ = power_extreme(
        lambda v: _site_matvec(D0inv, dispatch.apply_D(D, v)),
        _start(D, seed), iters)
    return float(lam)
