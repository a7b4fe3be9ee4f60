"""Even-odd (red/black Schur-complement) preconditioned solves
(counterpart of tpu_multigrid/solver/eo.py; the algebra is in its module
docstring).

For a 5-point stencil the hopping terms connect only sites of opposite
parity, so in the (even, odd) ordering the solve reduces to the even-site
Schur system

    S x_e = b_e - Deo Doo^{-1} b_o,   S = Dee - Deo Doo^{-1} Doe,
    x_o  = Doo^{-1} (b_o - Doe x_e).

Fields stay full [n, L, L] tensors with parity support: apply_hop maps an
even-supported field to an odd-supported one, so the iteration needs no
masking. The Schur application is plain torch (apply_hop and the site
matvecs, as in the JAX package); the full-system residual goes through
dispatch.apply_D.
"""
from __future__ import annotations

import torch

from .. import profiling
from ..config import SAME
from ..ops import dispatch, gauge_stencil
from ..ops.stencil import apply_hop, _site_matvec, site_inverse
from .driver import mr_iterate


def parity_mask(L: int, dtype, device=None) -> torch.Tensor:
    """[1, L, L] mask: 1.0 on EVEN sites ((x+y) % 2 == 0), else 0."""
    return (1 - gauge_stencil.parity_mask(L, dtype, device))[None]


def schur_apply(D: torch.Tensor, D0inv: torch.Tensor,
                xe: torch.Tensor) -> torch.Tensor:
    """S xe for an even-supported field xe (odd sites zero); the result is
    even-supported with no explicit masking."""
    t = _site_matvec(D0inv, apply_hop(D, xe))
    return _site_matvec(D[SAME], xe) - apply_hop(D, t)


def eo_reduce(D: torch.Tensor, D0inv: torch.Tensor, b: torch.Tensor):
    """Split b and form the even-site Schur right-hand side.

    Returns (be_hat, bo) with be_hat = b_e - Deo Doo^{-1} b_o."""
    even = parity_mask(b.shape[-1], b.real.dtype, b.device)
    bo = b * (1.0 - even)
    be = b * even
    be_hat = be - even * apply_hop(D, _site_matvec(D0inv, bo))
    return be_hat, bo


def eo_reconstruct(D: torch.Tensor, D0inv: torch.Tensor, xe: torch.Tensor,
                   bo: torch.Tensor) -> torch.Tensor:
    """Back-substitute the odd sites: x = xe + Doo^{-1}(b_o - Doe xe)."""
    even = parity_mask(xe.shape[-1], xe.real.dtype, xe.device)
    xo = _site_matvec(D0inv, bo - (1.0 - even) * apply_hop(D, xe))
    return xe + (1.0 - even) * xo


@profiling.span("eo_mr_solve")
def eo_mr_solve(D: torch.Tensor, b: torch.Tensor, tol: float = 1e-8,
                max_iters: int = 100000, chunk: int = 1000):
    """Minimal-residual iteration on the even-odd Schur system.

    The update rule of driver.mr_solve on S, `chunk` steps between host
    checks. With x_o back-substituted exactly the odd rows of b - D x
    vanish and the even rows equal the Schur residual, so the iteration
    stops on the Schur residual over ||b||; the returned residual is the
    full system's ||b - D x|| / ||b||, D x by dispatch.apply_D.
    Returns (x, schur_iters, full_relres), x a tensor on b's device.
    """
    D0inv = site_inverse(D[SAME])
    be_hat, bo = eo_reduce(D, D0inv, b)
    xe, it, _ = mr_iterate(lambda v: schur_apply(D, D0inv, v), be_hat, b,
                           tol, max_iters, chunk)
    x = eo_reconstruct(D, D0inv, xe, bo)
    res = b - dispatch.apply_D(D, x)
    rel = torch.sqrt(torch.sum(res.abs() ** 2) / torch.sum(b.abs() ** 2))
    return x, it, float(rel)
