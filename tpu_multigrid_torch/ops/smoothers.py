"""Stationary smoothers: Jacobi, red-black Gauss-Seidel, lexicographic
Gauss-Seidel and the Chebyshev polynomial (counterpart of
tpu_multigrid/ops/smoothers.py).

Update rule (reference Level::f_relax, level.h:100-128):
    phi(x) <- -D0(x)^{-1} ( sum_{mu != 0} D_mu(x) phi(x+mu) - r(x) )

`phi` and `r` may carry a leading batch axis; `D` and `D0inv` may be
shared by the batch or batched with it. Fields [C, k, n, L, L] with
operators [C, ...] are C groups of k fields, each group on its own
operator (an ensemble's near-null candidates: k a configuration); the
plain sweeps broadcast each operator over its group. These are the plain
versions of the dense_update kernels (ops/dispatch.smooth chooses).
`gs_lex` has no kernel, as in the JAX package (plain XLA there), nor has
`chebyshev`: its applies are the ones it is given (dispatch.smooth gives
the dispatched SpMV), its site matvecs and axpys plain torch.
"""
from __future__ import annotations

import numpy as np
import torch

from .gauge_stencil import parity_mask
from .stencil import apply_D, apply_hop, _site_matvec

KINDS = ("jacobi", "rbgs", "gs_lex", "chebyshev")


def _local_solve(D0inv, hop, r):
    return -_site_matvec(D0inv, hop - r)


def jacobi_sweep(D, D0inv, phi, r, omega: float = 1.0):
    new = _local_solve(D0inv, apply_hop(D, phi), r)
    if omega == 1.0:
        return new
    return phi + omega * (new - phi)


def rbgs_sweep(D, D0inv, phi, r, omega: float = 1.0):
    par = parity_mask(phi.shape[-1], phi.real.dtype, phi.device)
    for mask in (1.0 - par, par):
        upd = _local_solve(D0inv, apply_hop(D, phi), r)
        phi = phi + omega * mask * (upd - phi)
    return phi


def gs_lex_sweep(D, D0inv, phi, r, omega: float = 1.0):
    """Exact lexicographic Gauss-Seidel in the reference's in-place site
    order `for x { for y { update } }` (level.h:114-123), as the JAX
    package's wavefront: a site's already-updated neighbours (x-1, y),
    (x, y-1) and the periodic wraps lie on anti-diagonals x + y below its
    own, its not-yet-updated ones above, so updating each whole
    anti-diagonal d = 0 .. 2L-2 in turn reproduces the lexicographic
    sweep in 2L-1 steps."""
    L = phi.shape[-1]
    ar = torch.arange(L, device=phi.device)
    diag = ar[:, None] + ar[None, :]
    for d in range(2 * L - 1):
        upd = _local_solve(D0inv, apply_hop(D, phi), r)
        if omega != 1.0:
            upd = phi + omega * (upd - phi)
        phi = torch.where(diag == d, upd, phi)
    return phi


def chebyshev_smooth(D, D0inv, phi, r, degree: int, lmin: float,
                     lmax: float, apply=apply_D):
    """Degree-`degree` Chebyshev iteration on A e = f with A = D0^{-1} D,
    f = D0^{-1} r, eigenvalues of A assumed in [lmin, lmax] (positive).

    The classic three-term recurrence (Saad, Iterative Methods §12.2), as
    the JAX package's chebyshev_smooth: the error is multiplied by the
    scaled-and-shifted Chebyshev polynomial that is minimal on [lmin, lmax].
    Each step costs one stencil apply, as a Jacobi sweep does. The scalar
    recurrence runs on the host, rounded to the field's real dtype as the
    JAX package's is. apply(D, v) is D v (default: the plain
    stencil.apply_D)."""
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    real = np.float64 if phi.dtype == torch.complex128 else np.float32

    def A(v):
        return _site_matvec(D0inv, apply(D, v))

    f = _site_matvec(D0inv, r)
    d = (f - A(phi)) / theta
    x = phi + d
    rho_prev = real(1.0 / sigma1)
    for _ in range(degree - 1):
        rho = real(1.0) / (real(2.0 * sigma1) - rho_prev)
        d = (complex(rho * rho_prev) * d
             + complex(real(2.0) * rho / real(delta)) * (f - A(x)))
        x = x + d
        rho_prev = rho
    return x


_SWEEPS = {"jacobi": jacobi_sweep, "rbgs": rbgs_sweep, "gs_lex": gs_lex_sweep}


def _over_groups(t: torch.Tensor, site_ndim: int, phi: torch.Tensor):
    """A batched operator t (site_ndim axes a site block: 5 for D, 4 for
    D0inv) with an axis of size 1 inserted after its batch axes for each
    batch axis that phi has beyond them, so that it broadcasts over the
    fields of its group: D [C, 5, n, n, L, L] against phi [C, k, n, L, L]
    becomes [C, 1, 5, n, n, L, L]. A shared operator is left as it is."""
    lead = t.dim() - site_ndim
    extra = phi.dim() - 3 - lead
    if lead == 0 or extra <= 0:
        return t
    return t.reshape(t.shape[:lead] + (1,) * extra + t.shape[lead:])


def smooth_plain(D, D0inv, phi, r, n_sweeps: int, kind: str = "rbgs",
                 omega: float = 1.0):
    """n_sweeps plain torch sweeps on any device (jacobi, rbgs, gs_lex)."""
    if kind not in KINDS:
        raise NotImplementedError(f"no smoother {kind!r} (have {KINDS})")
    if kind not in _SWEEPS:
        raise ValueError(f"{kind} is not a sweep: use dispatch.smooth")
    sweep = _SWEEPS[kind]
    D, D0inv = _over_groups(D, 5, phi), _over_groups(D0inv, 4, phi)
    for _ in range(n_sweeps):
        phi = sweep(D, D0inv, phi, r, omega)
    return phi
