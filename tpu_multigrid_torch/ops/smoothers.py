"""Stationary smoothers: Jacobi, red-black Gauss-Seidel and lexicographic
Gauss-Seidel (counterpart of tpu_multigrid/ops/smoothers.py; Chebyshev is
not ported yet).

Update rule (reference Level::f_relax, level.h:100-128):
    phi(x) <- -D0(x)^{-1} ( sum_{mu != 0} D_mu(x) phi(x+mu) - r(x) )

`phi` and `r` may carry a leading batch axis; `D` and `D0inv` may be
shared by the batch or batched with it. The Jacobi and red-black sweeps
here are the plain torch versions of the dense_update and
dense_update_tiled kernels (ops/cuda_stencil.py), which `smooth` runs for
CUDA tensors. `gs_lex` has no kernel, here as in the JAX package (which
runs it on plain XLA): `smooth` runs its plain sweeps on any device.
"""
from __future__ import annotations

import torch

from .gauge_stencil import parity_mask
from .stencil import apply_hop, _site_matvec

KINDS = ("jacobi", "rbgs", "gs_lex")
KERNEL_KINDS = ("jacobi", "rbgs")        # the kinds with a CUDA kernel


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


_SWEEPS = {"jacobi": jacobi_sweep, "rbgs": rbgs_sweep, "gs_lex": gs_lex_sweep}


def _check_kind(kind: str):
    if kind not in KINDS:
        raise NotImplementedError(
            f"smoother {kind!r} is not ported yet (have {KINDS})")


def smooth_plain(D, D0inv, phi, r, n_sweeps: int, kind: str = "rbgs",
                 omega: float = 1.0):
    """n_sweeps plain torch sweeps on any device."""
    _check_kind(kind)
    sweep = _SWEEPS[kind]
    for _ in range(n_sweeps):
        phi = sweep(D, D0inv, phi, r, omega)
    return phi


def smooth(D, D0inv, phi, r, n_sweeps: int, kind: str = "rbgs",
           omega: float = 1.0, pallas: str = "auto"):
    """Run n_sweeps smoother sweeps (reference f_relax's num_iter loop).

    pallas='auto' (MGConfig.pallas) runs the CUDA kernels on CUDA tensors:
    dense_update, or dense_update_tiled where cuda_stencil.smoother_mode
    says the level is past the L2; 'off' runs the plain torch sweeps
    everywhere. A kind without a kernel (gs_lex) runs its plain sweeps on
    any device, as the JAX package runs it on plain XLA.
    """
    _check_kind(kind)
    if pallas == "off" or kind not in KERNEL_KINDS:
        return smooth_plain(D, D0inv, phi, r, n_sweeps, kind, omega)
    from . import cuda_stencil as cs
    n, L = phi.shape[-3], phi.shape[-1]
    fn = (cs.dense_smooth_tiled if cs.smoother_mode(n, L, phi.dtype) == "tiled"
          else cs.dense_smooth)
    return fn(D, D0inv, phi, r, n_sweeps, kind, omega)
