"""Stationary smoothers: Jacobi and red-black Gauss-Seidel (counterpart of
tpu_multigrid/ops/smoothers.py; lexicographic GS and Chebyshev are not
ported yet).

Update rule (reference Level::f_relax, level.h:100-128):
    phi(x) <- -D0(x)^{-1} ( sum_{mu != 0} D_mu(x) phi(x+mu) - r(x) )

`phi` and `r` may carry a leading batch axis; `D` and `D0inv` may be
shared by the batch or batched with it. The sweeps here are the plain
torch versions of the dense_update and dense_update_tiled kernels
(ops/cuda_stencil.py), which `smooth` runs for CUDA tensors.
"""
from __future__ import annotations

from .gauge_stencil import parity_mask
from .stencil import apply_hop, _site_matvec

KINDS = ("jacobi", "rbgs")


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


_SWEEPS = {"jacobi": jacobi_sweep, "rbgs": rbgs_sweep}


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
    everywhere.
    """
    if pallas == "off":
        return smooth_plain(D, D0inv, phi, r, n_sweeps, kind, omega)
    from . import cuda_stencil as cs
    n, L = phi.shape[-3], phi.shape[-1]
    fn = (cs.dense_smooth_tiled if cs.smoother_mode(n, L, phi.dtype) == "tiled"
          else cs.dense_smooth)
    return fn(D, D0inv, phi, r, n_sweeps, kind, omega)
