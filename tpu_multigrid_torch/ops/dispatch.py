"""The one module that chooses which implementation of each job runs: the
plain torch version (ops/stencil.py, gauge_stencil.py, smoothers.py,
transfer.py), a global or x-tiled kernel, or the fused level-0
residual-restriction (ops/cuda_stencil.py).

Each route function is pure: from what a call can observe (smoother kind,
n, L, dtype, batch axes, operand alignment, device type, MGConfig.pallas)
it returns "plain", "global", "tiled" or "fused". Kernels run only on
CUDA tensors of complex64 or complex128 with pallas != "off", for shapes
they take; the rest (n not in {1, 2, 4}, red-black on an odd L, gs_lex)
runs plain, as the JAX package's _relax sends it to XLA. Global or x-tiled
follows the L2 rule (cuda_stencil.u_mode, smoother_mode, apply_mode). Each
dispatcher calls what its route names; the links ones serve the links-only
Wilson level 0 (cycles.links_active).
"""
from __future__ import annotations

import functools

import torch

from . import cuda_stencil as cs
from . import gauge_stencil, smoothers, stencil, transfer

KERNEL_DTYPES = (torch.complex64, torch.complex128)
DENSE_NS = (1, 2, 4)               # the dense kernels' components a site


def _kernels(device: str, dtype, pallas: str) -> bool:
    return device == "cuda" and dtype in KERNEL_DTYPES and pallas != "off"


def _seen(t: torch.Tensor, pallas: str) -> dict:
    return {"device": t.device.type, "pallas": pallas}


def _pick(route: str, plain, global_, tiled=None):
    return {"plain": plain, "global": global_, "tiled": tiled}[route]


# ---- route functions


def smooth_route(kind: str, n: int, L: int, dtype, batch_ndim: int, *,
                 device: str, pallas: str) -> str:
    """The dense smoother: fields [C?, k?, n, L, L], red-black on even L."""
    if (not _kernels(device, dtype, pallas) or kind not in cs.KERNEL_KINDS
            or n not in DENSE_NS or batch_ndim > 2
            or (kind == "rbgs" and L % 2)):
        return "plain"
    return cs.smoother_mode(n, L, dtype)


def links_route(L: int, dtype, batch_ndim: int, kind: str = None, *,
                device: str, pallas: str) -> str:
    """The links smoother of `kind`, or residual (kind None): [B?, 2, L, L]."""
    if (not _kernels(device, dtype, pallas) or batch_ndim > 1
            or (kind is not None and kind not in cs.KERNEL_KINDS)
            or (kind == "rbgs" and L % 2)):
        return "plain"
    return cs.u_mode(L, dtype)


def residual_restrict_route(nc: int, bx: int, by: int, L: int, dtype,
                            batch_ndim: int, null_shared: bool,
                            on_lines: bool, *, device: str,
                            pallas: str) -> str:
    """'fused' where the links residual runs on the global kernel and the
    fused one takes the call; else the links residual's (then restrict)."""
    route = links_route(L, dtype, batch_ndim, device=device, pallas=pallas)
    if (route == "global" and null_shared and on_lines
            and cs.links_restrict_fits(nc, bx, by) and not L % bx
            and not L % by):
        return "fused"
    return route


def check_route(dtype, batch_ndim: int, *, device: str, pallas: str) -> str:
    """The level-0 check: one launch at any L."""
    return ("global" if _kernels(device, dtype, pallas) and batch_ndim <= 1
            else "plain")


def spmv_route(n: int, L: int, dtype, on_lines: bool, *, device: str,
               pallas: str) -> str:
    """The dense SpMV and residual: x-tiled where the global kernel (pairs
    of sites in 16-byte loads) cannot take an odd L or unaligned operand."""
    if not _kernels(device, dtype, pallas) or n not in DENSE_NS:
        return "plain"
    if cs.apply_mode(n, L, dtype) == "tiled" or L % 2 or not on_lines:
        return "tiled"
    return "global"


def links_apply_route(L: int, dtype, *, device: str, pallas: str) -> str:
    """The links SpMV."""
    if not _kernels(device, dtype, pallas):
        return "plain"
    return cs.apply_mode(2, L, dtype, links=True)


def transfer_route(dtype, *, device: str, pallas: str) -> str:
    """The cycle's transfers, whose kernels take every form it passes."""
    return "global" if _kernels(device, dtype, pallas) else "plain"


# ---- dispatchers


def smooth(D, D0inv, phi, r, n_sweeps: int, kind: str = "rbgs",
           omega: float = 1.0, pallas: str = "auto", cheby_interval=None):
    """n_sweeps dense smoother sweeps (reference f_relax); kind='chebyshev'
    runs ONE degree-n_sweeps polynomial on `cheby_interval` = (lmin,
    lmax) (solver.eigs), its applies by apply_D."""
    if kind == "chebyshev":
        if cheby_interval is None:
            raise ValueError("chebyshev smoother needs cheby_interval="
                             "(lmin, lmax); see solver.eigs")
        return smoothers.chebyshev_smooth(
            D, D0inv, phi, r, n_sweeps, *cheby_interval,
            apply=functools.partial(apply_D, pallas=pallas))
    route = smooth_route(kind, phi.shape[-3], phi.shape[-1], phi.dtype,
                         phi.dim() - 3, **_seen(phi, pallas))
    fn = _pick(route, smoothers.smooth_plain, cs.dense_smooth,
               cs.dense_smooth_tiled)
    return fn(D, D0inv, phi, r, n_sweeps, kind, omega)


def links_smooth(U, m: float, phi, r, n_sweeps: int, kind: str = "rbgs",
                 omega: float = 1.0, pallas: str = "auto"):
    """n_sweeps links-only Wilson smoother sweeps."""
    route = links_route(phi.shape[-1], phi.dtype, phi.dim() - 3, kind,
                        **_seen(phi, pallas))
    fn = _pick(route, functools.partial(gauge_stencil.smooth_u, "wilson"),
               cs.wilson_u_smooth, cs.wilson_u_smooth_tiled)
    return fn(U, m, phi, r, n_sweeps, kind, omega)


def _dense(D, v, r, pallas: str):
    """D v (r None) or r - D v, the batch in the groups of
    cuda_stencil.dense_groups (shapes that do not fit raise ValueError)."""
    route = spmv_route(v.shape[-3], v.shape[-1], v.dtype,
                       cs.aligned(D, v, r), **_seen(v, pallas))
    if route == "plain":
        lead = cs.dense_groups("spmv", D, v, r).lead
        if D.dim() == 6 and v.dim() == 4:   # E copies of D on E groups of v
            v = v.reshape(D.shape[0], -1, *v.shape[1:])
            D = D.unsqueeze(1)
        out = stencil.apply_D(D, v).reshape(lead + v.shape[-3:])
        return out if r is None else r - out
    if r is None:
        return _pick(route, None, cs.dense_apply, cs.dense_apply_tiled)(D, v)
    return _pick(route, None, cs.dense_residual,
                 cs.dense_residual_tiled)(D, v, r)


def apply_D(D, v, pallas: str = "auto"):
    """D v (pallas_stencil.apply_D_pallas_auto), D [E?, 5, n, n, L, L] on v
    [B?, n, L, L] (dense_groups)."""
    return _dense(D, v, None, pallas)


def residual(D, phi, r, pallas: str = "auto"):
    """r - D phi, r shaped like the result or shared."""
    return _dense(D, phi, r, pallas)


def links_residual(U, m: float, phi, r, pallas: str = "auto"):
    """r - D_U phi."""
    route = links_route(phi.shape[-1], phi.dtype, phi.dim() - 3,
                        **_seen(phi, pallas))
    fn = _pick(route, functools.partial(gauge_stencil.residual_u, "wilson"),
               cs.wilson_u_residual, cs.wilson_u_residual_tiled)
    return fn(U, m, phi, r)


def links_residual_restrict(U, m: float, phi, r, phi_null, quad: int,
                            bx: int, by: int, pallas: str = "auto"):
    """restrict(phi_null, r - D_U phi, quad, bx, by)."""
    route = residual_restrict_route(
        phi_null.shape[-4], bx, by, phi.shape[-1], phi.dtype, phi.dim() - 3,
        phi_null.dim() == 4, cs.aligned(U, phi, r, phi_null),
        **_seen(phi, pallas))
    if route == "fused":
        return cs.wilson_u_residual_restrict(U, m, phi, r, phi_null, quad,
                                             bx, by)
    return restrict(phi_null, links_residual(U, m, phi, r, pallas), quad, bx,
                    by, pallas)


def links_residual_norm(U, m: float, phi, b, pallas: str = "auto"):
    """||b - D_U phi|| / ||b|| in b's real dtype, one a batch entry."""
    route = check_route(phi.dtype, phi.dim() - 3, **_seen(phi, pallas))
    fn = _pick(route, functools.partial(gauge_stencil.residual_norm_ratio_u,
                                        "wilson"), cs.wilson_u_residual_norm)
    return fn(U, m, phi, b)


def links_apply(U, m: float, v, pallas: str = "auto"):
    """D_U v."""
    route = links_apply_route(v.shape[-1], v.dtype, **_seen(v, pallas))
    fn = _pick(route, gauge_stencil.apply_wilson_u, cs.wilson_u_apply,
               cs.wilson_u_apply_tiled)
    return fn(U, m, v)


def restrict(phi_null, vf, quad, bx: int, by: int, pallas: str = "auto"):
    """vec_c = sum_block Phi vf (reference near_null.h:217-240); quad None:
    the NTL copies', copy q of phi_null [..., nq, nc, nf, L, L] at quadrant
    q + 1, in one launch on the card."""
    fn = _pick(transfer_route(vf.dtype, **_seen(vf, pallas)),
               transfer.restrict_plain, cs.transfer_restrict)
    return fn(phi_null, vf, quad, bx, by)


def prolong(phi_null, vc, quad, bx: int, by: int, base=None,
            pallas: str = "auto"):
    """vec_f = Phi^dagger vec_c (reference near_null.h:242-264), plus
    `base` where given; quad None: the NTL copies', as restrict's."""
    fn = _pick(transfer_route(vc.dtype, **_seen(vc, pallas)),
               transfer.prolong_plain, cs.transfer_prolong)
    return fn(phi_null, vc, quad, bx, by, base)
