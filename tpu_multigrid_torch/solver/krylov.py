"""Krylov accelerators (counterpart of tpu_multigrid/solver/krylov.py):
MG-preconditioned flexible GMRES, CGNR, and CGNR with complex128 defect
correction.

For near-critical or indefinite Wilson systems the stationary MG cycle
can stagnate or diverge; FGMRES wraps the cycle as a right preconditioner,
and CGNR (CG on D^H D, Hermitian positive definite for any invertible D)
converges where every other solver here stalls. Every operator
application is dispatch.apply_D: the SpMV kernels on CUDA tensors
(complex64 and complex128), the plain version on CPU ones. As in the JAX
package, a chunk of CGNR iterations, and FGMRES's preconditioner and its
operator apply, each run as one device program
(utils.compile.CapturedChunk: a CUDA graph captured once a call on CUDA
tensors), with one host read-back per chunk (CGNR) or per Arnoldi step
(FGMRES, whose small Hessenberg problem is solved on the host in
complex128 numpy). Each public solver is a root span (profiling.span),
and each host read (a chunk's result, a norm) a driver.read_back span.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from .. import profiling
from ..config import MGConfig
from ..ops import dispatch
from ..ops.stencil import adjoint_stencil, _sumsq
from ..utils.compile import CapturedChunk, run_steps
from .cycles import cycle
from .driver import KRYLOV_BLOCK, READ_BACK
from .hierarchy import Hierarchy, zero_fields


def _mg_precond(hier, v, cfg, n_cycles: int):
    """Approximate D^{-1} v by n_cycles MG cycles from zero."""
    phis = zero_fields(cfg, v.device)
    for _ in range(n_cycles):
        phis, _ = cycle(hier, phis, v, cfg)
    return phis[0]


def _norm(v: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(v))


@profiling.span("fgmres_solve")
def fgmres_solve(hier: Hierarchy, b: torch.Tensor, cfg: MGConfig,
                 tol: Optional[float] = None, restart: int = 10,
                 max_restarts: int = 50, precond_cycles: int = 1):
    """Flexible GMRES(restart) right-preconditioned by `precond_cycles` MG
    cycles from zero.

    Host-driven Arnoldi with modified Gram-Schmidt; the Hessenberg least
    squares runs on the host in complex128 (np.linalg.lstsq). The
    preconditioner and the operator apply after it are one program each,
    on the Arnoldi vector loaded into its buffer. Returns
    (phi, total_iterations, rel_residual), phi a tensor on b's device.
    """
    tol = tol or cfg.res_threshold
    D = hier.levels[0].D
    with READ_BACK:
        bnorm = _norm(b)
    prog = CapturedChunk(torch.zeros_like(b), torch.zeros_like(b))

    def precond(v, z):
        return (v, _mg_precond(hier, v, cfg, precond_cycles)), None

    def apply(v, z):
        return (v, z), dispatch.apply_D(D, z)

    x = torch.zeros_like(b)
    total_iters = 0

    for _ in range(max_restarts):
        r = b - dispatch.apply_D(D, x)
        with READ_BACK:
            beta = _norm(r)
        if beta / bnorm < tol:
            prog.close()
            return x, total_iters, beta / bnorm
        V = [r / beta]
        Z = []
        H = np.zeros((restart + 1, restart), dtype=np.complex128)
        g = np.zeros(restart + 1, dtype=np.complex128)
        g[0] = beta
        k_done = 0
        for k in range(restart):
            prog.load(V[k])
            prog("precond", precond)
            w = prog("apply", apply).clone()
            Z.append(prog.state[1].clone())
            for i in range(k + 1):
                with READ_BACK:
                    hik = complex(torch.vdot(V[i].reshape(-1),
                                             w.reshape(-1)))
                H[i, k] = hik
                w = w - hik * V[i]
            with READ_BACK:
                hk1 = _norm(w)
            H[k + 1, k] = hk1
            k_done = k + 1
            total_iters += 1
            if hk1 < 1e-14 * bnorm:
                break
            V.append(w / hk1)
            y, *_ = np.linalg.lstsq(H[:k + 2, :k + 1], g[:k + 2], rcond=None)
            est = np.linalg.norm(H[:k + 2, :k + 1] @ y - g[:k + 2])
            if est / bnorm < tol:
                break
        y, *_ = np.linalg.lstsq(H[:k_done + 1, :k_done], g[:k_done + 1],
                                rcond=None)
        x = x + sum(complex(y[i]) * Z[i] for i in range(k_done))

    prog.close()
    r = b - dispatch.apply_D(D, x)
    with READ_BACK:
        rel = _norm(r) / bnorm
    return x, total_iters, rel


def _guarded_ratio(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num / den where den > 0 (den clamped at 1e-300 as in the JAX
    package), else 0."""
    return torch.where(den > 0, num / torch.clamp_min(den, 1e-300),
                       torch.zeros((), dtype=torch.float64, device=num.device))


@profiling.span("cgnr_solve")
def cgnr_solve(D, b, tol: float = 1e-8, max_iters: int = 50000,
               chunk: int = 500, Ddag=None, x0=None):
    """CG on the normal equations D^H D x = D^H b (CGNR), the solver of
    the indefinite regime (Wilson m=-0.07 on a beta=32 ensemble).

    Two SpMVs per iteration (D, then D^H as the stencil
    adjoint_stencil(D), or `Ddag` if given). |r|^2 is accumulated in
    float64, p^H A p in A p's dtype; alpha and beta are cast to x's real
    dtype before they multiply. A zero p^H A p gives alpha = 0 and a zero
    |r|^2 gives beta = 0, so a converged iteration stalls, as JAX's does
    where XLA flushes float32 denormals to zero; torch keeps them until
    p^H A p underflows as well, where an unguarded 0/0 would give NaN.
    `chunk` iterations run between host checks of the true residual
    ||b - D x|| / ||b||, as programs of KRYLOV_BLOCK iterations and one of
    the rest, each ending in the true residual's norm. Returns (x, iters,
    rel), x a tensor on b's device.
    """
    apply = dispatch.apply_D
    if Ddag is None:
        Ddag = adjoint_stencil(D)
    rdt = b.real.dtype
    with READ_BACK:
        bn = math.sqrt(float(_sumsq(b)))
    x = x0 if x0 is not None else torch.zeros_like(b)
    r = apply(Ddag, b - apply(D, x))
    prog = CapturedChunk(x, r, r, _sumsq(r))

    def steps(n):
        def body(x, r, p, rs):
            for _ in range(n):
                Ap = apply(Ddag, apply(D, p))
                pAp = torch.sum(torch.conj(p) * Ap).real
                alpha = _guarded_ratio(rs, pAp).to(rdt)
                x = x + alpha * p
                r = r - alpha * Ap
                rs_new = _sumsq(r)
                beta = _guarded_ratio(rs_new, rs).to(rdt)
                p = r + beta.to(p.dtype) * p
                rs = rs_new
            return (x, r, p, rs), _sumsq(b - apply(D, x))
        return body

    it = 0
    rel = float("inf")
    while it < max_iters:
        rn2 = run_steps(prog, chunk, KRYLOV_BLOCK, steps)
        it += chunk
        with READ_BACK:
            rel = math.sqrt(float(rn2)) / bn
        if rel < tol or not math.isfinite(rel):
            break
    prog.close()
    return prog.state[0], it, rel


@profiling.span("cgnr_solve_ir")
def cgnr_solve_ir(D64, D_host, b_host, tol: float = 1e-8,
                  inner_tol: float = 1e-5, inner_max: int = 6000,
                  max_outer: int = 10, chunk: int = 500):
    """CGNR with complex128 defect correction: complex64 inner CGNR solves
    on D64, and a complex128 outer residual r = b - D x on the exact
    operator, so the true residual reaches 1e-8 and below.

    D64: complex64 stencil tensor (its device is the solve's). D_host and
    b_host: the exact complex128 operator and right-hand side, numpy
    arrays or tensors, moved to D64's device. The JAX package carries the
    outer loop on float64 real/imaginary planes (its TPU rejects
    complex128); here it is complex128 with the same math. Returns
    dict(rel, outer, inner_iters, phi_planes), phi_planes the float64
    (real, imag) tensors of x on D64's device.
    """
    dev = D64.device
    D128 = torch.as_tensor(D_host).to(device=dev, dtype=torch.complex128)
    b = torch.as_tensor(b_host).to(device=dev, dtype=torch.complex128)
    with READ_BACK:
        bn = math.sqrt(float(_sumsq(b)))
    Ddag64 = adjoint_stencil(D64)
    phi = torch.zeros_like(b)
    r = b
    total_inner = 0
    rel = float("inf")
    outer = 0
    for outer in range(1, max_outer + 1):
        with READ_BACK:
            rn = math.sqrt(float(_sumsq(r)))
        if rn == 0.0:
            break
        r64 = (r * (1.0 / rn)).to(torch.complex64)
        e, it, _ = cgnr_solve(D64, r64, tol=inner_tol, max_iters=inner_max,
                              chunk=chunk, Ddag=Ddag64)
        total_inner += it
        phi = phi + rn * e.to(torch.complex128)
        r = b - dispatch.apply_D(D128, phi)
        with READ_BACK:
            rel = math.sqrt(float(_sumsq(r))) / bn
        if rel < tol or not math.isfinite(rel):
            break
    return {"rel": rel, "outer": outer, "inner_iters": total_inner,
            "phi_planes": (phi.real.contiguous(), phi.imag.contiguous())}
