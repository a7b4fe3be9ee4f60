"""The reference's compiled-in self-test suite as reusable property checks
(counterpart of tpu_multigrid/testing.py; reference tests.h:5-295,
tolerance Epsilon = 1e-12).

Each check returns a scalar "violation" (max abs deviation, or a relative
one for test 4) so callers — pytest, or the pre-solve pass run_mg_tests —
compare it with the tolerance.

These are exact identity checks, so they run with full float32 matmuls
(TF32 off, matmul precision "highest"), as the JAX package pins HIGHEST
precision for them: reduced-precision passes would fail complex64
hierarchies on the 1e-4 bar.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .config import MGConfig
from .models.operators import gamma5
from .ops.stencil import apply_D, shift
from .ops.transfer import restrict, prolong
from .solver.hierarchy import Hierarchy, _pin_setup_precision

EPSILON = 1.0e-12       # reference tests.h tolerance (double precision)


def epsilon_for(cfg) -> float:
    """Self-test tolerance for the run's dtype: the reference's 1e-12
    (tests.h:10) presumes double; complex64 hierarchies pass the same
    structural checks at float32 rounding scale, 1e-4."""
    return EPSILON if cfg.dtype == "complex128" else 1.0e-4


def test1_restriction_prolongation(phi_null, vec_c, quad, bx, by):
    """P (P^dagger v_c) = v_c for any coarse v_c (tests.h:5-43) —
    requires block-orthonormal near-null rows. Returns max abs diff."""
    vf = prolong(phi_null, vec_c, quad, bx, by)
    back = restrict(phi_null, vf, quad, bx, by)
    return (back - vec_c).abs().max()


def test2_galerkin(D_c, D_f, phi_null, vec_c, quad, bx, by):
    """D_c v = P (D_f (P^dagger v)) for a coarse v (tests.h:46-92)."""
    vf = prolong(phi_null, vec_c, quad, bx, by)
    lhs = restrict(phi_null, apply_D(D_f, vf), quad, bx, by)
    return (lhs - apply_D(D_c, vec_c)).abs().max()


def _g5(n, like):
    return torch.as_tensor(gamma5(n), dtype=like.dtype, device=like.device)


def test3_hermiticity(D, stencil: str):
    """Element-wise stencil (gamma5-)hermiticity (tests.h:94-182).

    laplace: D_1(x) = D_2(x+x)^H, D_3(x) = D_4(x+y)^H, D_0 = D_0^H.
    wilson:  the same with gamma5 M^H gamma5.
    """
    n = D.shape[1]

    def adj(M):  # conj-transpose of per-site blocks [n, n, L, L]
        return torch.conj(M.transpose(0, 1))

    def g5adj(M):
        g5 = _g5(n, D)
        return torch.einsum("ij,jkxy,kl->ilxy", g5, adj(M), g5)

    trans = adj if stencil == "laplace" else g5adj
    return torch.stack([(D[1] - trans(shift(D[2], 1))).abs().max(),
                        (D[3] - trans(shift(D[4], 3))).abs().max(),
                        (D[0] - trans(D[0])).abs().max()]).max()


def test4_hermiticity_full(D, vec, stencil: str):
    """<v|D|v> real (laplace) / <v|D gamma5|v> real (wilson)
    (tests.h:184-248). Returns the relative imaginary part
    |Im <...>| / |<...>|: the inner product is O(L^2) in magnitude, so an
    absolute measure would conflate reduction rounding with a genuine
    hermiticity violation."""
    n = D.shape[1]
    if stencil == "wilson":
        D = torch.einsum("sijxy,jk->sikxy", D, _g5(n, D))
    val = torch.sum(torch.conj(vec) * apply_D(D, vec))
    return val.imag.abs() / torch.clamp_min(val.abs(),
                                            torch.finfo(vec.real.dtype).tiny)


def test_gauge_invariance_solve(cfg: MGConfig, U, omega, max_iters=200):
    """Gauge invariance of the full MG solve (reference test program
    mgrid_test4_gauge_invariance.cpp; f_test_gauge_transform,
    6_ntl-mg_new_code/1_new_code/tests.h:171-215): solving D[U] phi = b
    and D[U'] phi' = Omega b with U'_mu(x) = Omega(x) U_mu(x)
    Omega(x+mu)^dagger must give phi' = Omega phi. U [2, L, L] and omega
    [L, L] are tensors on the solve's device. Returns
    max |phi' - Omega phi| after convergence."""
    from .models.operators import assemble
    from .models.gauge import gauge_transform
    from .solver.hierarchy import build_hierarchy, point_source
    from .solver.driver import solve

    D1 = assemble(cfg.stencil, U, cfg.m)
    D2 = assemble(cfg.stencil, gauge_transform(U, omega), cfg.m)
    b = point_source(cfg, device=U.device)
    h1 = build_hierarchy(D1, cfg, check=False)
    h2 = build_hierarchy(D2, cfg, check=False)
    out1 = solve(h1, b, cfg, max_iters=max_iters)
    out2 = solve(h2, omega[None] * b, cfg, max_iters=max_iters)
    if not (out1.converged and out2.converged):
        raise RuntimeError("gauge-invariance check: solves did not converge")
    return float((out2.phi - omega[None] * out1.phi).abs().max())


def _level_checks(vec, Dl, Df, pn, quad, cfg) -> list:
    bx, by = cfg.block_x, cfg.block_y
    return [test1_restriction_prolongation(pn, vec, quad, bx, by),
            test2_galerkin(Dl, Df, pn, vec, quad, bx, by),
            test3_hermiticity(Dl, cfg.stencil),
            test4_hermiticity_full(Dl, vec, cfg.stencil)]


def run_mg_tests(hier: Hierarchy, cfg: MGConfig,
                 generator: Optional[torch.Generator] = None) -> dict:
    """The pre-solve verification pass at every level and every NTL copy
    on random vectors (reference f_MG_tests, tests.h:250-295), with the
    JAX package's check names lvl{l}_test{k} and lvl{l}_ntl{q}_test{k}.

    The vectors, uniform(-pi, pi) in the real and imaginary parts, one per
    level (shared by its NTL copies), come from `generator` (default: a
    CPU generator seeded cfg.seed + 1). Returns {check_name: violation};
    all values should be below epsilon_for(cfg).
    """
    _pin_setup_precision()
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed + 1)
    device = hier.levels[0].D.device
    out = {}
    names = ("test1", "test2", "test3", "test4")

    def vec(n, S):
        u = torch.rand((2, n, S, S), generator=generator,
                       dtype=torch.float64, device=generator.device)
        u = (2.0 * u - 1.0) * math.pi
        return torch.complex(u[0], u[1]).to(device=device, dtype=cfg.cdtype)

    for lvl in range(cfg.nlevels + 1):
        v = vec(cfg.n_dof[lvl], cfg.sizes[lvl])
        lev = hier.levels[lvl]
        if cfg.ntl and lvl == cfg.nlevels:
            fine = hier.levels[lvl - 1]
            for q in range(cfg.n_copies):
                vals = _level_checks(v, hier.ntl.D[q], fine.D,
                                     hier.ntl.phi_null[q], q + 1, cfg)
                for t, x in zip(names, vals):
                    out[f"lvl{lvl}_ntl{q}_{t}"] = float(x)
        elif lvl > 0:
            fine = hier.levels[lvl - 1]
            vals = _level_checks(v, lev.D, fine.D, fine.phi_null, cfg.quad,
                                 cfg)
            for t, x in zip(names, vals):
                out[f"lvl{lvl}_{t}"] = float(x)
        else:
            out[f"lvl{lvl}_test3"] = float(test3_hermiticity(lev.D,
                                                             cfg.stencil))
            out[f"lvl{lvl}_test4"] = float(test4_hermiticity_full(
                lev.D, v, cfg.stencil))
    return out
