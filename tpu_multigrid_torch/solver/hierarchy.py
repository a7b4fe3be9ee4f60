"""Multigrid hierarchy: per-level operator tensors and the adaptive setup
that builds them (counterpart of tpu_multigrid/solver/hierarchy.py;
reference f_compute_near_null, modules_main.h:187-222).

Per level: near-null vectors (relax D x = 0) -> block-normalize ->
double Gram-Schmidt -> orthogonality check -> Galerkin coarse operator.
NTL: re-orthogonalize a copy of the next-to-coarsest level's near-nulls
in each blocking quadrant and build one coarse operator per copy.

The setup takes an optional leading configuration axis on D0 and the
starts (`_build_levels`): `build_hierarchy` is its case without one, and
solver.ensemble.build_hierarchies_batched sets up a batch of gauge
configurations in one pass, as the JAX package's vmapped setup
(_setup_level_core, _build_ntl_core), each smooth call one launch for
the batch.

Setup precision: float32 matmuls must run in full float32. The JAX
package pins HIGHEST matmul precision for ortho and Galerkin because
reduced-precision passes left the transfer rows orthonormal only to
~1e-2; here `_pin_setup_precision` turns TF32 off
(torch.backends.cuda.matmul.allow_tf32 = False) and sets
torch.set_float32_matmul_precision("highest") before every setup.

Spans (profiling.span): setup.nearnull around the near-null relaxation;
setup.coarsen around each site inverse, the rows' normalization and
ortho passes and the Galerkin product (each level and NTL copy);
setup.check around the host checks, each host read in them a
driver.read_back.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import profiling
from ..config import MGConfig
from ..ops.stencil import site_inverse
from ..ops.transfer import normalize_rows, ortho_pass, check_ortho, block_norms
from ..ops.galerkin import coarse_operator
from ..ops.nearnull import (relax_null_vectors, candidates_to_phi_null,
                            random_starts)

_NEARNULL = profiling.span("setup.nearnull")
_COARSEN = profiling.span("setup.coarsen")
_CHECK = profiling.span("setup.check")
_READ_BACK = profiling.span("driver.read_back")


@dataclasses.dataclass
class LevelOps:
    D: torch.Tensor                      # [5, n, n, S, S]
    D0inv: torch.Tensor                  # [n, n, S, S]
    phi_null: Optional[torch.Tensor]     # [nc, n, S, S] or None at coarsest


@dataclasses.dataclass
class NTLOps:
    """Per-quadrant-copy coarse-level data, stacked on a leading copy axis."""
    phi_null: torch.Tensor               # [n_copies, nc, nf, Sf, Sf]
    D: torch.Tensor                      # [n_copies, 5, nc, nc, Sc, Sc]
    D0inv: torch.Tensor                  # [n_copies, nc, nc, Sc, Sc]


@dataclasses.dataclass
class Hierarchy:
    levels: Tuple[LevelOps, ...]         # nlevels + 1 entries
    ntl: Optional[NTLOps]
    # U(1) links [2, L, L] for the level-0 links-only path (cfg.links)
    gauge: Optional[torch.Tensor] = None


def _pin_setup_precision() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _check_block_norms_host(phi_null, quad, bx, by, where: str):
    """Host-side NaN / tiny-norm guards (reference f_block_norm exit(1)
    guards, modules_indiv.h:119-126; f_check_null_norm, near_null.h:50-94)."""
    for d, row in enumerate(phi_null.unbind(-4)):
        with _READ_BACK:
            n = block_norms(row, quad, bx, by).cpu().numpy()
        if np.isnan(n).any():
            raise FloatingPointError(f"NaN block norm in {where}, row {d}")
        if (n < 1e-40).any():
            raise FloatingPointError(
                f"Tiny block norm ({n.min():.3e}) in {where}, row {d}")


def _ortho_tol(cfg: MGConfig) -> float:
    """Orthogonality bar: the reference's 1e-12-class guard presumes
    double; a healthy complex64 double Gram-Schmidt lands near 1e-7."""
    return 1e-10 if cfg.dtype == "complex128" else 1e-5


def _setup_level(D, cfg: MGConfig, lvl: int, quad: int, start=None,
                 phi_null_init=None, check: bool = True):
    """Near-null vectors (relaxed from `start`, or `phi_null_init` as
    given), their ortho passes and the Galerkin coarse operator. D [C?, 5,
    nf, nf, S, S] with start / phi_null_init [C?, k, nf, S, S]: C
    configurations at once; check=True checks every one of them."""
    nc = cfg.n_dof[lvl + 1]
    bx, by = cfg.block_x, cfg.block_y
    with _COARSEN:
        D0inv = site_inverse(D[..., 0, :, :, :, :])
    if phi_null_init is None:
        with _NEARNULL:
            kind = "rbgs" if cfg.smoother == "chebyshev" else cfg.smoother
            vecs = relax_null_vectors(D, D0inv, start, cfg.null_iters,
                                      cfg.iters_per_norm, kind, cfg.omega,
                                      cfg.null_joint_qr, pallas=cfg.pallas)
            phi_null = candidates_to_phi_null(vecs, cfg.stencil, nc)
    else:
        phi_null = phi_null_init
    with _COARSEN:
        phi_null = normalize_rows(phi_null, quad, bx, by)
        for _ in range(cfg.ortho_passes):
            phi_null = ortho_pass(phi_null, quad, bx, by)
        Dc = coarse_operator(D, phi_null, quad, bx, by)
    if check:
        with _CHECK:
            _check_block_norms_host(phi_null, quad, bx, by,
                                    f"level {lvl} norm")
            with _READ_BACK:
                worst = float(check_ortho(phi_null, quad, bx, by).max())
        if worst > _ortho_tol(cfg):
            raise FloatingPointError(
                f"near-null rows not orthogonal at level {lvl}: {worst:.3e}")
    return D0inv, phi_null, Dc


@profiling.span("build_hierarchy")
def build_hierarchy(D0: torch.Tensor, cfg: MGConfig,
                    generator: Optional[torch.Generator] = None,
                    phi_null_init: Optional[Sequence] = None,
                    check: bool = True, U=None,
                    starts: Optional[Sequence] = None) -> Hierarchy:
    """Construct the full MG hierarchy from the level-0 operator, on D0's
    device.

    generator: torch.Generator for the near-null random starts (default:
    a CPU generator seeded with cfg.seed). starts: per-level start stacks
    [k, nf, S, S] to use instead (tests inject the JAX package's).
    phi_null_init: per-level near-null stacks that skip generation.
    U: gauge links [2, L, L] kept on the hierarchy for the level-0
    links-only path (cfg.links).
    """
    if generator is None and starts is None and phi_null_init is None:
        generator = torch.Generator().manual_seed(cfg.seed)

    def start_of(lvl):
        if starts is not None:
            return starts[lvl]
        return random_starts(generator, _n_candidates(cfg, lvl),
                             cfg.n_dof[lvl], cfg.sizes[lvl], cfg.cdtype,
                             D0.device)

    levels, ntl = _build_levels(D0, cfg, start_of, phi_null_init, check)
    if U is not None:
        U = torch.as_tensor(U).to(device=D0.device, dtype=cfg.cdtype)
    return Hierarchy(levels=levels, ntl=ntl, gauge=U)


def _n_candidates(cfg: MGConfig, lvl: int) -> int:
    """Near-null candidates relaxed at level lvl: nc / 2 for Wilson (each
    split chirally into two rows), nc for Laplace."""
    nc = cfg.n_dof[lvl + 1]
    return nc // 2 if cfg.stencil == "wilson" else nc


def _build_levels(D0: torch.Tensor, cfg: MGConfig, start_of, phi_null_init,
                  check: bool):
    """(levels, ntl) of the setup from D0 [C?, 5, n, n, L, L] and, per
    level, the starts start_of(lvl) [C?, k, nf, S, S] or the near-null
    stacks phi_null_init [C?, nc, nf, S, S] (which skip generation), on
    D0's device; a leading configuration axis runs through every step.
    start_of is called as each level's setup begins, so that drawing the
    next level's starts on the host overlaps the card's work on this
    one."""
    _pin_setup_precision()
    device = D0.device
    levels = []
    D = D0
    for lvl in range(cfg.nlevels):
        init = start = None
        if phi_null_init is not None:
            init = torch.as_tensor(phi_null_init[lvl],
                                   device=device).to(cfg.cdtype)
        else:
            start = torch.as_tensor(start_of(lvl),
                                    device=device).to(cfg.cdtype)
        D0inv, phi_null, Dc = _setup_level(D, cfg, lvl, cfg.quad, start,
                                           init, check)
        levels.append(LevelOps(D=D, D0inv=D0inv, phi_null=phi_null))
        D = Dc
    with _COARSEN:
        D0inv = site_inverse(D[..., 0, :, :, :, :])
    levels.append(LevelOps(D=D, D0inv=D0inv, phi_null=None))
    ntl = build_ntl(levels, cfg, check) if cfg.ntl else None
    return tuple(levels), ntl


def build_ntl(levels, cfg: MGConfig, check: bool = True) -> NTLOps:
    """Per-quadrant re-setup of the coarsest transfer + operator
    (reference modules_main.h:208-221), each quadrant over every
    configuration of a leading axis at once; the copy axis follows it."""
    _pin_setup_precision()
    bx, by = cfg.block_x, cfg.block_y
    base = levels[cfg.nlevels - 1]
    pns, Ds, Dinvs, worsts = [], [], [], []
    for q in range(cfg.n_copies):
        quad = q + 1
        with _COARSEN:
            pn = normalize_rows(base.phi_null, cfg.quad, bx, by)
            for _ in range(cfg.ortho_passes):
                pn = ortho_pass(pn, quad, bx, by)
            Dc = coarse_operator(base.D, pn, quad, bx, by)
            pns.append(pn)
            Ds.append(Dc)
            Dinvs.append(site_inverse(Dc[..., 0, :, :, :, :]))
        if check:
            with _CHECK, _READ_BACK:
                worsts.append(float(check_ortho(pn, quad, bx, by).max()))
    if check and max(worsts) > _ortho_tol(cfg):
        raise FloatingPointError(f"NTL copies not orthogonal: {worsts}")
    return NTLOps(phi_null=torch.stack(pns, dim=-5),
                  D=torch.stack(Ds, dim=-6),
                  D0inv=torch.stack(Dinvs, dim=-5))


def cast_hierarchy(hier: Hierarchy, cdtype) -> Hierarchy:
    """Cast every operator tensor (D, D0inv, phi_null, NTL copies, links)
    to `cdtype`."""
    def c(t):
        return None if t is None else t.to(cdtype)

    levels = tuple(LevelOps(D=c(l.D), D0inv=c(l.D0inv),
                            phi_null=c(l.phi_null)) for l in hier.levels)
    ntl = None if hier.ntl is None else NTLOps(
        phi_null=c(hier.ntl.phi_null), D=c(hier.ntl.D),
        D0inv=c(hier.ntl.D0inv))
    return Hierarchy(levels=levels, ntl=ntl, gauge=c(hier.gauge))


def zero_fields(cfg: MGConfig, device=None,
                batch: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """Zero solution vectors, one per level; [batch, n, S, S] each for a
    batch of fields."""
    lead = () if batch is None else (batch,)
    return tuple(
        torch.zeros(lead + (cfg.n_dof[l], cfg.sizes[l], cfg.sizes[l]),
                    dtype=cfg.cdtype, device=device)
        for l in range(cfg.nlevels + 1))


def point_source(cfg: MGConfig, value: complex = 5.0,
                 site: Tuple[int, int] = (2, 2), device=None) -> torch.Tensor:
    """Reference source: value at site (x=2, y=2), dof 0 (level.h:55-59)."""
    r = torch.zeros((cfg.n_dof[0], cfg.L, cfg.L), dtype=cfg.cdtype,
                    device=device)
    r[0, site[0], site[1]] = value
    return r
