"""Distributed adaptive setup: near-null generation, block
orthogonalization and Galerkin coarsening on tiles (counterpart of
tpu_multigrid/parallel/setup.py).

The single-device setup (solver/hierarchy.py) runs level by level; this
module runs the same pipeline with the fine lattice block-partitioned over
the mesh, so the setup scales to lattices that do not fit one card:

- near-null relaxation: halo-exchange smoother sweeps, all_reduced
  global norms;
- block normalization and Gram-Schmidt: the local tiles are
  block-aligned, so the per-block sums need no collective; only the
  quadrant roll exchanges a halo;
- Galerkin: per-direction triple products with halo-shifted Phi*, the
  face/interior splits local slices.

Levels below the shardability threshold gather to replicated and run the
port's single-device setup, as parallel/sharded.py does in the solve.
Each rank keeps only its part: the tiles of the sharded levels and the
replicated levels whole.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..config import MGConfig, SAME, XP, XM, YP, YM
from ..ops.nearnull import candidates_to_phi_null, random_starts
from ..ops.stencil import site_inverse
from ..ops.transfer import _blocked
from ..solver.hierarchy import (Hierarchy, LevelOps, NTLOps,
                                _pin_setup_precision, _setup_level, build_ntl)
from .halo import psum, shift_halo, smooth_sharded
from .sharded import (Mesh, _gather_lattice, _my_tile, _quad_roll_sharded,
                      shardable_levels)


def _block_frame(v, quad, bx, by, mesh):
    return _blocked(_quad_roll_sharded(v, quad, True, mesh), bx, by)


def _block_normalize_sharded(v, quad, bx, by, mesh: Mesh):
    vb = _block_frame(v, quad, bx, by, mesh)
    norms = torch.sqrt(torch.sum(vb.abs() ** 2, dim=(-5, -3, -1)))
    vb = vb / norms[..., None, :, None, :, None]
    return _quad_roll_sharded(vb.reshape(v.shape), quad, False, mesh)


def _block_dot_sharded(u, v, quad, bx, by, mesh: Mesh):
    ub = _block_frame(u, quad, bx, by, mesh)
    vb = _block_frame(v, quad, bx, by, mesh)
    return torch.einsum("...fXaYb,...fXaYb->...XY", torch.conj(ub), vb)


def _ortho_pass_sharded(phi_null, quad, bx, by, mesh: Mesh):
    """ops.transfer.ortho_pass on tiles."""
    nc = phi_null.shape[0]
    rows = [phi_null[d] for d in range(nc)]
    for d1 in range(nc):
        cur = rows[d1]
        for d2 in range(d1):
            prev = rows[d2]
            pb = _block_frame(prev, quad, bx, by, mesh)
            nrm = torch.sqrt(torch.sum(pb.abs() ** 2, dim=(-5, -3, -1)))
            coef = _block_dot_sharded(prev, cur, quad, bx, by, mesh) / nrm
            cb = _block_frame(cur, quad, bx, by, mesh)
            cb = cb - coef[None, :, None, :, None] * pb
            cur = _quad_roll_sharded(cb.reshape(cur.shape), quad, False, mesh)
        rows[d1] = _block_normalize_sharded(cur, quad, bx, by, mesh)
    return torch.stack(rows)


def _coarse_operator_sharded(D, phi_null, quad, bx, by, mesh: Mesh):
    """ops.galerkin.coarse_operator on tiles, with the neighbour Phi*
    halo-shifted."""
    P = _quad_roll_sharded(phi_null, quad, True, mesh)
    Db = _quad_roll_sharded(D, quad, True, mesh)
    Pc = torch.conj(P)

    def triple(d):
        Pn = Pc if d == SAME else shift_halo(Pc, d, mesh)
        half = torch.einsum("afxy,fgxy->agxy", P, Db[d])
        return _blocked(torch.einsum("agxy,bgxy->abxy", half, Pn), bx, by)

    M0, M1, M2, M3, M4 = (triple(d) for d in (SAME, XP, XM, YP, YM))

    def bsum(m):
        return torch.sum(m, dim=(3, 5))

    dc0 = (bsum(M0)
           + bsum(M1[:, :, :, :bx - 1])
           + bsum(M2[:, :, :, 1:])
           + bsum(M3[:, :, :, :, :, :by - 1])
           + bsum(M4[:, :, :, :, :, 1:]))
    dc1 = torch.sum(M1[:, :, :, bx - 1], dim=4)
    dc2 = torch.sum(M2[:, :, :, 0], dim=4)
    dc3 = torch.sum(M3[:, :, :, :, :, by - 1], dim=3)
    dc4 = torch.sum(M4[:, :, :, :, :, 0], dim=3)
    return torch.stack([dc0, dc1, dc2, dc3, dc4])


def _relax_null_sharded(D, D0inv, starts, cfg: MGConfig, mesh: Mesh):
    """ops.nearnull.relax_null_vectors on tiles: the k candidates relax as
    one batch by the halo smoother, each renormalized by its all_reduced
    global norm (one all_reduce for all k), or, with cfg.null_joint_qr,
    orthonormalized together by a modified Gram-Schmidt of all_reduced
    inner products."""
    zero = torch.zeros_like(starts[0])
    blocks = max(cfg.null_iters // cfg.iters_per_norm, 1)
    kind = cfg.smoother if cfg.smoother in ("jacobi", "rbgs") else "rbgs"

    def relax(v):
        return smooth_sharded(D, D0inv, v, zero, cfg.iters_per_norm, kind,
                              mesh, cfg.omega, overlap=cfg.halo_overlap)

    def norm(v):
        return torch.sqrt(psum(torch.sum(v.abs() ** 2), mesh))

    if not cfg.null_joint_qr:
        v = starts
        for _ in range(blocks):
            v = relax(v)
            n = torch.sqrt(psum(torch.sum(v.abs() ** 2, dim=(1, 2, 3)), mesh))
            v = v / n[:, None, None, None]
        return v

    def mgs(vs):
        out = []
        for v in vs:
            for u in out:
                v = v - u * psum(torch.sum(torch.conj(u) * v), mesh)
            n = norm(v)
            out.append(v / torch.where(n > 0, n, torch.ones_like(n)))
        return torch.stack(out)

    v = mgs(starts)
    for _ in range(blocks):
        v = mgs(relax(v))
    return v


def _build_ntl_sharded(base: LevelOps, cfg: MGConfig, mesh: Mesh) -> NTLOps:
    """solver.hierarchy.build_ntl on the tiles of a sharded level
    nlevels-1: the copies' near-null rows stay tiles, their coarse
    operators (the replicated coarsest level) are gathered."""
    bx, by = cfg.block_x, cfg.block_y
    nc = base.phi_null.shape[0]
    pns, Ds = [], []
    for q in range(cfg.n_copies):
        quad = q + 1
        pn = torch.stack([_block_normalize_sharded(base.phi_null[d], cfg.quad,
                                                   bx, by, mesh)
                          for d in range(nc)])
        for _ in range(cfg.ortho_passes):
            pn = _ortho_pass_sharded(pn, quad, bx, by, mesh)
        pns.append(pn)
        Ds.append(_gather_lattice(
            _coarse_operator_sharded(base.D, pn, quad, bx, by, mesh), mesh))
    Ds = torch.stack(Ds)
    return NTLOps(phi_null=torch.stack(pns), D=Ds,
                  D0inv=torch.stack([site_inverse(d[0]) for d in Ds]))


def build_hierarchy_sharded(D0: torch.Tensor, cfg: MGConfig, mesh: Mesh,
                            generator: Optional[torch.Generator] = None,
                            starts: Optional[Sequence] = None) -> Hierarchy:
    """Distributed solver.hierarchy.build_hierarchy. Returns this rank's
    part of the hierarchy (no links), on the mesh's device, in
    shard_hierarchy's layout: tiles at the sharded levels (and of the NTL
    copies' near-null rows where level nlevels-1 is sharded), the
    replicated levels and the NTL coarse operators whole. make_sharded_
    solver takes it as it is; gather_hierarchy gives the global one.

    D0: the global level-0 operator, on any device: only this rank's tile
    of it reaches the mesh's device. generator / starts as in
    build_hierarchy: the near-null starts are drawn on the generator's
    device for the whole lattice (the same draws as the single-device
    setup's), and only this rank's tile of them moves to the mesh's
    device; tests inject the JAX package's."""
    _pin_setup_precision()
    if generator is None and starts is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    sh = shardable_levels(cfg, mesh)
    bx, by = cfg.block_x, cfg.block_y

    def local(t, tiled):
        t = torch.as_tensor(t)
        return (_my_tile(t, mesh) if tiled else t).to(device=mesh.device,
                                                     dtype=cfg.cdtype)

    D = local(D0, sh[0])
    levels = []
    for lvl in range(cfg.nlevels):
        nf, nc, S = cfg.n_dof[lvl], cfg.n_dof[lvl + 1], cfg.sizes[lvl]
        if starts is not None:
            start = starts[lvl]
        else:
            k = nc // 2 if cfg.stencil == "wilson" else nc
            start = random_starts(generator, k, nf, S, torch.float64,
                                  generator.device)
        start = local(start, sh[lvl])
        if sh[lvl]:
            D0inv = site_inverse(D[0])
            vecs = _relax_null_sharded(D, D0inv, start, cfg, mesh)
            pn = candidates_to_phi_null(vecs, cfg.stencil, nc)
            pn = torch.stack([_block_normalize_sharded(pn[d], cfg.quad, bx,
                                                       by, mesh)
                              for d in range(nc)])
            for _ in range(cfg.ortho_passes):
                pn = _ortho_pass_sharded(pn, cfg.quad, bx, by, mesh)
            Dc = _coarse_operator_sharded(D, pn, cfg.quad, bx, by, mesh)
            if not sh[lvl + 1]:
                Dc = _gather_lattice(Dc, mesh)
        else:
            D0inv, pn, Dc = _setup_level(D, cfg, lvl, cfg.quad, start,
                                         check=False)
        levels.append(LevelOps(D=D, D0inv=D0inv, phi_null=pn))
        D = Dc
    levels.append(LevelOps(D=D, D0inv=site_inverse(D[0]), phi_null=None))
    ntl = None
    if cfg.ntl:
        ntl = (_build_ntl_sharded(levels[-2], cfg, mesh)
               if sh[cfg.nlevels - 1] else build_ntl(levels, cfg,
                                                     check=False))
    return Hierarchy(levels=tuple(levels), ntl=ntl)
