"""Distributed multigrid: the full (NTL-)V-cycle solver as one SPMD
program over a 2D mesh of ranks (counterpart of
tpu_multigrid/parallel/sharded.py).

Where the JAX package runs one controller over a device mesh with
`shard_map`, each rank here is a process (torchrun, or
torch.multiprocessing) holding its own tiles:

- Fine levels are block-partitioned over the mesh axes ('x', 'y'); every
  stencil op exchanges a width-1 halo (parallel.halo).
- Coarse levels below the shardability threshold are replicated: the
  restricted residual is all_gathered once per transition, and every rank
  runs the same coarse solve through the port's own ops (ops.dispatch.
  smooth: the dense_update kernel on the card) until prolongation cuts the
  local tile back out.
- The NTL quadrant copies run at the replicated coarsest level: below
  n_copies ranks as one batch on every rank, else one copy a rank and a
  one-hot all_reduce; the min-res Gram matrix is all_reduced.
- The while_loop becomes a host loop: the all_reduced residual is the
  same on every rank, so every rank takes the same branch.

The tile levels run plain torch; the replicated levels run the kernels.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..config import MGConfig, XP, XM, YP, YM
from ..ops import dispatch, transfer
from ..ops.stencil import norm_ratio
from ..solver.cycles import min_res_weights
from ..solver.hierarchy import Hierarchy, LevelOps, NTLOps
from .halo import (all_gather, apply_D_sharded, psum,
                   residual_norm_ratio_sharded, residual_sharded, roll_halo,
                   smooth_sharded)

_AXIS_OF = {XP: 0, XM: 0, YP: 1, YM: 1}
_SIGN_OF = {XP: 1, XM: -1, YP: 1, YM: -1}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An (mx, my) mesh of the ranks of a process group: rank r holds the
    tile at mesh coordinates (ix, iy) = divmod(r, my), the row-major order
    of JAX's `np.asarray(devices).reshape(shape)`. Its tensors live on
    `device`; `group` None is the default group."""
    shape: Tuple[int, int]
    device: torch.device
    rank: int
    backend: str
    group: Optional[object] = None

    @property
    def size(self) -> int:
        return self.shape[0] * self.shape[1]

    @property
    def coords(self) -> Tuple[int, int]:
        return divmod(self.rank, self.shape[1])

    def axis_size(self, d: int) -> int:
        """Ranks along the mesh axis of lattice direction d."""
        return self.shape[_AXIS_OF[d]]

    def peer(self, ix: int, iy: int) -> int:
        """Global rank of the rank at mesh coordinates (ix, iy)."""
        r = (ix % self.shape[0]) * self.shape[1] + iy % self.shape[1]
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                 r)

    def neighbour(self, d: int, sign: int) -> int:
        """Global rank one step in lattice direction d (sign 1) or against
        it (sign -1)."""
        ix, iy = self.coords
        s = sign * _SIGN_OF[d]
        return self.peer(ix + s, iy) if _AXIS_OF[d] == 0 \
            else self.peer(ix, iy + s)


def make_mesh(shape, device=None, group=None) -> Mesh:
    """The (mx, my) mesh over the ranks of `group` (default: the default
    group), which must have mx * my ranks; a 1-axis shape (n,) is (n, 1).
    device: where this rank's tensors live (default: the current CUDA
    device with NCCL, the CPU with gloo); a CUDA device is refused on a
    gloo group and the CPU on an NCCL one."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "parallel.multihost.initialize first")
    shape = tuple(int(s) for s in shape) + (1,) * (2 - len(shape))
    world = dist.get_world_size(group)
    if shape[0] * shape[1] != world:
        raise ValueError(f"mesh {shape} needs {shape[0] * shape[1]} ranks; "
                         f"the group has {world}")
    backend = dist.get_backend(group)
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if backend == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if (device.type == "cuda") != (backend == "nccl"):
        raise ValueError(f"tensors on {device} cannot go through {backend}: "
                         "NCCL for CUDA tensors, gloo for CPU ones")
    return Mesh(shape=shape, device=device, rank=dist.get_rank(group),
                backend=backend, group=group)


def shardable_levels(cfg: MGConfig, mesh: Mesh) -> Tuple[bool, ...]:
    """Level l is sharded iff the local tile is block-aligned and even.
    Once a level is replicated all coarser levels are too."""
    mx, my = mesh.shape
    out = []
    ok = True
    for l in range(cfg.nlevels + 1):
        S = cfg.sizes[l]
        lx, ly = S // mx, S // my
        ok = (ok and S % mx == 0 and S % my == 0
              and lx % 2 == 0 and ly % 2 == 0
              and lx % cfg.block_x == 0 and ly % cfg.block_y == 0
              and l < cfg.nlevels)       # coarsest level always replicated
        out.append(ok)
    return tuple(out)


# --- sharded <-> replicated transitions -----------------------------------

def _gather_lattice(v, mesh: Mesh):
    """Local tile [.., lx, ly] -> the full lattice, on every rank."""
    parts = all_gather(v, mesh)
    my = mesh.shape[1]
    rows = [torch.cat(parts[ix * my:(ix + 1) * my], dim=-1)
            for ix in range(mesh.shape[0])]
    return torch.cat(rows, dim=-2)


def _my_tile(v, mesh: Mesh):
    """This rank's tile of a replicated lattice tensor, contiguous."""
    mx, my = mesh.shape
    lx, ly = v.shape[-2] // mx, v.shape[-1] // my
    ix, iy = mesh.coords
    return v[..., ix * lx:(ix + 1) * lx, iy * ly:(iy + 1) * ly].contiguous()


def shard_hierarchy(hier: Hierarchy, cfg: MGConfig, mesh: Mesh) -> Hierarchy:
    """This rank's part of a global hierarchy, on the mesh's device: the
    tiles of the sharded levels (and of the NTL copies' near-null rows
    where level nlevels-1 is sharded); the replicated levels and the NTL
    coarse operators whole. The links are dropped: the sharded cycle runs
    the dense level 0."""
    sh = shardable_levels(cfg, mesh)

    def put(t, tiled):
        if t is None:
            return None
        t = t.to(mesh.device)
        return _my_tile(t, mesh) if tiled else t

    levels = tuple(LevelOps(D=put(lev.D, sh[l]), D0inv=put(lev.D0inv, sh[l]),
                            phi_null=put(lev.phi_null, sh[l]))
                   for l, lev in enumerate(hier.levels))
    ntl = None
    if hier.ntl is not None:
        ntl = NTLOps(phi_null=put(hier.ntl.phi_null, sh[cfg.nlevels - 1]),
                     D=put(hier.ntl.D, False),
                     D0inv=put(hier.ntl.D0inv, False))
    return Hierarchy(levels=levels, ntl=ntl)


def gather_hierarchy(hier: Hierarchy, cfg: MGConfig, mesh: Mesh) -> Hierarchy:
    """This rank's part of a hierarchy (shard_hierarchy's layout) -> the
    global hierarchy, on every rank: the inverse of shard_hierarchy."""
    sh = shardable_levels(cfg, mesh)

    def get(t, tiled):
        return _gather_lattice(t, mesh) if tiled and t is not None else t

    levels = tuple(LevelOps(D=get(lev.D, sh[l]), D0inv=get(lev.D0inv, sh[l]),
                            phi_null=get(lev.phi_null, sh[l]))
                   for l, lev in enumerate(hier.levels))
    ntl = None
    if hier.ntl is not None:
        ntl = NTLOps(phi_null=get(hier.ntl.phi_null, sh[cfg.nlevels - 1]),
                     D=hier.ntl.D, D0inv=hier.ntl.D0inv)
    return Hierarchy(levels=levels, ntl=ntl)


def shard_fields(phis, cfg: MGConfig, mesh: Mesh):
    """Global per-level fields -> this rank's (tiles at sharded levels)."""
    sh = shardable_levels(cfg, mesh)
    return tuple(_my_tile(p.to(mesh.device), mesh) if sh[l]
                 else p.to(mesh.device) for l, p in enumerate(phis))


def gather_fields(phis, cfg: MGConfig, mesh: Mesh):
    """This rank's per-level fields -> the global ones, on every rank."""
    sh = shardable_levels(cfg, mesh)
    return tuple(_gather_lattice(p, mesh) if sh[l] else p
                 for l, p in enumerate(phis))


# --- transfers on sharded levels ------------------------------------------

def _quad_roll_sharded(v, quad, fwd: bool, mesh: Mesh):
    ox, oy = transfer.QUAD_OFFSETS[quad]
    sx, sy = (-ox, -oy) if fwd else (ox, oy)
    if sx:
        v = roll_halo(v, sx, -2, mesh)
    if sy:
        v = roll_halo(v, sy, -1, mesh)
    return v


def _restrict_sharded(phi_null, vf, quad, bx, by, mesh: Mesh):
    """Both fields are local tiles; the quadrant roll crosses tile
    boundaries by halo exchange, the blocking is then tile-local."""
    pb = transfer._blocked(_quad_roll_sharded(phi_null, quad, True, mesh),
                           bx, by)
    vb = transfer._blocked(_quad_roll_sharded(vf, quad, True, mesh), bx, by)
    return torch.einsum("cfXaYb,fXaYb->cXY", pb, vb).contiguous()


def _prolong_sharded(phi_null, vc, quad, bx, by, mesh: Mesh):
    pb = transfer._blocked(_quad_roll_sharded(phi_null, quad, True, mesh),
                           bx, by)
    vfb = torch.einsum("cfXaYb,cXY->fXaYb", torch.conj(pb), vc)
    vf = vfb.reshape(vfb.shape[0], phi_null.shape[-2], phi_null.shape[-1])
    return _quad_roll_sharded(vf, quad, False, mesh).contiguous()


# --- the sharded cycle -----------------------------------------------------

def effective_smoother(cfg: MGConfig, warn: bool = False) -> str:
    """The smoother the distributed cycle actually runs.

    gs_lex (a host-sequential ordering) is single-device by nature: the
    distributed cycle maps it to rbgs, the parallel ordering with the same
    smoothing factor, so the iteration trajectory differs from the
    single-device run. jacobi, rbgs and chebyshev run natively sharded
    (chebyshev's intervals are config constants, so only the apply's
    halos communicate)."""
    if cfg.smoother in ("jacobi", "rbgs", "chebyshev"):
        return cfg.smoother
    if warn:
        warnings.warn(
            f"sharded cycle downgrades smoother '{cfg.smoother}' to 'rbgs' "
            f"(same smoothing factor, different iteration trajectory)",
            stacklevel=3)
    return "rbgs"


def _cheby_interval(cfg: MGConfig, lvl: int):
    return (cfg.cheby_intervals[lvl]
            if effective_smoother(cfg) == "chebyshev" else None)


def _relax(lev, phi, r, cfg: MGConfig, sharded: bool, lvl: int, mesh: Mesh):
    kind = effective_smoother(cfg)
    ci = _cheby_interval(cfg, lvl)
    if sharded:
        return smooth_sharded(lev.D, lev.D0inv, phi, r, cfg.num_iters, kind,
                              mesh, cfg.omega, cheby_interval=ci,
                              overlap=cfg.halo_overlap)
    return dispatch.smooth(lev.D, lev.D0inv, phi, r, cfg.num_iters, kind,
                           cfg.omega, cfg.pallas, ci)


def _min_res_weights_sharded(D_f, r_f, xs_list, cfg: MGConfig, mesh: Mesh):
    """cycles.min_res_weights on tiles: the Gram matrix and the source as
    partial sums, reduced in one all_reduce."""
    nq = len(xs_list)
    Dx = [apply_D_sharded(D_f, x, mesh, cfg.halo_overlap) for x in xs_list]
    A = torch.stack([torch.stack([torch.sum(torch.conj(xs_list[p]) * Dx[q])
                                  for q in range(nq)]) for p in range(nq)])
    mode = cfg.minres_src
    if mode == "auto":
        mode = "r_dot_dx" if cfg.stencil == "wilson" else "x_dot_r"
    if mode == "x_dot_r":
        src = torch.stack([torch.sum(torch.conj(x) * r_f) for x in xs_list])
    else:
        src = torch.stack([torch.sum(torch.conj(r_f) * d) for d in Dx])
    both = psum(torch.cat([A.reshape(-1), src]), mesh)
    # unchecked, as cycles.min_res_weights: a singular system gives
    # non-finite weights, as in JAX
    return torch.linalg.solve_ex(both[:nq * nq].reshape(nq, nq),
                                 both[nq * nq:]).result


def _ntl_coarse_solves_submesh(ntl, r_q, phi_shape, cfg: MGConfig,
                               mesh: Mesh):
    """The n_copies independent coarse solves spread over the ranks: rank
    r relaxes only copy r mod n_copies, and the copy stack is reassembled
    by a one-hot all_reduce divided by the ranks per copy. With >=
    n_copies ranks each rank relaxes one copy instead of n_copies."""
    nq = cfg.n_copies
    my_copy = mesh.rank % nq
    phi_me = dispatch.smooth(ntl.D[my_copy], ntl.D0inv[my_copy],
                             torch.zeros(phi_shape, dtype=r_q[my_copy].dtype,
                                         device=mesh.device),
                             r_q[my_copy], cfg.num_iters,
                             effective_smoother(cfg), cfg.omega, cfg.pallas,
                             _cheby_interval(cfg, cfg.nlevels))
    counts = torch.tensor([max(1, len([d for d in range(mesh.size)
                                       if d % nq == q])) for q in range(nq)],
                          dtype=phi_me.dtype, device=mesh.device)
    contrib = torch.zeros((nq,) + tuple(phi_me.shape), dtype=phi_me.dtype,
                          device=mesh.device)
    contrib[my_copy] = phi_me
    return psum(contrib, mesh) / counts[:, None, None, None]


def make_sharded_cycle(cfg: MGConfig, mesh: Mesh):
    """cycle_fn(hier, phis, b) -> (phis, resmag) on this rank's part of the
    hierarchy and fields (build_hierarchy_sharded or shard_hierarchy,
    shard_fields); every rank of the mesh calls it together."""
    effective_smoother(cfg, warn=True)   # surface any smoother downgrade once
    sh = shardable_levels(cfg, mesh)
    n = cfg.nlevels
    bx, by = cfg.block_x, cfg.block_y
    ov = cfg.halo_overlap

    def relax(lev, phi, r, l):
        return _relax(lev, phi, r, cfg, sh[l], l, mesh)

    def residual_of(lev, phi, r, l):
        return (residual_sharded(lev.D, phi, r, mesh, ov) if sh[l]
                else dispatch.residual(lev.D, phi, r, cfg.pallas))

    def restrict_step(pn, res, quad, l):
        """Level-l residual restricted to level l+1, gathered where level
        l+1 is replicated."""
        if sh[l]:
            rc = _restrict_sharded(pn, res, quad, bx, by, mesh)
            return rc if sh[l + 1] else _gather_lattice(rc, mesh)
        return dispatch.restrict(pn, res, quad, bx, by)

    def prolong_step(pn, vc, quad, l):
        """Level-(l+1) correction prolonged to level l."""
        if sh[l]:
            if not sh[l + 1]:
                vc = _my_tile(vc, mesh)
            return _prolong_sharded(pn, vc, quad, bx, by, mesh)
        return dispatch.prolong(pn, vc, quad, bx, by)

    def cycle_fn(hier: Hierarchy, phis, b):
        L = hier.levels
        phis = list(phis)
        rs = [b] + [None] * n
        ntl_on = cfg.ntl and n > 0
        down_end = (n - 1) if ntl_on else n

        for l in range(down_end):
            phis[l] = relax(L[l], phis[l], rs[l], l)
            res = residual_of(L[l], phis[l], rs[l], l)
            rs[l + 1] = restrict_step(L[l].phi_null, res, cfg.quad, l)
            phis[l + 1] = torch.zeros_like(phis[l + 1])

        if ntl_on:
            l = n - 1
            phis[l] = relax(L[l], phis[l], rs[l], l)
            res = residual_of(L[l], phis[l], rs[l], l)
            nq = cfg.n_copies
            r_q = [restrict_step(hier.ntl.phi_null[q], res, q + 1, l)
                   for q in range(nq)]
            if mesh.size >= nq:
                # the copies spread over the ranks
                phi_q = _ntl_coarse_solves_submesh(
                    hier.ntl, r_q, phis[n].shape, cfg, mesh)
            else:
                # every copy on every rank, smoothed as one batch
                r_q = torch.stack(r_q)
                phi_q = dispatch.smooth(hier.ntl.D[:nq], hier.ntl.D0inv[:nq],
                                        torch.zeros_like(r_q), r_q,
                                        cfg.num_iters, effective_smoother(cfg),
                                        cfg.omega, cfg.pallas,
                                        _cheby_interval(cfg, n))
            combine = cfg.ntl_combine
            if combine == "auto":
                combine = "minres" if cfg.min_res else "avg_prolong"
            if combine == "avg_coarse":
                # gen-2 single-interpolation variant (see solver.cycles)
                corr = prolong_step(hier.ntl.phi_null[cfg.quad - 1],
                                    phi_q.mean(dim=0), cfg.quad, l)
            else:
                xs = [prolong_step(hier.ntl.phi_null[q], phi_q[q], q + 1, l)
                      for q in range(nq)]
                if combine == "minres":
                    if sh[l]:
                        a = _min_res_weights_sharded(L[l].D, rs[l], xs, cfg,
                                                     mesh)
                    else:
                        a = min_res_weights(L[l].D, rs[l], torch.stack(xs),
                                            cfg)
                else:
                    a = torch.full((nq,), 1.0 / nq, dtype=b.dtype,
                                   device=b.device)
                corr = sum(a[q] * xs[q] for q in range(nq))
            phis[l] = phis[l] + corr
            up_start = n - 1
        else:
            up_start = n

        for l in range(up_start, -1, -1):
            phis[l] = relax(L[l], phis[l], rs[l], l)
            if l > 0:
                corr = prolong_step(L[l - 1].phi_null, phis[l], cfg.quad,
                                    l - 1)
                phis[l - 1] = phis[l - 1] + corr
                phis[l] = torch.zeros_like(phis[l])

        if sh[0]:
            resmag = residual_norm_ratio_sharded(L[0].D, phis[0], b, mesh, ov)
        else:
            resmag = norm_ratio(dispatch.residual(L[0].D, phis[0], b,
                                                  cfg.pallas), b)
        return tuple(phis), resmag

    return cycle_fn


def make_sharded_solver(cfg: MGConfig, mesh: Mesh, max_iters: int):
    """The distributed solve: solver(hier, phis, b) -> (phis, iters, res)
    with hier this rank's part (build_hierarchy_sharded or
    shard_hierarchy) and phis, b the global
    fields, as the JAX package's solver takes them; the returned phis are
    global too, on every rank. Cycles while iters < max_iters and
    res_threshold < res < div_threshold, one host read of the all_reduced
    residual a cycle."""
    cycle_fn = make_sharded_cycle(cfg, mesh)

    def solver(hier: Hierarchy, phis, b):
        phis = shard_fields(phis, cfg, mesh)
        b = shard_fields((b,), cfg, mesh)[0]
        it, res = 0, 1.0
        while it < max_iters and cfg.res_threshold < res < cfg.div_threshold:
            phis, res_t = cycle_fn(hier, phis, b)
            res = float(res_t)
            it += 1
        return gather_fields(phis, cfg, mesh), it, res

    return solver

