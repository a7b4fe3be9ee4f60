"""Ensemble workflows: setup and solve over a batch of gauge
configurations (counterpart of tpu_multigrid/solver/ensemble.py).

Lattice field theorists solve the same system on many gauge
configurations. The JAX package vmaps the whole pipeline over a leading
configuration axis. Here the setup is one batched pass over that axis
(hierarchy._build_levels, the JAX package's per-level setup without the
host checks): each smooth call of the near-null relaxation is one
dense_update launch for every configuration's candidates, each group of
candidates on its configuration's operator, and the transfers and
Galerkin products are einsums over the batch. The solve then runs every
configuration through each cycle together: each smoother kernel launch
covers the whole batch, each configuration with its own operators. The
hierarchies carry no gauge, as in JAX, so level 0 runs the dense kernels.

`mesh=` shards the batch over the ranks of a parallel.sharded.Mesh (pure
data parallelism: each rank solves its own configurations, then one
all_gather returns the whole ensemble to every rank).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .. import profiling
from ..config import MGConfig
from ..models.operators import assemble
from ..ops.nearnull import random_starts
from .driver import READ_BACK, solve_batched
from .hierarchy import (Hierarchy, LevelOps, NTLOps, _build_levels,
                        _n_candidates)


def _stack(ts):
    return None if ts[0] is None else torch.stack(ts)


def stack_hierarchies(hiers: Sequence[Hierarchy]) -> Hierarchy:
    """One Hierarchy whose tensors carry a leading batch axis, from
    hierarchies of the same config (their gauges are dropped)."""
    levels = tuple(
        LevelOps(D=_stack([h.levels[l].D for h in hiers]),
                 D0inv=_stack([h.levels[l].D0inv for h in hiers]),
                 phi_null=_stack([h.levels[l].phi_null for h in hiers]))
        for l in range(len(hiers[0].levels)))
    ntl = None
    if hiers[0].ntl is not None:
        ntl = NTLOps(phi_null=_stack([h.ntl.phi_null for h in hiers]),
                     D=_stack([h.ntl.D for h in hiers]),
                     D0inv=_stack([h.ntl.D0inv for h in hiers]))
    return Hierarchy(levels=levels, ntl=ntl)


def unstack_hierarchy(hier_b: Hierarchy, i: int) -> Hierarchy:
    """Configuration i's own Hierarchy, views of a batched one's tensors."""
    def one(t):
        return None if t is None else t[i]

    levels = tuple(LevelOps(D=one(l.D), D0inv=one(l.D0inv),
                            phi_null=one(l.phi_null)) for l in hier_b.levels)
    ntl = None
    if hier_b.ntl is not None:
        ntl = NTLOps(phi_null=one(hier_b.ntl.phi_null), D=one(hier_b.ntl.D),
                     D0inv=one(hier_b.ntl.D0inv))
    return Hierarchy(levels=levels, ntl=ntl)


@profiling.span("build_hierarchies_batched")
def build_hierarchies_batched(Us: torch.Tensor, cfg: MGConfig,
                              generator: Optional[torch.Generator] = None,
                              starts: Optional[Sequence] = None) -> Hierarchy:
    """Batched adaptive setup: Us [batch, 2, L, L] -> a Hierarchy whose
    tensors carry a leading batch axis (no gauge), on Us's device.

    generator: torch.Generator of the near-null random starts (default: a
    CPU generator seeded with cfg.seed), drawn level by level, one per
    configuration; starts: per-level start stacks [batch, k, nf, S, S] to
    use instead (tests inject the JAX package's). The setup runs once for
    the whole batch with no host checks, as JAX's vmapped setup."""
    batch, device = Us.shape[0], Us.device
    if starts is None and generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)

    def start_of(lvl):
        if starts is not None:
            return starts[lvl]
        return torch.stack([
            random_starts(generator, _n_candidates(cfg, lvl), cfg.n_dof[lvl],
                          cfg.sizes[lvl], cfg.cdtype, device)
            for _ in range(batch)])

    levels, ntl = _build_levels(assemble(cfg.stencil, Us, cfg.m), cfg,
                                start_of, None, check=False)
    return Hierarchy(levels=levels, ntl=ntl)


@profiling.span("solve_ensemble")
def solve_ensemble(hier_b: Hierarchy, bs: torch.Tensor, cfg: MGConfig,
                   n_cycles: int, mesh=None):
    """Fixed-cycle MG solve of a batch of hierarchies and right-hand sides
    bs [batch, n, L, L] (configuration i solves bs[i]), all in each cycle.
    Returns (phi [batch, n, L, L] on bs's device, the per-configuration
    relative residuals as a numpy array).

    mesh: a parallel.sharded.Mesh whose ranks call this together, each
    with the whole batch: rank r solves its batch / mesh.size
    configurations (shard_ensemble; no collective in the cycles), and the
    results are all_gathered, so every rank returns the whole ensemble,
    on the mesh's device. batch must divide by the mesh's size."""
    if mesh is None:
        return solve_batched(hier_b, bs, cfg, n_cycles)
    from ..parallel.halo import all_gather
    batch = bs.shape[0]
    if batch % mesh.size:
        raise ValueError(
            f"mesh size {mesh.size} must evenly divide ensemble batch "
            f"{batch} (shard_ensemble would otherwise leave configurations "
            "out or solve them twice)")
    hier_b, bs = shard_ensemble((hier_b, bs), mesh, batch=batch)
    phi, res = solve_batched(hier_b, bs, cfg, n_cycles)
    res = torch.as_tensor(res, device=mesh.device)
    phi = torch.cat(all_gather(phi, mesh))
    with READ_BACK:
        res = torch.cat(all_gather(res, mesh)).cpu().numpy()
    return phi, res


def _tree_map(fn, x):
    """fn on every tensor of a tree of tensors, tuples, lists and
    dataclasses (a Hierarchy)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _tree_map(fn, getattr(x, f.name))
            for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, y) for y in x)
    return x


def shard_ensemble(tree, mesh, batch=None):
    """This rank's part of every tensor of `tree`, on the mesh's device:
    rank r keeps slice r of mesh.size equal slices of a tensor's leading
    (configuration) axis; other tensors are kept whole.

    batch: when given, only tensors whose leading dim EQUALS the batch
    size are cut (a non-batch leading axis that merely divides the rank
    count must not be split across configurations); else every tensor
    whose leading dim divides by the rank count."""
    n = mesh.size

    def part(x):
        x = x.to(mesh.device)
        lead = x.shape[0] if x.dim() >= 1 else 0
        cut = (lead == batch) if batch is not None else lead > 0
        if cut and lead % n == 0:
            k = lead // n
            return x[mesh.rank * k:(mesh.rank + 1) * k]
        return x

    return _tree_map(part, tree)
