"""Traffic kind `mesh_rhs`, for the tests of the launcher of cells on
several cards (test_h100_ranks.py writes it into a copy of the
benchmark, as traffic/mesh_rhs.py): the program's distributed path on a
`mesh` of every rank. Set-up: the gauge phases from the seed, the same
on every rank, the operator, `build_hierarchy_sharded`, and one solve.
A call: a point source at a site of the seed's, solved from zero by
`make_sharded_solver` (at most `max_iters` cycles) to the
configuration's res_threshold. The check, on rank 0: the plain
reference's relative residual of `sample` solutions, drawn from the
seed, against `relres_limit`.
"""
from types import SimpleNamespace

import torch
import torch.distributed as dist

from h100_bench.harness import Reservoir
from h100_bench.reference import wilson
from h100_bench.traffic.rhs_stream import worst


def setup(ctx):
    from tpu_multigrid_torch.parallel import multihost, setup as psetup
    from tpu_multigrid_torch.parallel import sharded
    p, cfg, mgt = ctx.params, ctx.cfg, ctx.mgt
    mesh = multihost.global_mesh(tuple(p["mesh"]), device=ctx.device)
    phases = ctx.phases(1, "gauge")[0]
    D = mgt.models.operators.assemble(
        cfg.stencil, wilson.links(phases, cfg.cdtype), cfg.m)
    hier = psetup.build_hierarchy_sharded(
        D, cfg, mesh, generator=ctx.generator("nearnull", device="cpu"))
    st = SimpleNamespace(
        ctx=ctx, phases=phases, hier=hier, rank=dist.get_rank(),
        solve=sharded.make_sharded_solver(cfg, mesh, p["max_iters"]),
        sites=ctx.rng("sources").integers(0, cfg.L, size=(p["pool"], 2)),
        kept=Reservoir(p["sample"], ctx.rng("sample")))
    solve(st, st.sites[-1])
    return st


def solve(st, site):
    ctx = st.ctx
    b = wilson.point_source(ctx.cfg.L, site, 0, ctx.params["value"],
                            ctx.cfg.cdtype, ctx.device)
    phis, iters, res = st.solve(st.hier, ctx.mgt.zero_fields(
        ctx.cfg, ctx.device), b)
    return b, phis[0], iters, res


def call(st, i):
    b, phi, iters, res = solve(st, st.sites[i % len(st.sites)])
    if st.rank == 0:
        st.kept.offer((b, phi))
    return {"units": 1, "failed": int(not res <= st.ctx.cfg.res_threshold),
            "cycles": iters, "work": []}


def release(st):
    st.hier = st.solve = None


def check(st):
    if st.rank != 0:
        return {}
    res = [float(wilson.relres(st.phases, st.ctx.cfg.m, phi, b))
           for b, phi in st.kept.items]
    return {"relres_max": (worst(res), st.ctx.params["relres_limit"])}
