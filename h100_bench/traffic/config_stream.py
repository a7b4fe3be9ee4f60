"""Traffic kind `config_stream`: one gauge configuration at a time, as a
user of the reference program runs it: its operators assembled, its
hierarchy built by build_hierarchy (as tpu_multigrid_torch.cli calls it,
the near-null starts drawn on the host), then `solves` point sources at
one site, spin 0, 1, ..., each by one solve_ir call to the
configuration's res_threshold.

Parameters of a mix: `pool` configurations, drawn from the seed in
set-up and used in turn; `solves`, `value`, `inner_cycles`, `max_iters`,
`sample`, `relres_limit`, `profile_calls`, `outer_dtype` and `control` as
for rhs_stream (`sample` counts configurations).
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import torch

from h100_bench.harness import Reservoir
from h100_bench.reference import wilson
from h100_bench.traffic import rhs_stream
from h100_bench.work import model


def setup(ctx):
    p = ctx.params
    st = SimpleNamespace(ctx=ctx, pool=ctx.phases(p["pool"], "gauge"),
                         sites=ctx.rng("sites").integers(
                             0, ctx.cfg.L, size=(p["pool"], 2)),
                         kept=Reservoir(p["sample"], ctx.rng("sample")))
    one(st, ctx.phases(1, "warm-up")[0], (0, 0), ("warm-up",))
    return st


def one(st, phases, site, stream):
    """One configuration: (setup seconds, solve seconds, solutions,
    results), the card synchronized at each end."""
    ctx, p = st.ctx, st.ctx.params
    t0 = time.perf_counter()
    with torch.profiler.record_function("h100_bench.setup"):
        solve, cdtype, _ = rhs_stream.solver(ctx, wilson.links(phases),
                                             stream)
        ctx.sync()
    t1 = time.perf_counter()
    outs = []
    with torch.profiler.record_function("h100_bench.solve"):
        for spin in range(p["solves"]):
            b = wilson.point_source(ctx.cfg.L, site, spin, p["value"], cdtype,
                                    ctx.device)
            outs.append(solve(b))
        ctx.sync()
    return t1 - t0, time.perf_counter() - t1, outs


def call(st, i):
    ctx = st.ctx
    k = i % len(st.pool)
    site = tuple(int(v) for v in st.sites[k])
    t_setup, t_solve, outs = one(st, st.pool[k], site, ("config", i))
    st.kept.offer((k, site, [(o.phi, o.resmag) for o in outs]))
    work = model.setup(ctx.config["mgconfig"], ctx.config["cycle_dtype"])
    for o in outs:
        work += rhs_stream.work(ctx, o)
    return {"units": 1, "failed": int(not all(o.converged for o in outs)),
            "cycles": sum(o.iters for o in outs), "work": work,
            "spans": {"setup": t_setup, "solve": t_solve}}


def release(st):
    pass


def check(st):
    """{name: (value, limit)}: the largest relative residual, by the
    reference operator from each configuration's phases in complex128, of
    the sampled configurations' solutions."""
    p, cfg = st.ctx.params, st.ctx.cfg
    res, own = [], []
    for k, site, outs in st.kept.items:
        for spin, (phi, resmag) in enumerate(outs):
            b = wilson.point_source(cfg.L, site, spin, p["value"],
                                    torch.complex128, phi.device)
            res.append(float(wilson.relres(st.pool[k], cfg.m, phi, b)))
            own.append(resmag)
    rhs_stream.log_ratio(res, own)
    return {"relres_max": (rhs_stream.worst(res), p["relres_limit"])}
