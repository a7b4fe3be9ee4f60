"""Traffic kind `ensemble_stream`: batches of `batch` distinct gauge
configurations, each batch set up in one pass by
build_hierarchies_batched (the near-null starts drawn on the host from
the seed) and solved by solve_ensemble for `n_cycles` fixed cycles on
the reference's point source (`value` at site (2, 2), spin 0).

Parameters of a mix: `pool` configurations, drawn from the seed in
set-up and taken `batch` at a time in turn; `fail_above`, the relative
residual (the program's own) above which a configuration counts as
failed; `sample` batches the reference judges; `median_limit` and
`claim_limit`, the limits of the two numbers `check` compares;
`profile_calls`; and `control`, which readings.py reads
(h100_bench/reference/control.py).
"""
from __future__ import annotations

import math
import statistics
import sys
import time
from types import SimpleNamespace

import torch

from h100_bench.harness import Reservoir
from h100_bench.reference import wilson
from h100_bench.traffic import rhs_stream
from h100_bench.work import model

SITE = (2, 2)


def setup(ctx):
    p = ctx.params
    if p["pool"] % p["batch"]:
        raise ValueError("the pool must hold whole batches")
    b = wilson.point_source(ctx.cfg.L, SITE, 0, p["value"], ctx.cfg.cdtype,
                            ctx.device)
    st = SimpleNamespace(ctx=ctx, pool=ctx.phases(p["pool"], "gauge"),
                         bs=b.expand(p["batch"], *b.shape).contiguous(),
                         kept=Reservoir(p["sample"], ctx.rng("sample")))
    one(st, ctx.phases(p["batch"], "warm-up"), ("warm-up",))
    return st


def one(st, phases, stream):
    """One batch: (setup seconds, solve seconds, phi, the program's
    residuals), the card synchronized at each end."""
    ctx, p, mgt = st.ctx, st.ctx.params, st.ctx.mgt
    t0 = time.perf_counter()
    with torch.profiler.record_function("h100_bench.setup"):
        Us = wilson.links(phases).to(ctx.cfg.cdtype)
        hier = mgt.build_hierarchies_batched(
            Us, ctx.cfg, generator=ctx.generator("nearnull", *stream,
                                                 device="cpu"))
        ctx.sync()
    t1 = time.perf_counter()
    with torch.profiler.record_function("h100_bench.solve"):
        phi, res = mgt.solve_ensemble(hier, st.bs, ctx.cfg,
                                      n_cycles=p["n_cycles"])
        ctx.sync()
    return t1 - t0, time.perf_counter() - t1, phi, res


def work(ctx, batch):
    cfg, dt, n = ctx.config["mgconfig"], ctx.config["cycle_dtype"], \
        ctx.params["n_cycles"]
    cycle = (model.ntl_cycle(cfg, dt, batch, ensemble=True)
             + model.level0_residual(cfg, dt, batch, ensemble=True))
    return model.setup(cfg, dt, batch) + [it.times(n) for it in cycle]


def call(st, i):
    p = st.ctx.params
    B = p["batch"]
    first = (i * B) % len(st.pool)
    t_setup, t_solve, phi, res = one(st, st.pool[first:first + B],
                                     ("batch", i))
    st.kept.offer((first, phi, res))
    failed = sum(1 for r in res if not (math.isfinite(r)
                                        and r <= p["fail_above"]))
    return {"units": B, "failed": failed, "work": work(st.ctx, B),
            "spans": {"setup": t_setup, "solve": t_solve}}


def release(st):
    pass


def check(st):
    """{name: (value, limit)}, over every configuration of the sampled
    batches, of the reference operator's relative residual of the
    program's solution (from each configuration's phases, complex128):
    its median, and the largest ratio of it to the residual the program
    reported. A fixed-cycle solve leaves a rare configuration near a zero
    mode above the median by far, and says so itself (`failed`): so the
    solutions are judged by what the program says of each, and the
    batch's convergence by the median (PERF.md, correctness)."""
    p, cfg = st.ctx.params, st.ctx.cfg
    B = p["batch"]
    res, own = [], []
    for first, phi, said in st.kept.items:
        res += [float(r) for r in wilson.relres(
            st.pool[first:first + B], cfg.m, phi, st.bs)]
        own += [float(r) for r in said]
    ratio = [a / b if b > 0 else math.inf for a, b in zip(res, own)]
    print(f"reference residual: largest {rhs_stream.worst(res)!r} over "
          f"{len(res)} configurations", file=sys.stderr)
    median = statistics.median(res) if res else math.inf
    return {"relres_median": (median if math.isfinite(median) else math.inf,
                              p["median_limit"]),
            "claim_ratio_max": (rhs_stream.worst(ratio), p["claim_limit"])}
