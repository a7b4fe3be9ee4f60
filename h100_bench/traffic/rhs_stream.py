"""Traffic kind `rhs_stream`: one gauge configuration, its hierarchy built
once in set-up, then a stream of point sources, each solved from zero by
one `solve_ir` call (complex64 cycles, complex128 defect correction) to
the configuration's res_threshold.

Every seed gets the same work in another basis. The gauge phases, the
near-null starts and the sources' sites are drawn from the mix's fixed
`instance`; the seed draws a gauge transformation g(s) = exp(i theta(s)),
which turns the links (U_mu(s) -> g(s) U_mu(s) conj(g(s + mu))) and the
level-0 starts (v(s) -> g(s) v(s)), and the order of the sources. The
operator becomes g D g^-1 and the coarse levels come out the same, so
every seed's solves take the same cycles, while its links, and so every
number the program and the reference read, differ from another seed's.
(Drawn from the seed itself, the configuration set the work: 21.7 to 28.5
cycles a solve over three seeds at L=256.)

Parameters of a mix: `instance`, the fixed stream of the configuration,
the starts and the sites; `pool` sources, pool // 2 sites, two a site
(spin 0, then spin 1: one propagator column pair), used in turn in an
order drawn from the seed; `value` of each source; `inner_cycles` and
`max_iters` of solve_ir; `sample` solutions the reference judges, a uniform sample of
the window's drawn from the seed; `relres_limit`, the limit on the
reference's relative residual; `profile_calls` traced calls;
`outer_dtype`, the defect correction's precision (default the
configuration's); and `control`, which readings.py reads: the overrides
that switch on the program's own lower-precision defect correction.
"""
from __future__ import annotations

import math
import sys
from types import SimpleNamespace

import torch

from h100_bench.harness import Reservoir
from h100_bench.reference import wilson
from h100_bench.work import model


def sources(ctx, pool: int):
    """[(x, y, spin)] of the mix: pool // 2 sites of the instance, spin 0
    then 1 each, the sites in an order drawn from the seed."""
    sites = ctx.rng("sources", seed=ctx.params["instance"]).integers(
        0, ctx.cfg.L, size=(pool // 2, 2))
    sites = sites[ctx.rng("order").permutation(len(sites))]
    return [(int(x), int(y), s) for x, y in sites for s in (0, 1)]


def gauge_transform(phases, theta):
    """The phases of g(s) U_mu(s) conj(g(s + mu)), g = exp(i theta), for
    phases [2, L, L] (direction, x, y) and theta [L, L]."""
    ahead = torch.stack([torch.roll(theta, -1, 0), torch.roll(theta, -1, 1)])
    return phases + theta - ahead


def near_null_starts(ctx, theta):
    """The near-null starts of each level [k, nf, S, S], drawn from the
    instance on the device: real uniform(-pi, pi), as the reference's
    f_init_near_null_vector(rand=1) (modules_indiv.h:51-68), k = nc / 2
    candidates (each split chirally into two rows); level 0's turned by
    exp(i theta)."""
    cfg = ctx.cfg
    g = ctx.generator("nearnull", seed=ctx.params["instance"])
    out = []
    for lvl in range(cfg.nlevels):
        S = cfg.sizes[lvl]
        u = torch.rand((cfg.n_dof[lvl + 1] // 2, cfg.n_dof[lvl], S, S),
                       generator=g, dtype=torch.float64, device=ctx.device)
        out.append((2.0 * u - 1.0) * math.pi)
    out[0] = out[0] * torch.polar(torch.ones_like(theta), theta)
    return out


def solver(ctx, U128, stream=(), starts=None):
    """(solve(b) -> SolveResult, the complex dtype of b, what the solve
    holds): solve_ir on a hierarchy built from U128's complex64 links,
    from the near-null `starts` or else starts drawn on the host from the
    seed's `stream` (as the program's cli draws them)."""
    mgt, cfg, p = ctx.mgt, ctx.cfg, ctx.params
    cyc = cfg.replace(dtype=ctx.config["cycle_dtype"])
    U = U128.to(cyc.cdtype)
    drawn = {"starts": starts} if starts is not None else {
        "generator": ctx.generator("nearnull", *stream, device="cpu")}
    hier = mgt.build_hierarchy(
        mgt.models.operators.assemble(cfg.stencil, U, cfg.m), cyc, U=U,
        **drawn)
    outer = cfg.replace(dtype=p.get("outer_dtype", cfg.dtype))
    D_outer = mgt.models.operators.assemble(cfg.stencil,
                                            U128.to(outer.cdtype), cfg.m)

    def solve(b):
        return mgt.solve_ir(hier, b, outer, inner_cycles=p["inner_cycles"],
                            max_iters=p["max_iters"], D_outer=D_outer)
    return solve, outer.cdtype, (hier, D_outer)


def work(ctx, out):
    """The stencil work of one solve: its cycles and outer steps."""
    cyc = ctx.config["mgconfig"]
    steps = len(out.history)
    return ([it.times(out.iters) for it in model.ntl_cycle(
        cyc, ctx.config["cycle_dtype"])]
        + [it.times(steps) for it in model.level0_residual(
            cyc, ctx.params.get("outer_dtype", ctx.cfg.dtype))])


def setup(ctx):
    p = ctx.params
    L = ctx.cfg.L
    theta = 2.0 * math.pi * torch.rand(
        (L, L), generator=ctx.generator("gauge transform"),
        dtype=torch.float64, device=ctx.device)
    phases = gauge_transform(
        ctx.phases(1, "gauge", seed=p["instance"])[0], theta)
    U128 = wilson.links(phases)
    solve, cdtype, held = solver(ctx, U128,
                                 starts=near_null_starts(ctx, theta))
    st = SimpleNamespace(ctx=ctx, phases=phases, solve=solve, cdtype=cdtype,
                         held=held, sources=sources(ctx, p["pool"]),
                         kept=Reservoir(p["sample"], ctx.rng("sample")))
    x, y = ctx.rng("warm-up").integers(0, ctx.cfg.L, size=2)
    solve(point(st, (int(x), int(y), 0)))
    return st


def point(st, src):
    L = st.ctx.cfg.L
    return wilson.point_source(L, src[:2], src[2], st.ctx.params["value"],
                               st.cdtype, st.ctx.device)


def call(st, i):
    src = st.sources[i % len(st.sources)]
    out = st.solve(point(st, src))
    st.kept.offer((src, out.phi, out.resmag))
    return {"units": 1, "failed": int(not out.converged),
            "cycles": out.iters, "work": work(st.ctx, out)}


def release(st):
    st.held = st.solve = None


def check(st):
    """{name: (value, limit)}: the largest relative residual, by the
    reference operator from the run's own phases in complex128, of the
    sampled solutions."""
    m, L, v = st.ctx.cfg.m, st.ctx.cfg.L, st.ctx.params["value"]
    res = [float(wilson.relres(st.phases, m, phi, wilson.point_source(
        L, src[:2], src[2], v, torch.complex128, phi.device)))
        for src, phi, _ in st.kept.items]
    log_ratio(res, [own for *_, own in st.kept.items])
    return {"relres_max": (worst(res), st.ctx.params["relres_limit"])}


def log_ratio(ref, own):
    """Print the range of the reference's relative residual over the
    program's own, over the judged solutions."""
    r = [a / b for a, b in zip(ref, own) if b > 0]
    if r:
        print(f"reference / program residual: {min(r)!r} .. {max(r)!r} "
              f"over {len(r)} solutions", file=sys.stderr)


def worst(values) -> float:
    """The largest of the values, inf if one is not finite."""
    return max((v if math.isfinite(v) else math.inf for v in values),
               default=math.inf)
