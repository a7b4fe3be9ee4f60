"""Outer solve drivers (counterpart of tpu_multigrid/solver/driver.py;
reference f_perform_MG, modules_main.h:442-481): iterate MG cycles until
the relative level-0 residual drops below cfg.res_threshold, stopping on
divergence (> cfg.div_threshold) or a non-finite residual.

`solve_ir` reaches the reference's 1e-13 from a complex64 hierarchy by
mixed-precision iterative refinement; `solve_fmg` starts the cycles from
the full-multigrid guess; `solve_with_history` records the residual and
the NTL weights of every cycle (and the reference's results files through
a utils.io.ResultsWriter); `solve_batched` runs a batch of right-hand sides
through one hierarchy for a fixed number of cycles; `mr_solve` is the
unpreconditioned baseline.

Each driver runs its chunk of work as one device program, as the JAX
package's drivers do (utils.compile.CapturedChunk): on CUDA tensors a
CUDA graph captured once a call (solve_ir's once a hierarchy and key)
and replayed, the host reading back one scalar (or one small vector) a
chunk; on CPU tensors the same body runs eagerly. Each driver is a root
span (profiling.span), and each host read (a chunk's result, the norm of
a right-hand side) a driver.read_back span inside it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from .. import profiling
from ..config import MGConfig
from ..ops import dispatch
from ..utils.compile import REUSE, CapturedChunk, run_steps
from .cycles import cycle, fmg_init, residual_norm_ratio0
from .hierarchy import Hierarchy, cast_hierarchy, zero_fields

# Cycles in one program of `solve` (its host reads the stop flag once
# every SOLVE_BLOCK cycles).
SOLVE_BLOCK = 10
# Steps in one program of the Krylov iterations (mr_iterate,
# krylov.cgnr_solve); a chunk of more replays it.
KRYLOV_BLOCK = 50

# every host read of the drivers and the setup's checks
READ_BACK = profiling.span("driver.read_back")


@dataclasses.dataclass
class SolveResult:
    phi: torch.Tensor        # level-0 solution, on the solve's device
    iters: int
    resmag: float
    converged: bool
    # residual per recorded step; one entry per `history_stride` cycles
    # (stride 1 except solve_ir, which records once per host check of
    # `inner_cycles` * `outer_chunk` cycles)
    history: Optional[np.ndarray] = None
    history_stride: int = 1
    ntl_weights: Optional[np.ndarray] = None      # [iters, n_copies]
    level_residuals: Optional[list] = None


def _stop(resmag: float, cfg: MGConfig) -> bool:
    return (resmag < cfg.res_threshold or resmag > cfg.div_threshold
            or not math.isfinite(resmag))


def _cycles_then_check(hier: Hierarchy, b, cfg: MGConfig, n: int):
    """The body of n cycles on the level fields, then the level-0 check
    residual_norm_ratio0 (JAX's run_chunk)."""
    def body(*phis):
        for _ in range(n):
            phis, _ = cycle(hier, phis, b, cfg)
        return phis, residual_norm_ratio0(hier, phis[0], b, cfg)
    return body


@profiling.span("solve")
def solve(hier: Hierarchy, b: torch.Tensor, cfg: MGConfig,
          phis0=None, max_iters: Optional[int] = None) -> SolveResult:
    """Cycle until converged: the JAX package's while_loop, which checks
    the residual after every cycle. One program runs SOLVE_BLOCK cycles,
    each followed by its check and a stop flag on the device (the
    residual not in (res_threshold, div_threshold), NaN included, or
    max_iters cycles run); once the flag is set, the fields, the count
    and the residual stay as they were, as a finished while_loop leaves
    them. The host reads the flag once a program."""
    max_iters = max_iters or cfg.max_iters
    phis = phis0 if phis0 is not None else zero_fields(cfg, b.device)
    thr, div = cfg.res_threshold, cfg.div_threshold
    if not (0 < max_iters and thr < 1.0 < div):
        return SolveResult(phi=phis[0], iters=0, resmag=1.0,
                           converged=1.0 < thr)
    prog = CapturedChunk(
        *phis, torch.zeros((), dtype=torch.int64, device=b.device),
        torch.ones((), dtype=b.real.dtype, device=b.device),
        torch.zeros((), dtype=torch.bool, device=b.device))

    def cycles(n):
        def body(*state):
            *phis, it, res, done = state
            for _ in range(n):
                new, _ = cycle(hier, tuple(phis), b, cfg)
                r = residual_norm_ratio0(hier, new[0], b, cfg)
                live = ~done
                phis = [torch.where(live, p, q) for p, q in zip(new, phis)]
                res = torch.where(live, r, res)
                it = it + live.to(it.dtype)
                done = ~((it < max_iters) & (res > thr) & (res < div))
            return (*phis, it, res, done), done
        return body

    while True:
        done = prog("block", cycles(SOLVE_BLOCK), cycles(1))
        with READ_BACK:
            if bool(done):
                break
    *phis, it, res, _ = prog.state
    with READ_BACK:
        resmag, iters = float(res), int(it)
    prog.close()
    return SolveResult(phi=phis[0], iters=iters, resmag=resmag,
                       converged=resmag < thr)


@profiling.span("solve_chunked")
def solve_chunked(hier: Hierarchy, b: torch.Tensor, cfg: MGConfig,
                  phis0=None, max_iters: Optional[int] = None,
                  chunk: int = 10) -> SolveResult:
    """Run `chunk` cycles between host convergence checks (the iteration
    count is reported at chunk granularity, as in the JAX package): one
    program a chunk, its check included."""
    max_iters = max_iters or cfg.max_iters
    phis = phis0 if phis0 is not None else zero_fields(cfg, b.device)
    prog = CapturedChunk(*phis)
    body = _cycles_then_check(hier, b, cfg, chunk)
    it = 0
    resmag = float("inf")
    while it < max_iters:
        rel = prog("chunk", body)
        with READ_BACK:
            resmag = float(rel)
        it += chunk
        if _stop(resmag, cfg):
            break
    prog.close()
    return SolveResult(phi=prog.state[0], iters=it, resmag=resmag,
                       converged=resmag < cfg.res_threshold)


def solve_fmg(hier: Hierarchy, b: torch.Tensor, cfg: MGConfig,
              n_vcycles: int = 1, max_iters: Optional[int] = None,
              chunk: int = 10) -> SolveResult:
    """Full-multigrid solve: the FMG initial guess (cycles.fmg_init), then
    solve_chunked. The reported `iters` counts the FMG sweep as one
    cycle."""
    phis0 = fmg_init(hier, b, cfg, n_vcycles)
    out = solve_chunked(hier, b, cfg, phis0=phis0, max_iters=max_iters,
                        chunk=chunk)
    return dataclasses.replace(out, iters=out.iters + 1)


@dataclasses.dataclass(eq=False)
class _IrProgram:
    """solve_ir's program for one hierarchy: its outer step captured on the
    state (phi, r, b, |b|), and what it was made for: `held`, compared by
    identity (the D_outer argument and the hierarchy's fields, held so
    that no id is reused), and `key`, compared by value. It holds no
    reference to the hierarchy object, so that it dies with it."""
    held: tuple
    key: tuple
    chunk: CapturedChunk
    step: Callable


# the attribute of a Hierarchy that holds its solve_ir program
_KEPT = "_solve_ir_program"


def release_kept(hier: Hierarchy) -> None:
    """Release the solve_ir program kept on `hier` (its graph's memory goes
    back to the pool); the next solve_ir call on it captures anew."""
    prog = hier.__dict__.pop(_KEPT, None)
    if prog is not None:
        prog.chunk.close()


def _kept_program(hier: Hierarchy, held: tuple, key: tuple, make):
    """(program, kept): the solve_ir program kept on `hier` where it was
    made for `held` and `key`; else make()'s, kept on `hier` in place of
    the one there (released)."""
    prog = hier.__dict__.get(_KEPT)
    if (prog is not None and prog.key == key
            and all(a is b for a, b in zip(prog.held, held))):
        return prog, True
    release_kept(hier)
    prog = make()
    setattr(hier, _KEPT, prog)
    return prog, False


def _ir_step(hier_in: Hierarchy, D_outer, cfg: MGConfig, cfg_in: MGConfig,
             inner_cycles: int):
    """The body of one outer step of solve_ir on (phi, r, b, |b|)."""
    def step(phi, r, b, bn):
        rn = torch.sqrt(torch.sum(r.abs() ** 2))
        safe = torch.where(rn > 0, rn, torch.ones_like(rn))
        r_in = (r / safe).to(cfg_in.cdtype)
        es = zero_fields(cfg_in, b.device)
        for _ in range(inner_cycles):
            es, _ = cycle(hier_in, es, r_in, cfg_in)
        phi = phi + safe * es[0].to(phi.dtype)
        r = dispatch.residual(D_outer, phi, b, cfg.pallas)
        return (phi, r, b, bn), torch.sqrt(torch.sum(r.abs() ** 2)) / bn
    return step


@profiling.span("solve_ir")
def solve_ir(hier: Hierarchy, b: torch.Tensor, cfg: MGConfig,
             inner_cycles: int = 2, max_iters: Optional[int] = None,
             inner_dtype: str = "complex64", D_outer=None,
             outer_chunk: int = 1) -> SolveResult:
    """Mixed-precision iterative refinement (defect correction).

    The outer loop runs in cfg.dtype (complex128 for the reference's 1e-13
    criterion): r = b - D_outer phi and the update are exact. Each outer
    step runs `inner_cycles` MG cycles in `inner_dtype` on the normalized
    defect D e = r / |r| (in complex64 on the hand kernels), so the true
    residual contracts by the inner cycles' factor per step.

    The hierarchy may be built in cfg.dtype (its inner view is a cast) or
    directly in `inner_dtype`, with the exact level-0 operator passed as
    `D_outer` (converted to cfg.dtype on b's device; default: the
    hierarchy's level-0 D). The outer residual is dispatch.residual. One
    program is one outer step (its cycles, the update, the
    outer residual and its norm); the host reads the residual back every
    `outer_chunk` outer steps; history holds one entry per read-back, with
    history_stride = inner_cycles * outer_chunk.

    The program is kept with the hierarchy, as the JAX package compiles it
    once a process: a call with the same D_outer object, cfg,
    inner_cycles, inner_dtype and b's shape, dtype and device on the same
    hierarchy loads b into its buffers and replays (a chunk.reuse span);
    another captures anew, in place of the one kept. The inner view of
    the hierarchy and the converted D_outer are kept with it. The program
    dies with the hierarchy (or at release_kept). The returned phi is a
    copy, which later calls leave as it is.
    """
    max_iters = max_iters or cfg.max_iters
    phi = torch.zeros((cfg.n_dof[0], cfg.L, cfg.L), dtype=cfg.cdtype,
                      device=b.device)
    bn = torch.sqrt(torch.sum(b.abs() ** 2))

    def make():
        cfg_in = cfg.replace(dtype=inner_dtype)
        D = hier.levels[0].D if D_outer is None else D_outer
        if not isinstance(D, torch.Tensor):
            D = torch.from_numpy(np.array(D))
        D = D.to(device=b.device, dtype=cfg.cdtype)
        step = _ir_step(cast_hierarchy(hier, cfg_in.cdtype), D, cfg, cfg_in,
                        inner_cycles)
        return _IrProgram(held, key, CapturedChunk(phi, b, b, bn), step)

    held = (D_outer, hier.levels, hier.ntl, hier.gauge)
    key = (cfg, inner_cycles, inner_dtype, b.shape, b.dtype, b.device)
    prog, kept = _kept_program(hier, held, key, make)
    if kept:
        with REUSE:
            prog.chunk.load(phi, b, b, bn)

    history = []
    resmag = float("inf")
    outer = 0
    while outer * inner_cycles < max_iters:
        for _ in range(outer_chunk):
            rel = prog.chunk("step", prog.step)
        outer += outer_chunk
        with READ_BACK:
            resmag = float(rel)
        history.append(resmag)
        if _stop(resmag, cfg):
            break
    prog.chunk.report_warm_ups()
    return SolveResult(phi=prog.chunk.state[0].clone(),
                       iters=outer * inner_cycles, resmag=resmag,
                       converged=resmag < cfg.res_threshold,
                       history=np.asarray(history),
                       history_stride=inner_cycles * outer_chunk)


@profiling.span("solve_with_history")
def solve_with_history(hier: Hierarchy, b: torch.Tensor, cfg: MGConfig,
                       phis0=None, max_iters: Optional[int] = None,
                       writer=None) -> SolveResult:
    """Cycle until converged, recording the relative residual and the NTL
    weights of every cycle; `writer` (utils.io.ResultsWriter, the
    reference's per-iteration output surface) records cycles 1,
    1 + write_interval, ... One program a cycle, its check and its
    weights included; the read-back and the writer stay on the host, as
    in the JAX package's history mode."""
    max_iters = max_iters or cfg.max_iters
    phis = phis0 if phis0 is not None else zero_fields(cfg, b.device)
    prog = CapturedChunk(*phis)

    def body(*phis):
        phis, a = cycle(hier, phis, b, cfg)
        return phis, (residual_norm_ratio0(hier, phis[0], b, cfg), a)

    history, weights = [], []
    resmag = float("inf")
    it = 0
    for it in range(1, max_iters + 1):
        res, a = prog("cycle", body)
        with READ_BACK:
            resmag = float(res)
            weights.append(a.cpu().numpy())
        history.append(resmag)
        if writer is not None and (it - 1) % cfg.write_interval == 0:
            writer.record(it, hier, prog.state, b, weights[-1])
        if _stop(resmag, cfg):
            break
    prog.close()
    return SolveResult(phi=prog.state[0], iters=it, resmag=resmag,
                       converged=resmag < cfg.res_threshold,
                       history=np.asarray(history),
                       ntl_weights=np.asarray(weights))


@profiling.span("solve_batched")
def solve_batched(hier: Hierarchy, bs: torch.Tensor, cfg: MGConfig,
                  n_cycles: int):
    """Batched multi-RHS solve (counterpart of the JAX package's
    solve_batched, which vmaps the whole fixed-cycle solve over a leading
    right-hand-side axis): bs [batch, n, L, L] through `n_cycles` cycles on
    the one hierarchy, each kernel call covering the whole batch in one
    launch (the level-0 links kernels with the links shared when the
    hierarchy carries them). No per-RHS early exit, as in JAX. The
    hierarchy may itself carry the batch axis (one per right-hand side:
    solver.ensemble.solve_ensemble).

    One program of a cycle and the per-RHS check, replayed n_cycles times
    (the last check is returned): capturing a cycle costs the host about
    what running it eagerly does, so a program of all the cycles, replayed
    once, would save nothing.

    Returns (phi [batch, n, L, L] on bs's device, the per-RHS relative
    residuals as a numpy array)."""
    prog = CapturedChunk(*zero_fields(cfg, bs.device, batch=bs.shape[0]))
    res = run_steps(prog, n_cycles, 1,
                    lambda n: _cycles_then_check(hier, bs, cfg, n))
    with READ_BACK:
        res = res.cpu().numpy()
    prog.close()
    return prog.state[0], res


@profiling.span("mr_solve")
def mr_solve(D, b, tol: float = 1e-8, max_iters: int = 100000,
             chunk: int = 1000):
    """Unpreconditioned minimal-residual iteration — the baseline the MG
    solve must beat by >= 5x in cycle count (BASELINE.json north star).

    x_{k+1} = x_k + alpha r_k with alpha = <D r, r> / <D r, D r>, alpha
    and the norm in the field's dtype. `chunk` steps run between host
    convergence checks, so the count keeps the JAX package's chunk
    granularity. D r is dispatch.apply_D: the SpMV kernel on CUDA
    tensors, the plain version on CPU ones. Returns (x, iters, relres),
    x a tensor on b's device.
    """
    return mr_iterate(lambda v: dispatch.apply_D(D, v), b, b, tol,
                      max_iters, chunk)


def mr_iterate(op, r, b, tol: float, max_iters: int, chunk: int):
    """Minimal-residual steps x += alpha r, r -= alpha op(r) from x = 0 and
    residual r, alpha = <op r, r> / <op r, op r> in the field's dtype;
    `chunk` steps between host checks of ||r|| / ||b||, as programs of
    KRYLOV_BLOCK steps and one of the rest. Returns (x, iters, rel)."""
    with READ_BACK:
        bn = float(torch.sqrt(torch.sum(b.abs() ** 2)))
    prog = CapturedChunk(torch.zeros_like(r), r)

    def steps(n):
        def body(x, r):
            for _ in range(n):
                Ar = op(r)
                alpha = (torch.sum(torch.conj(Ar) * r)
                         / torch.sum(torch.conj(Ar) * Ar))
                x = x + alpha * r
                r = r - alpha * Ar
            return (x, r), torch.sqrt(torch.sum(r.abs() ** 2))
        return body

    it = 0
    rel = 1.0
    while it < max_iters:
        rn = run_steps(prog, chunk, KRYLOV_BLOCK, steps)
        it += chunk
        with READ_BACK:
            rel = float(rn) / bn
        if rel < tol or not math.isfinite(rel):
            break
    prog.close()
    return prog.state[0], it, rel
