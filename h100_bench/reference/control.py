"""The control of the complex64 ensemble: the reference put in the
program's place and computed in bfloat16, the precision below the one
the configuration states. A minimal-residual iteration on the reference
operator whose links, fields and every intermediate are rounded to
bfloat16 (real and imaginary parts; the arithmetic of one operation in
float32, as a bfloat16 tensor core accumulates), run until it stagnates.

A mix names it under `control` as {"patch": "bf16_ensemble", ...};
readings.py puts the replacements that `bf16_ensemble` returns in place
of the program's entry points (the benchmark's own runs never do)."""
from __future__ import annotations

import torch

from . import wilson

DIMS = (-3, -2, -1)


def bf16(z: torch.Tensor) -> torch.Tensor:
    """z rounded to bfloat16 parts, held as complex64."""
    return torch.complex(z.real.to(torch.bfloat16).to(torch.float32),
                         z.imag.to(torch.bfloat16).to(torch.float32))


def norms(z: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(z.abs() ** 2, dim=DIMS))


def mr_solve_bf16(U: torch.Tensor, m: float, b: torch.Tensor,
                  max_iters: int, check_every: int, patience: int):
    """(x, steps): minimal-residual steps x += a r, r -= a D r from x = 0,
    a = <D r, r> / <D r, D r> a field, every value in bfloat16. Every
    `check_every` steps the residual is recomputed from x (in bfloat16)
    and put in place of the updated one; the iteration stops once no
    field's recomputed residual has fallen below 0.99 of its least for
    `patience` checks running (it has stagnated), or at max_iters."""
    U = bf16(U.to(torch.complex64))
    b = bf16(b.to(torch.complex64))
    x, r = torch.zeros_like(b), b
    best, stale, step = None, 0, 0
    while step < max_iters and stale < patience:
        step += 1
        Ar = bf16(wilson.apply(U, m, r))
        a = bf16(torch.sum(torch.conj(Ar) * r, dim=DIMS, keepdim=True)
                 / torch.sum(torch.conj(Ar) * Ar, dim=DIMS, keepdim=True))
        x = bf16(x + bf16(a * r))
        r = bf16(r - bf16(a * Ar))
        if step % check_every == 0:
            r = bf16(b - bf16(wilson.apply(U, m, x)))
            n = norms(r)
            if best is not None and not bool((n < 0.99 * best).any()):
                stale += 1
            else:
                stale = 0
            best = n if best is None else torch.minimum(best, n)
    return x, step


def bf16_ensemble(params: dict) -> dict:
    """{name of a program entry point: its replacement}: the batched setup
    keeps the benchmark's links (complex64, from its own phases) and does
    nothing else; the fixed-cycle solve is mr_solve_bf16 with the mix's
    `max_iters`, `check_every` and `patience`, and returns the residuals
    as the program does, a numpy array a configuration."""
    def build_hierarchies_batched(Us, cfg, **kw):
        return Us

    def solve_ensemble(Us, bs, cfg, n_cycles, **kw):
        x, steps = mr_solve_bf16(Us, cfg.m, bs, params["max_iters"],
                                 params["check_every"], params["patience"])
        r = bs.to(torch.complex128) - wilson.apply(
            Us.to(torch.complex128), cfg.m, x.to(torch.complex128))
        return x, (norms(r) / norms(bs.to(torch.complex128))).cpu().numpy()

    return {"build_hierarchies_batched": build_hierarchies_batched,
            "solve_ensemble": solve_ensemble}


PATCHES = {"bf16_ensemble": bf16_ensemble}
