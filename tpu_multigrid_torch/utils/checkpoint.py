"""Checkpoint / resume of the solver state (counterpart of the npz path of
tpu_multigrid/utils/checkpoint.py; SURVEY.md §5.4).

The reference checkpoints only the near-null vectors (gen_null=0/1, see
utils/io.py) and gauge fields. This module adds full solver state —
hierarchy, solution vectors and iteration counter in one npz — so a long
solve resumes after preemption. The keys and the `__meta__` JSON are the
JAX package's, so a state file written by either package loads in the
other.
"""
from __future__ import annotations

import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .. import profiling
from ..config import MGConfig
from ..solver.hierarchy import Hierarchy, LevelOps, NTLOps, zero_fields
from .io import host


def save_solver_state(path: str, cfg: MGConfig, hier: Hierarchy, phis,
                      it: int, resmag: float):
    arrs = {}
    for l, lev in enumerate(hier.levels):
        arrs[f"D_{l}"] = host(lev.D)
        arrs[f"D0inv_{l}"] = host(lev.D0inv)
        if lev.phi_null is not None:
            arrs[f"phi_null_{l}"] = host(lev.phi_null)
    if hier.ntl is not None:
        arrs["ntl_phi_null"] = host(hier.ntl.phi_null)
        arrs["ntl_D"] = host(hier.ntl.D)
        arrs["ntl_D0inv"] = host(hier.ntl.D0inv)
    if hier.gauge is not None:
        arrs["gauge_U"] = host(hier.gauge)
    for l, p in enumerate(phis):
        arrs[f"phi_{l}"] = host(p)
    meta = {"iter": it, "resmag": resmag, "nlevels": cfg.nlevels,
            "cfg": {f: getattr(cfg, f) for f in
                    ("L", "stencil", "m", "nlevels", "block_x", "block_y",
                     "num_iters", "smoother", "ntl", "n_copies", "dtype")}}
    np.savez_compressed(path, __meta__=json.dumps(meta), **arrs)


def load_solver_state(path: str, cfg: MGConfig, device=None
                      ) -> Tuple[Hierarchy, tuple, int, float]:
    """(hierarchy, phis, iteration, resmag) from `path`, each tensor in
    its stored dtype on `device`."""
    def t(a):
        return torch.from_numpy(np.array(a)).to(device)

    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        if meta["cfg"]["L"] != cfg.L or meta["cfg"]["stencil"] != cfg.stencil:
            raise ValueError("checkpoint config mismatch: "
                             f"{meta['cfg']} vs current")
        levels = []
        for l in range(cfg.nlevels + 1):
            pn = (t(z[f"phi_null_{l}"]) if f"phi_null_{l}" in z.files
                  else None)
            levels.append(LevelOps(D=t(z[f"D_{l}"]), D0inv=t(z[f"D0inv_{l}"]),
                                   phi_null=pn))
        ntl = None
        if "ntl_D" in z.files:
            ntl = NTLOps(phi_null=t(z["ntl_phi_null"]), D=t(z["ntl_D"]),
                         D0inv=t(z["ntl_D0inv"]))
        phis = tuple(t(z[f"phi_{l}"]) for l in range(cfg.nlevels + 1))
        gauge = t(z["gauge_U"]) if "gauge_U" in z.files else None
    return (Hierarchy(levels=tuple(levels), ntl=ntl, gauge=gauge), phis,
            int(meta["iter"]), float(meta["resmag"]))


@profiling.span("solve_resumable")
def solve_resumable(hier, b, cfg: MGConfig, path: str,
                    checkpoint_every: int = 50,
                    max_iters: Optional[int] = None):
    """Chunked solve that checkpoints every `checkpoint_every` cycles and
    resumes from `path` if it exists (the stored hierarchy then replaces
    `hier`); one program a chunk (utils.compile.CapturedChunk)."""
    from ..ops.stencil import residual_norm_ratio
    from ..solver.cycles import cycle
    from ..solver.driver import READ_BACK, SolveResult, _stop
    from .compile import CapturedChunk

    max_iters = max_iters or cfg.max_iters
    it, resmag = 0, float("inf")
    phis = zero_fields(cfg, b.device)
    if os.path.exists(path):
        hier, phis, it, resmag = load_solver_state(path, cfg, b.device)
    prog = CapturedChunk(*phis)

    def body(*phis):
        for _ in range(checkpoint_every):
            phis, _ = cycle(hier, phis, b, cfg)
        return phis, residual_norm_ratio(hier.levels[0].D, phis[0], b)

    while it < max_iters:
        rel = prog("chunk", body)
        with READ_BACK:
            resmag = float(rel)
        it += checkpoint_every
        save_solver_state(path, cfg, hier, prog.state, it, resmag)
        if _stop(resmag, cfg):
            break
    prog.close()
    return SolveResult(phi=prog.state[0], iters=it, resmag=resmag,
                       converged=resmag < cfg.res_threshold)
