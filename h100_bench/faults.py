"""Faults planted under the timed path, each a wrapper of one entry point
of the program: the tests and readings.py (`--fault`) put one in place
to see the comparison that decides `correct` catch it."""
from __future__ import annotations

import torch


def wrong_config_setup(orig):
    """build_hierarchies_batched whose setup of entry 0 runs on entry 1's
    configuration: entry 0 keeps its own fine operator, but its near-null
    vectors, coarse operators and NTL copies are another
    configuration's (a batched setup that mixes up its entries)."""
    def build_hierarchies_batched(Us, cfg, **kw):
        good = orig(Us, cfg, **kw)
        swapped = Us.clone()
        swapped[0] = Us[1]
        bad = orig(swapped, cfg, **kw)
        bad.levels[0].D[0] = good.levels[0].D[0]
        bad.levels[0].D0inv[0] = good.levels[0].D0inv[0]
        return bad
    return build_hierarchies_batched


def early_stop_setup(orig):
    """build_hierarchies_batched whose near-null vectors are relaxed by one
    smooth call of iters_per_norm sweeps in place of null_iters: a setup
    that stops early, and so poor near-null vectors."""
    def build_hierarchies_batched(Us, cfg, **kw):
        return orig(Us, cfg.replace(null_iters=cfg.iters_per_norm), **kw)
    return build_hierarchies_batched


def half_batch(orig):
    """solve_ensemble that leaves out half of the batch and gives it the
    mean of the rest's solutions."""
    def solve_ensemble(hier, bs, cfg, n_cycles, **kw):
        half = bs.shape[0] // 2
        from tpu_multigrid_torch.solver import ensemble
        sub = ensemble.unstack_hierarchy
        phis = [orig(ensemble.stack_hierarchies(
            [sub(hier, i) for i in range(half)]), bs[:half], cfg,
            n_cycles)[0]]
        mean = phis[0].mean(dim=0, keepdim=True)
        phi = torch.cat(phis + [mean.expand(bs.shape[0] - half,
                                            *mean.shape[1:])])
        return phi, [0.0] * bs.shape[0]
    return solve_ensemble


def unchanged_ensemble(orig):
    """solve_ensemble whose cycles return their state unchanged: every
    solution stays at its start, zero; the residuals reported are the
    sound ones."""
    def solve_ensemble(hier, bs, cfg, n_cycles, **kw):
        phi, res = orig(hier, bs, cfg, n_cycles)
        return torch.zeros_like(phi), res
    return solve_ensemble


def altered_ensemble(orig):
    """solve_ensemble whose answer is altered where it is produced: one
    site of the last configuration's solution off by a hundredth of its
    largest value."""
    def solve_ensemble(hier, bs, cfg, n_cycles, **kw):
        phi, res = orig(hier, bs, cfg, n_cycles)
        phi = phi.clone()
        phi[-1, 0, 3, 3] += 1e-2 * phi[-1].abs().max()
        return phi, res
    return solve_ensemble


# name: (the program entry point it wraps, the wrapper)
FAULTS = {"wrong_config_setup": ("build_hierarchies_batched",
                                 wrong_config_setup),
          "early_stop_setup": ("build_hierarchies_batched",
                               early_stop_setup),
          "half_batch": ("solve_ensemble", half_batch),
          "unchanged_ensemble": ("solve_ensemble", unchanged_ensemble),
          "altered_ensemble": ("solve_ensemble", altered_ensemble)}
