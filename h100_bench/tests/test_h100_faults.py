"""A whole run of each cell at a small size on the CPU (the harness's look
for a card skipped), sound and with the timed path broken underneath:
`correct` has to come out false for each fault the cell can have. One
card a cell, so no exchange between cards can be left out."""
import dataclasses

import pytest
import torch

import tpu_multigrid_torch as mgt
from h100_bench import faults, harness

from .helpers import SEED, small


def run(cell, **extra):
    return harness.run(cell, SEED, 0.05, False, "cpu",
                       overrides=small(cell, **extra), log=lambda *a: None)


@pytest.mark.parametrize("cell", ["flagship_rhs", "large_rhs",
                                  "flagship_configs", "ensemble8_stream"])
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
    assert list(r)[-1] == "checks"


def unchanged_solve(orig):
    """solve_ir whose steps return their state unchanged: the solution
    stays at its start, zero, and the solve claims convergence."""
    def solve_ir(hier, b, cfg, **kw):
        out = orig(hier, b, cfg, **kw)
        return dataclasses.replace(out, phi=torch.zeros_like(out.phi))
    return solve_ir


def altered_solve(orig):
    """solve_ir whose answer is altered where it is produced: one site of
    the solution off by a hundredth of its largest value."""
    def solve_ir(hier, b, cfg, **kw):
        out = orig(hier, b, cfg, **kw)
        phi = out.phi.clone()
        phi[0, 1, 1] += 1e-2 * phi.abs().max()
        return dataclasses.replace(out, phi=phi)
    return solve_ir


@pytest.mark.parametrize("cell", ["flagship_rhs", "large_rhs",
                                  "flagship_configs"])
@pytest.mark.parametrize("fault", [unchanged_solve, altered_solve])
def test_solve_faults_are_not_correct(monkeypatch, cell, fault):
    monkeypatch.setattr(mgt, "solve_ir", fault(mgt.solve_ir))
    assert not run(cell)["correct"]


@pytest.mark.parametrize("fault", ["half_batch", "unchanged_ensemble",
                                   "altered_ensemble"])
def test_ensemble_faults_are_not_correct(monkeypatch, fault):
    name, wrap = faults.FAULTS[fault]
    monkeypatch.setattr(mgt, name, wrap(getattr(mgt, name)))
    assert not run("ensemble8_stream")["correct"]


def test_setup_stopped_early_is_not_correct(monkeypatch):
    """The batched setup relaxes its near-null vectors by one smooth call
    in place of null_iters: its coarse levels correct little, and the
    cell's 18 cycles miss the limit (at 64^2, where a sound setup of 40
    sweeps meets it)."""
    size = {"mgconfig": {"L": 64, "nlevels": 2, "null_iters": 40},
            "n_cycles": 18}
    assert run("ensemble8_stream", **size)["correct"]
    name, wrap = faults.FAULTS["early_stop_setup"]
    monkeypatch.setattr(mgt, name, wrap(getattr(mgt, name)))
    r = run("ensemble8_stream", **size)
    assert not r["correct"], r["checks"]
