"""The controls, at a size a CPU test holds, switched on as readings.py
switches them on: the program's own complex64 defect correction for the
complex128 cells (the mix's overrides), and for the complex64 ensemble
the reference's bfloat16 minimal-residual solve, run to stagnation, in
the program's place. Each has to come out not correct."""
import pytest

import tpu_multigrid_torch as mgt
from h100_bench import harness, readings

from .helpers import SEED, small


def control_run(monkeypatch, cell, **extra):
    overrides, repl = readings.switched_on(cell, "control")
    for k, v in repl.items():
        monkeypatch.setattr(mgt, k, v)
    return harness.run(cell, SEED, 0.05, False, "cpu",
                       overrides=small(cell, **(overrides or {}), **extra),
                       log=lambda *a: None)


@pytest.mark.parametrize("cell", ["flagship_rhs", "large_rhs",
                                  "flagship_configs"])
def test_lower_precision_defect_correction_is_not_correct(monkeypatch,
                                                          cell):
    r = control_run(monkeypatch, cell, max_iters=40)
    c = r["checks"]["relres_max"]
    assert not r["correct"]
    assert c["value"] > 3 * c["limit"]


def test_bf16_reference_is_not_correct(monkeypatch):
    from h100_bench.reference import control
    stopped = []
    orig = control.mr_solve_bf16

    def mr(*a):
        x, steps = orig(*a)
        stopped.append(steps)
        return x, steps
    monkeypatch.setattr(control, "mr_solve_bf16", mr)
    r = control_run(monkeypatch, "ensemble8_stream")
    c = r["checks"]["relres_median"]
    assert not r["correct"]
    assert c["value"] > 3 * c["limit"]
    # it stopped because it stagnated, well before its cap
    assert stopped and max(stopped) < 20000
