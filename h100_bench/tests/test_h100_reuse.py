"""The reader of graph_reuse (h100_bench/layer_metrics/graph_reuse.py):
one chunk.reuse a solve in the RHS cells and one a configuration in
flagship_configs, on a traced CPU run at the tests' sizes (the program
keeps solve_ir's program there too); nothing from a program that opens
no such span."""
import pytest

from h100_bench import harness
from tpu_multigrid_torch import profiling

from .helpers import SEED, small


def _run(cell):
    return harness.run(cell, SEED, 0.3, True, "cpu",
                       overrides=small(cell, profile_calls=1),
                       log=lambda *a: None)


@pytest.mark.parametrize("cell,name", [
    ("flagship_rhs", "graph_reuse.solve"),
    ("large_rhs", "graph_reuse.solve"),
    ("flagship_configs", "graph_reuse.configs")])
def test_one_reuse_a_unit(cell, name):
    out = _run(cell)
    assert out["correct"] and out["metrics"][name]["value"] == 1.0
    assert out["metrics"][name]["unit"] == "reuses"


def test_nothing_without_the_span(monkeypatch):
    """A program that never opened chunk.reuse (the parent's) reads None,
    not 0, and raises nothing."""
    monkeypatch.setattr(profiling, "_spans", {})
    out = _run("flagship_rhs")
    assert "graph_reuse.solve" not in out["metrics"]
    assert out["correct"]
