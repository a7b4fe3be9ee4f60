"""The port's span recorder (profiling.span, profiling.roots) and the spans
the setup and the drivers open on the CPU.

The recorder: nesting, self time, one root id for a request, the ring's
bound, a span closed by an exception, the record_function events a
torch.profiler sees. The setup: the setup.* counts its levels and NTL
copies imply, and none of setup.check in the batched setup. The drivers'
chunk.* spans exist only where a chunk is captured, on the card
(tests/test_torch_compile.py)."""
import time

import numpy as np
import pytest
import torch

import tpu_multigrid_torch as mgt
from tpu_multigrid_torch import profiling

from torch_port_helpers import phases


def _spin(ns: int) -> None:
    end = time.perf_counter_ns() + ns
    while time.perf_counter_ns() < end:
        pass


def test_nesting_and_self_time():
    """A root keeps each name's count, total and self ns (the total less
    the spans directly inside), its own name included."""
    with profiling.span("t.root"):
        _spin(200_000)
        for _ in range(3):
            with profiling.span("t.child"):
                _spin(300_000)
                with profiling.span("t.leaf"):
                    _spin(400_000)
    root = profiling.roots()[-1]
    assert root.name == "t.root"
    assert set(root.spans) == {"t.root", "t.child", "t.leaf"}
    n, total, own = root.spans["t.leaf"]
    assert n == 3 and total == own >= 3 * 400_000
    n, total, own = root.spans["t.child"]
    assert n == 3 and total == own + root.spans["t.leaf"][1]
    assert own >= 3 * 300_000
    n, total, own = root.spans["t.root"]
    assert n == 1 and total == root.end_ns - root.start_ns
    assert own == total - root.spans["t.child"][1] and own >= 200_000


def test_one_root_id_a_request():
    """Every span inside a root belongs to it; a decorated entry point
    called inside another is a child, not a new root; the next request
    has the next id."""
    @profiling.span("t.inner_entry")
    def inner():
        with profiling.span("t.step"):
            pass

    @profiling.span("t.outer_entry")
    def outer():
        inner()
        inner()

    before = len(profiling.roots())
    outer()
    inner()
    got = profiling.roots()[-2:]
    assert len(profiling.roots()) == min(before + 2, profiling.RING)
    assert [r.name for r in got] == ["t.outer_entry", "t.inner_entry"]
    assert got[0].spans["t.inner_entry"][0] == 2
    assert got[0].spans["t.step"][0] == 2
    assert got[1].id == got[0].id + 1
    assert got[1].spans == {"t.inner_entry": got[1].spans["t.inner_entry"],
                            "t.step": got[1].spans["t.step"]}


def test_ring_keeps_the_last_roots():
    """The ring holds the last RING roots, oldest first."""
    leaf = profiling.span("t.ring")
    for _ in range(profiling.RING + 5):
        with leaf:
            pass
    kept = profiling.roots()
    assert len(kept) == profiling.RING
    ids = [r.id for r in kept]
    assert ids == list(range(ids[0], ids[0] + profiling.RING))
    assert all(r.name == "t.ring" for r in kept)


def test_a_span_closed_by_an_exception_is_recorded():
    with pytest.raises(ValueError, match="inside"):
        with profiling.span("t.failing_root"):
            with profiling.span("t.failing_child"):
                raise ValueError("inside")
    root = profiling.roots()[-1]
    assert root.name == "t.failing_root"
    assert root.spans["t.failing_child"][0] == 1
    # the stack is empty again: the next span is a root of its own
    with profiling.span("t.after"):
        pass
    assert profiling.roots()[-1].name == "t.after"


def test_device_ms_goes_to_the_open_root():
    with profiling.span("t.dev_root"):
        profiling.add_device_ms("t.warm", 1.5)
        with profiling.span("t.warm"):
            profiling.add_device_ms("t.warm", 0.25)
    profiling.add_device_ms("t.warm", 9.0)    # no root open: dropped
    assert profiling.roots()[-1].device_ms == {"t.warm": 1.75}


def _tiny(batch=None):
    """Wilson NTL at L=8, 2 levels, 4 copies, complex128, on the CPU: the
    config and the level-0 operator (or a batch of them)."""
    cfg = mgt.MGConfig(L=8, stencil="wilson", m=0.2, nlevels=2, ntl=True,
                       n_copies=4, num_iters=4, null_iters=8,
                       dtype="complex128", res_threshold=1e-10)
    rng = np.random.default_rng(11)
    Us = torch.stack([mgt.models.gauge.gauge_from_phases(
        phases(rng, 8), cfg.cdtype) for _ in range(batch or 1)])
    D = mgt.models.operators.assemble(cfg.stencil, Us, cfg.m)
    return cfg, (D if batch else D[0]), (Us if batch else Us[0])


def test_profiler_sees_each_span():
    """Under a CPU torch.profiler each span is a record_function event
    named tmg.<span>."""
    from torch.profiler import ProfilerActivity, profile
    cfg, D, U = _tiny()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        hier = mgt.build_hierarchy(D, cfg, U=U)
        mgt.solve_ir(hier, mgt.point_source(cfg), cfg, max_iters=40,
                     inner_dtype="complex128")
        for name in ("chunk.warm_up", "chunk.capture", "chunk.replay",
                     "chunk.release"):
            with profiling.span(name):
                pass
    names = {e.name for e in prof.events()}
    want = {"build_hierarchy", "solve_ir", "setup.nearnull",
            "setup.coarsen", "setup.check", "driver.read_back",
            "chunk.warm_up", "chunk.capture", "chunk.replay",
            "chunk.release"}
    assert {"tmg." + n for n in want} <= names
    setup = [r for r in profiling.roots() if r.name == "build_hierarchy"]
    counted = sum(1 for e in prof.events() if e.name == "tmg.setup.check")
    assert counted == setup[-1].spans["setup.check"][0]


def test_build_hierarchy_setup_spans():
    """One root; setup.nearnull once a level; setup.coarsen twice a level
    (its operator's site inverse, then the transfer and the Galerkin
    product), once for the coarsest site inverse and once a copy;
    setup.check once a level and once a copy, with a read-back for each
    near-null row's block norms and each orthogonality check."""
    cfg, D, U = _tiny()
    before = profiling.roots()[-1].id if profiling.roots() else 0
    mgt.build_hierarchy(D, cfg, U=U)
    root = profiling.roots()[-1]
    assert root.name == "build_hierarchy" and root.id == before + 1
    counts = {k: v[0] for k, v in root.spans.items()}
    lv, nc, cp = cfg.nlevels, cfg.n_dof[1], cfg.n_copies
    assert counts == {"build_hierarchy": 1, "setup.nearnull": lv,
                      "setup.coarsen": 2 * lv + 1 + cp,
                      "setup.check": lv + cp,
                      "driver.read_back": lv * (nc + 1) + cp}
    assert root.spans["setup.check"][1] >= root.spans["driver.read_back"][1]
    # no checks asked for: none made
    mgt.build_hierarchy(D, cfg, U=U, check=False)
    root = profiling.roots()[-1]
    assert "setup.check" not in root.spans
    assert "driver.read_back" not in root.spans


def test_batched_setup_runs_no_check():
    """build_hierarchies_batched is one root with the setup.nearnull and
    setup.coarsen of one setup and no setup.check or read-back."""
    cfg, Ds, Us = _tiny(batch=2)
    mgt.build_hierarchies_batched(Us, cfg)
    root = profiling.roots()[-1]
    counts = {k: v[0] for k, v in root.spans.items()}
    lv, cp = cfg.nlevels, cfg.n_copies
    assert counts == {"build_hierarchies_batched": 1,
                      "setup.nearnull": lv,
                      "setup.coarsen": 2 * lv + 1 + cp}


def test_solve_ensemble_is_one_root_around_solve_batched():
    """solve_ensemble calls solve_batched as a child span; its one
    read-back is the per-configuration residuals."""
    cfg, Ds, Us = _tiny(batch=2)
    hier = mgt.build_hierarchies_batched(Us, cfg)
    b = mgt.point_source(cfg)
    mgt.solve_ensemble(hier, torch.stack([b, 2 * b]), cfg, n_cycles=3)
    root = profiling.roots()[-1]
    assert root.name == "solve_ensemble"
    assert {k: v[0] for k, v in root.spans.items()} == {
        "solve_ensemble": 1, "solve_batched": 1, "driver.read_back": 1}
