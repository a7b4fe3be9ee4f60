"""The readers of the program's spans (h100_bench/program_spans.py): roots
matched to the window's untraced calls by one offset, divided by each
call's units, nothing where the ring has dropped roots of the window or
the program keeps none; and a traced CPU run of each cell reporting
every metric its manifest entry lists.

On the card, one short traced run of each cell through run.py:

    python -m pytest -m cuda h100_bench/tests/test_h100_spans.py
"""
import json
import subprocess
import sys

import pytest

from h100_bench import harness, program_spans
from tpu_multigrid_torch import profiling

from .helpers import SEED, small

NEW = ["capture_ms.solve", "capture_ms.configs", "warmup_stream_ms",
       "replay_ms", "host_syncs.solve", "host_syncs.configs",
       "nearnull_ms.configs", "coarsen_ms.configs", "setup_check_ms.configs"]
MS = 1_000_000


def _record(units, t_base, roots_of_call):
    """A Record of calls of 10 ms each from t = 0 (calls 1 and 2 traced)
    and the roots the program would hold, on a clock whose window starts
    at t_base ns: each call's roots from roots_of_call(i, start_ns)."""
    calls, roots = [], []
    for i, u in enumerate(units):
        t0, t1 = 0.010 * i, 0.010 * (i + 1) - 0.0001
        calls.append({"t0": t0, "t1": t1, "seconds": t1 - t0, "units": u,
                      "failed": 0})
        roots += roots_of_call(i, t_base + round(t0 * 1e9))
    rec = harness.Record(setup_s=1.0, window_s=calls[-1]["t1"], calls=calls,
                         profiled=range(1, 3))
    return rec, roots


def _solve(i, start, k=1):
    """A root of a solve starting 0.1 ms into its call, 9 ms long: its
    spans scale with the call's index (i + 1) and k."""
    w = (i + 1) * k
    spans = {"solve_ir": (1, 9 * MS, 1 * MS),
             "chunk.warm_up": (1, w * MS, w * MS),
             "chunk.capture": (1, 2 * w * MS, 2 * w * MS),
             "chunk.release": (1, MS // 2, MS // 2),
             "chunk.replay": (10, w * MS, w * MS),
             "driver.read_back": (10 * w, w * MS, w * MS)}
    return [profiling.Root("solve_ir", i + 1, start + MS // 10,
                           start + MS // 10 + 9 * MS, spans,
                           {"chunk.warm_up": 0.5 * w})]


@pytest.fixture
def roots(monkeypatch):
    """Put `roots` in the program's ring's place."""
    def use(rs, ring=profiling.RING):
        monkeypatch.setattr(profiling, "roots", lambda: list(rs))
        monkeypatch.setattr(profiling, "RING", ring)
    return use


def _read(name, rec):
    return harness.load_module(harness.reader("layer_metrics", name)).read(rec)


def test_untraced_calls_only_and_per_unit(roots):
    """Calls 0, 3 and 4 are read (1 and 2 are traced); each metric is the
    sum over them over their units (1, 1, 2)."""
    rec, rs = _record([1, 5, 5, 1, 2], 7_000_000_000, _solve)
    roots(rs)
    w = [1, 4, 5]            # (i + 1) of the untraced calls
    units = 4
    assert _read("host_syncs.solve", rec) == pytest.approx(
        10 * sum(w) / units)
    assert _read("replay_ms", rec) == pytest.approx(sum(w) / units)
    assert _read("capture_ms.solve", rec) == pytest.approx(
        (3 * sum(w) + 0.5 * 3) / units)
    assert _read("warmup_stream_ms", rec) == pytest.approx(
        0.5 * sum(w) / units)
    assert _read("nearnull_ms.configs", rec) == 0.0


def test_roots_before_the_window_and_two_a_call(roots):
    """Roots before the window (the set-up's) are left out; a call's roots
    are summed (a setup and a solve)."""
    def two(i, start):
        setup = profiling.Root("build_hierarchy", 0, start + MS,
                               start + 3 * MS,
                               {"setup.nearnull": (3, 2 * MS, 2 * MS)}, {})
        solve = _solve(i, start + 3 * MS)[0]._replace(
            start_ns=start + 4 * MS, end_ns=start + 9 * MS)
        return [setup, solve]
    base = 50_000_000_000
    rec, rs = _record([1, 1, 1, 1], base, two)
    early = profiling.Root("build_hierarchy", 0, base - 90 * MS,
                           base - 80 * MS,
                           {"setup.nearnull": (3, 10 * MS, 10 * MS)}, {})
    roots([early] + rs)
    assert _read("nearnull_ms.configs", rec) == pytest.approx(2.0)
    assert _read("host_syncs.configs", rec) == pytest.approx(
        10 * (1 + 4) / 2)


def test_nothing_where_the_ring_dropped_window_roots(roots):
    """A full ring whose oldest root lies in the window may have dropped
    some of the window's; one whose oldest is older has not."""
    rec, rs = _record([1, 1, 1, 1], 10 ** 12, _solve)
    roots(rs[1:], ring=len(rs) - 1)          # call 0's root dropped
    assert _read("host_syncs.solve", rec) is None
    early = _solve(0, 10 ** 12 - 50 * MS)
    roots(early + rs, ring=len(rs) + 1)      # full, nothing of it dropped
    assert _read("host_syncs.solve", rec) == pytest.approx(10 * 5 / 2)
    roots(rs[:1] + rs[2:], ring=len(rs))     # not full: nothing dropped
    assert _read("host_syncs.solve", rec) == pytest.approx(10 * 5 / 2)


def test_nothing_where_the_roots_do_not_fit_the_calls(roots):
    """An untraced call without a root, a root of the window between two
    calls, or a root after the window that moves the roots between the
    calls: nothing is read, rather than a wrong sum."""
    rec, rs = _record([1, 1, 1, 1], 10 ** 12, _solve)
    roots(rs[1:])                            # call 0 opened no root
    assert _read("host_syncs.solve", rec) is None
    # the last root ends 0.8 ms before its call: the gap between calls 1
    # and 2 lies 0-0.1 ms after call 1's root on the roots' clock
    gap = rs[1].end_ns + MS // 20
    between = profiling.Root("solve_ir", 9, gap, gap, {}, {})
    roots(rs[:2] + [between] + rs[2:])
    assert _read("host_syncs.solve", rec) is None
    # one more root after the window puts the offset 4.65 ms off: call
    # 1's root (its middle 4.6 ms into it) then lies between calls 0 and 1
    late_end = rs[-1].end_ns + 5_450_000
    late = profiling.Root("solve_ir", 9, late_end, late_end, {}, {})
    roots(rs + [late])
    assert _read("host_syncs.solve", rec) is None
    roots(rs)
    assert _read("host_syncs.solve", rec) == pytest.approx(10 * 5 / 2)


def test_nothing_without_the_program_spans(roots, monkeypatch):
    """A program without profiling.roots (or with no root yet): every
    reader returns None and raises nothing."""
    rec, rs = _record([1, 1], 10 ** 12, _solve)
    roots([])
    assert all(_read(n, rec) is None for n in NEW)
    monkeypatch.delattr(profiling, "roots")
    assert program_spans.calls(rec) is None
    assert all(_read(n, rec) is None for n in NEW)


@pytest.mark.parametrize("cell", ["flagship_rhs", "large_rhs",
                                  "flagship_configs", "ensemble8_stream"])
def test_a_traced_cpu_run_reports_the_span_metrics(cell):
    """A traced run on the CPU at the tests' sizes reports each new metric
    its manifest entry lists; a solve reads back once an outer step, and
    no chunk is captured on the CPU."""
    man = harness.manifest()
    want = {m["name"] for m in man["per_layer"]
            if m["name"] in NEW and cell in m["workloads"]}
    out = harness.run(cell, SEED, 0.3, True, "cpu",
                      overrides=small(cell, profile_calls=1),
                      log=lambda *a: None)
    got = out["metrics"]
    assert want <= set(got) and out["correct"]
    if cell.endswith("_rhs"):
        assert got["host_syncs.solve"]["value"] == pytest.approx(
            got["cycles_per_solve"]["value"] / 2)
        assert got["capture_ms.solve"]["value"] == 0.0
    if cell == "flagship_configs":
        assert got["setup_check_ms.configs"]["value"] > 0
        assert got["host_syncs.configs"]["value"] > 10
    if cell == "ensemble8_stream":
        assert got["host_syncs.configs"]["value"] == pytest.approx(1 / 4)


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.manifest()["workloads"]])
def test_short_traced_run_on_the_card(card, cell):
    """Since solve_ir keeps its program with the hierarchy, the set-up's
    warm-up call captures it and every call of the window only replays
    it: nothing captured or warmed up there, one reuse a solve."""
    import torch
    chips = {w["name"]: w["chips"] for w in harness.manifest()["workloads"]}
    if chips[cell] > torch.cuda.device_count():
        pytest.skip(f"{cell} needs {chips[cell]} cards")
    res = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", cell, "--seed",
         "2147483671", "--seconds", "3", "--trace", "1"],
        capture_output=True, text=True, timeout=900, cwd=harness.REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    want = {m["name"] for m in harness.manifest()["per_layer"]
            if m["name"] in NEW and cell in m["workloads"]}
    assert out["correct"] and want <= set(out["metrics"])
    m = out["metrics"]
    if cell.endswith("_rhs"):
        assert m["capture_ms.solve"]["value"] == 0.0
        assert m["graph_reuse.solve"]["value"] == 1.0
    if cell == "large_rhs":
        assert m["warmup_stream_ms"]["value"] == 0.0
