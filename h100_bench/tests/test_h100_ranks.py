"""The launcher of cells on several cards (h100_bench/ranks.py), driven
through run.py's `main` in a copy of the benchmark whose BENCHMARK.json
gains cells of 4 chips; their traffic kinds (probe_kind.py,
mesh_kind.py) are written into the copy only. On the CPU the four ranks
meet over gloo; on the card (`-m cuda`, with 4 cards or more) the same
cells run over NCCL through run.py as every benchmark run goes:

    python -m pytest -m cuda h100_bench/tests/test_h100_ranks.py
"""
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from h100_bench import harness

from .helpers import SEED

HERE = Path(__file__).resolve().parent
# a failing rank ends the run long before the process-group timeout (300 s)
DEADLINE_S = 150
PROBE = {"kind": "probe", "sleep_s": 0.01, "elements": 1 << 16,
         "profile_calls": 2}
MIXES = {
    "probe": PROBE,
    "probe_fails": {**PROBE, "fail_rank": 2, "fail_call": 3},
    "probe_loads_jax": {**PROBE, "forbidden_rank": 1},
    "mesh_point_sources": {"kind": "mesh_rhs", "mesh": [2, 2], "pool": 4,
                           "value": 5.0, "max_iters": 100, "sample": 2,
                           "relres_limit": 1.25e-10, "profile_calls": 1},
    "two_point_sources": {"kind": "rhs_stream", "instance": 3, "pool": 2,
                          "value": 1.0, "inner_cycles": 2, "max_iters": 100,
                          "sample": 2, "relres_limit": 2e-13,
                          "profile_calls": 1},
}
# cell -> (configuration, mix, chips)
CELLS = {"probe4": ("tiny_wilson", "probe", 4),
         "probe4_fails": ("tiny_wilson", "probe_fails", 4),
         "probe4_loads_jax": ("tiny_wilson", "probe_loads_jax", 4),
         "mesh4_L32": ("mesh_wilson", "mesh_point_sources", 4),
         "tiny_rhs": ("tiny_wilson", "two_point_sources", 1)}
ONE_CARD_KEYS = ["correct", "attempted", "failed", "metrics", "device",
                 "checks"]
# holds the launcher back until every rank has written its report and
# ended, before it first waits on them
LATE = """
import time
from torch.multiprocessing import ProcessContext
join = ProcessContext.join
def late(self, *a, **k):
    while any(p.is_alive() for p in self.processes):
        time.sleep(0.05)
    return join(self, *a, **k)
ProcessContext.join = late
"""


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """A copy of the benchmark with the cells above added as new files
    and entries; tpu_multigrid_torch is found in the repository."""
    root = tmp_path_factory.mktemp("ranks")
    bench = root / "h100_bench"
    shutil.copytree(harness.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(HERE / "probe_kind.py", bench / "traffic" / "probe.py")
    shutil.copy(HERE / "mesh_kind.py", bench / "traffic" / "mesh_rhs.py")
    base = json.loads((harness.HERE / "configs" / "wilson_ntl_L256.json")
                      .read_text())
    man = harness.manifest()
    for name, over in (("tiny_wilson", dict(L=16, nlevels=2, null_iters=8)),
                       ("mesh_wilson", dict(L=32, nlevels=2, null_iters=20,
                                            res_threshold=1e-10))):
        cfg = json.loads(json.dumps(base))
        cfg["mgconfig"].update(over)
        (bench / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        man["configs"].append({"name": name, "source": "test",
                               "file": f"h100_bench/configs/{name}.json",
                               "reduced": sorted(over), "why": "test"})
    (root / "pids").mkdir()
    for name, mix in MIXES.items():
        mix = {**mix, "pid_dir": str(root / "pids")} if \
            mix["kind"] == "probe" else mix
        (bench / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, (config, mix, chips) in CELLS.items():
        man["workloads"].append({"name": name, "config": config,
                                 "traffic": mix, "chips": chips,
                                 "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


def run(copy, cell, trace=0, seconds=1.0, platform="cpu", late=False):
    """(exit code, stdout, stderr, seconds) of one run of the cell in the
    copy: on the CPU by run.main, on the card by run.py itself; `late`
    holds the launcher back until every rank has ended."""
    argv = ["--workload", cell, "--seed", str(SEED), "--seconds",
            str(seconds), "--trace", str(trace)]
    if platform == "cpu":
        cmd = [sys.executable, "-c",
               "import sys; sys.path[:0] = [%r, %r]\n%s"
               "from h100_bench import run\n"
               "sys.exit(run.main(%r, platform='cpu'))"
               % (str(copy), str(harness.REPO), LATE if late else "", argv)]
    else:
        cmd = [sys.executable, "h100_bench/run.py", *argv]
    env = {**os.environ, "PYTHONPATH": str(harness.REPO),
           "OMP_NUM_THREADS": "1"}
    t0 = time.monotonic()
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=copy,
                         env=env, timeout=DEADLINE_S if cell.endswith(
                             ("fails", "jax")) else 600)
    return res.returncode, res.stdout, res.stderr, time.monotonic() - t0


def result(out) -> dict:
    return json.loads(out.strip().splitlines()[-1])


def calls_by_rank(err) -> list:
    line = [x for x in err.splitlines() if x.startswith("calls by rank:")]
    return json.loads(line[-1].split(":", 1)[1])


def assert_four_cards(r, platform):
    dev = r["device"]
    assert dev["count"] == 4 and len(dev["cards"]) == 4
    assert [c["index"] for c in dev["cards"]] == [0, 1, 2, 3]
    assert dev["memory_peak_bytes"] == max(
        c["memory_peak_bytes"] for c in dev["cards"])
    if platform == "cuda":
        assert dev["platform"] == "gpu"
        assert len({c["uuid"] for c in dev["cards"]}) == 4
        assert all(c["memory_peak_bytes"] > 0 for c in dev["cards"])
        assert all(c["name"] == dev["kind"] for c in dev["cards"])
    assert list(r)[-1] == "checks"


def no_rank_left(copy):
    """Every rank that wrote its process id has ended."""
    for f in (copy / "pids").iterdir():
        pid = int(f.read_text())
        f.unlink()
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


@pytest.mark.parametrize("trace, late", [(0, False), (1, False), (0, True)])
def test_four_ranks_run_the_same_calls(copy, trace, late):
    """The ranks' calls take 1 to 4 times as long as rank 0's, and every
    rank still runs each call rank 0 runs, and no more; the same where
    every rank has written its report and ended before the launcher first
    looks (late)."""
    rc, out, err, _ = run(copy, "probe4", trace, late=late)
    assert rc == 0, err[-3000:]
    r = result(out)
    assert r["correct"] and r["checks"]["calls_apart"]["value"] == 0
    assert calls_by_rank(err) == [r["attempted"]] * 4
    assert_four_cards(r, "cpu")
    assert ("busy_s" in r["device"]) == bool(trace)
    assert err.strip().splitlines()[-1].startswith("check calls_apart ")
    no_rank_left(copy)


def test_a_failing_rank_ends_the_run(copy):
    """A rank that raises in mid-window: the others are stopped, the run
    exits with another code than 0, prints no result, and ends long
    before the process-group timeout."""
    rc, out, err, secs = run(copy, "probe4_fails", seconds=30.0)
    assert rc == 1 and not out.strip()
    assert "rank 2 fails at call 3" in err and "no result" in err
    assert secs < DEADLINE_S
    no_rank_left(copy)


def test_a_rank_that_loads_jax_fails_the_run(copy):
    rc, out, err, _ = run(copy, "probe4_loads_jax")
    assert rc == 3 and not out.strip()
    assert "jaxlib" in err.splitlines()[-1]
    no_rank_left(copy)


def test_a_sharded_solve_on_four_ranks(copy):
    """parallel/'s sharded set-up and solve on a (2, 2) mesh of four gloo
    ranks, judged on rank 0 by the plain reference."""
    rc, out, err, _ = run(copy, "mesh4_L32", seconds=0.5)
    assert rc == 0, err[-3000:]
    r = result(out)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert_four_cards(r, "cpu")


@pytest.mark.parametrize("trace", [0, 1])
def test_a_one_card_result_keeps_its_keys(copy, trace):
    rc, out, err, _ = run(copy, "tiny_rhs", trace, seconds=0.1)
    assert rc == 0, err[-3000:]
    r = result(out)
    assert list(r) == ONE_CARD_KEYS[:5] + (["breakdown"] if trace else []) \
        + ONE_CARD_KEYS[5:]
    assert list(r["device"]) == ["platform", "kind", "count",
                                 "memory_peak_bytes"] + (
        ["busy_s", "window_s"] if trace else [])
    assert r["device"]["count"] == 1 and r["correct"]


def test_too_few_cards_exits_2(copy):
    """run.py itself, on a machine with fewer cards than the cell asks for:
    exit 2 and no result."""
    import torch
    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("this machine has 4 cards")
    rc, out, err, _ = run(copy, "probe4", platform="cuda")
    assert rc == 2 and not out.strip()
    assert "needs 4 CUDA card(s)" in err


@pytest.fixture
def four_cards():
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA cards")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["probe4", "mesh4_L32"])
def test_four_cards(four_cards, copy, cell):
    """The probe and the sharded solve on four cards over NCCL, through
    run.py: `correct`, four distinct cards, each with its peak."""
    rc, out, err, _ = run(copy, cell, seconds=2.0, platform="cuda")
    assert rc == 0, err[-3000:]
    r = result(out)
    print(json.dumps(r))
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert_four_cards(r, "cuda")
    if cell == "probe4":
        assert calls_by_rank(err) == [r["attempted"]] * 4
