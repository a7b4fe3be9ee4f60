"""A cell, a configuration, a traffic mix and a per-layer metric added as
new files and new entries in BENCHMARK.json, with no edit to a file the
benchmark has: the harness finds them by name."""
import json
import shutil
import subprocess
import sys

from h100_bench import harness


def test_new_files_are_found(tmp_path):
    bench = tmp_path / "h100_bench"
    shutil.copytree(harness.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    man = harness.manifest()
    cfg = json.loads((harness.HERE / "configs" / "wilson_ntl_L256.json")
                     .read_text())
    cfg["mgconfig"].update(L=16, nlevels=2, null_iters=8)
    (bench / "configs" / "tiny_wilson.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "two_point_sources.json").write_text(json.dumps({
        "kind": "rhs_stream", "instance": 3, "pool": 2, "value": 1.0,
        "inner_cycles": 2, "max_iters": 100, "sample": 2,
        "relres_limit": 2e-13, "profile_calls": 1}))
    (bench / "layer_metrics" / "calls_in_window.py").write_text(
        "def read(rec):\n    return len(rec.calls)\n")
    (bench / "end_to_end" / "slowest_ms.py").write_text(
        "def read(rec):\n"
        "    return 1e3 * max(c['seconds'] for c in rec.calls)\n")
    man["configs"].append({"name": "tiny_wilson", "source": "test",
                           "file": "h100_bench/configs/tiny_wilson.json",
                           "reduced": ["L"], "why": "test"})
    man["workloads"].append({"name": "tiny_rhs", "config": "tiny_wilson",
                             "traffic": "two_point_sources", "chips": 1,
                             "why": "test"})
    man["end_to_end"].append({"name": "slowest_ms", "unit": "ms",
                              "better": "lower", "bound": 0.1,
                              "source": "host_clock",
                              "workloads": ["tiny_rhs"]})
    man["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                             "better": "higher", "source": "host_clock",
                             "layer": "driver", "moves": "slowest_ms"})
    # a split of a quantity whose reader is there already: no new file
    man["per_layer"].append({"name": "calls_in_window.tiny",
                             "unit": "calls", "better": "higher",
                             "source": "host_clock", "layer": "driver",
                             "moves": "slowest_ms"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    code = ("import json, sys; sys.path[:0] = [%r, %r]\n"
            "from h100_bench import harness\n"
            "out = [harness.run('tiny_rhs', 7, 0.05, t, 'cpu',"
            " log=lambda *a: None) for t in (False, True)]\n"
            "print(json.dumps([harness.HERE.as_posix(), out]))"
            % (str(tmp_path), str(harness.REPO)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=tmp_path)
    assert res.returncode == 0, res.stderr
    here, (plain, traced) = json.loads(res.stdout.splitlines()[-1])
    assert here == bench.as_posix()
    assert set(plain["metrics"]) == {"slowest_ms", "setup_s"}
    assert traced["metrics"]["calls_in_window"]["unit"] == "calls"
    assert traced["metrics"]["calls_in_window.tiny"]["value"] == \
        traced["metrics"]["calls_in_window"]["value"]
    assert plain["correct"] and traced["correct"]


def test_no_result_without_the_program(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's
    files, a run exits with another code than 0 and prints no result."""
    shutil.copytree(harness.HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path)
    res = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", "flagship_rhs",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert res.returncode != 0
    assert not res.stdout.strip()
