"""The port's entry points, `tpu_multigrid_torch.cli` and
`tpu_multigrid_torch.scan`, on the CPU (--platform cpu), against the JAX
package's CLI where both can run the same problem: the files of a run,
the reference's positional argv, a near-null checkpoint written by the
JAX CLI read by the port's (same cycle count, results_phi.txt within
1e-9), --resume, every --solver, the gen-1 / gen-2 geometric programs
(--mode geo|geo2, --geo-ir: the JAX CLI's lines, summary keys, counts and
exit code), the flags this port rejects (exit code 2), and a two-point
scan."""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from torch_port_helpers import read_results  # noqa: E402

from tpu_multigrid import cli as jcli  # noqa: E402
from tpu_multigrid_torch import cli, scan  # noqa: E402
from tpu_multigrid_torch.models import gauge as tgauge  # noqa: E402

LAPLACE = ["--L", "16", "--stencil", "laplace", "--m", "0.1",
           "--nlevels", "2", "--num-iters", "8", "--null-iters", "60",
           "--max-iters", "200", "--platform", "cpu"]


def _summary(d):
    return json.loads((d / "solve_summary.json").read_text())


def test_cli_end_to_end(tmp_path, capsys):
    rc = cli.main(LAPLACE + ["--res-threshold", "1e-9", "--gauge", "random",
                             "--out-dir", str(tmp_path)])
    assert rc == 0
    for fname in ["results_phi.txt", "results_NTL_weights.txt",
                  "results_res_lvl-0.txt", "results_res_lvl-2.txt",
                  "metrics.jsonl", "solve_summary.json",
                  "results_gen_scaling.txt"]:
        assert (tmp_path / fname).exists(), fname
    s = _summary(tmp_path)
    assert s["converged"] and s["resmag"] < 1e-9
    its, rows = read_results(tmp_path / "results_phi.txt")
    assert its == list(range(1, s["iters"] + 1))
    assert all(r.shape == (16 * 16,) for r in rows)
    metrics = [json.loads(x) for x in
               (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert metrics[-1]["rel_residual"] == pytest.approx(s["resmag"], rel=1e-6)
    assert (tmp_path / "results_gen_scaling.txt").read_text() == (
        f"16\t8\t0.100000\t2\t2\t2\t2\t{s['iters']}\n")
    out = capsys.readouterr().out
    assert "self-tests: 10 checks" in out and "(all pass)" in out
    assert f"converged in {s['iters']} cycles" in out


def test_cli_reference_argv(tmp_path):
    """L num_iters block gen_null m nlevels t_flag n_copies (wilson, the
    reference's compiled-in stencil); the remaining flags as in JAX."""
    rc = cli.main(["16", "8", "2", "1", "0.3", "2", "1", "4",
                   "--out-dir", str(tmp_path), "--skip-tests",
                   "--platform", "cpu"])
    assert rc == 0
    cfg, _ = cli.parse_args(["16", "8", "2", "1", "0.3", "2", "1", "4"])
    jcfg, _ = jcli.parse_args(["16", "8", "2", "1", "0.3", "2", "1", "4"])
    assert vars(cfg) == vars(jcfg)
    s = _summary(tmp_path)
    assert s["stencil"] == "wilson" and s["ntl"] and s["converged"]


def test_cli_from_jax_checkpoint(tmp_path):
    """Both CLIs on one heat-bath-format phase file: the JAX CLI writes a
    near-null checkpoint, then the JAX CLI and the port's start from it
    (--gen-null 0). Same cycle count; results_phi.txt within 1e-9."""
    phases = str(tmp_path / "phase_16.dat")
    tgauge.write_heatbath_file(
        phases, 0.3 * np.random.default_rng(8).normal(size=(2, 16, 16)))
    ckpt = str(tmp_path / "nn.npz")
    common = ["--L", "16", "--stencil", "wilson", "--m", "0.05",
              "--nlevels", "2", "--ntl", "--num-iters", "4",
              "--null-iters", "40", "--res-threshold", "1e-10",
              "--max-iters", "100", "--gauge", "file", "--gauge-file",
              phases, "--checkpoint", ckpt, "--skip-tests"]
    assert jcli.main(common + ["--no-compile-cache", "--out-dir",
                               str(tmp_path / "gen")]) == 0
    assert jcli.main(common + ["--gen-null", "0", "--no-compile-cache",
                               "--out-dir", str(tmp_path / "jax")]) == 0
    assert cli.main(common + ["--gen-null", "0", "--platform", "cpu",
                              "--out-dir", str(tmp_path / "port")]) == 0
    j, t = _summary(tmp_path / "jax"), _summary(tmp_path / "port")
    assert t["iters"] == j["iters"] and t["converged"]
    assert t["plaquette"] == pytest.approx(j["plaquette"], abs=1e-15)
    jits, jrows = read_results(tmp_path / "jax" / "results_phi.txt")
    tits, trows = read_results(tmp_path / "port" / "results_phi.txt")
    assert tits == jits
    for a, b in zip(trows, jrows):
        assert np.max(np.abs(a - b)) <= 1e-9 * np.max(np.abs(b))


def test_cli_resume(tmp_path):
    """--resume checkpoints the solver state; a run cut at 5 cycles and
    resumed from its state file ends where one uninterrupted run ends."""
    def run(state, max_iters, out):
        return cli.main(LAPLACE + [
            "--res-threshold", "1e-12", "--max-iters", str(max_iters),
            "--checkpoint-every", "5", "--resume", str(tmp_path / state),
            "--skip-tests", "--out-dir", str(tmp_path / out)])

    assert run("state.npz", 5, "cut") == 1
    assert (tmp_path / "state.npz").exists()
    s1 = _summary(tmp_path / "cut")
    assert s1["iters"] == 5 and not s1["converged"]
    assert run("state.npz", 40, "resumed") == 0
    assert run("whole.npz", 40, "whole") == 0
    s2, whole = _summary(tmp_path / "resumed"), _summary(tmp_path / "whole")
    assert s2["converged"] and s2["resmag"] < s1["resmag"]
    assert s2["iters"] == whole["iters"] > 5
    assert s2["resmag"] == pytest.approx(whole["resmag"], rel=1e-9)


@pytest.mark.parametrize("solver", ["stationary", "fgmres", "ir", "fmg",
                                    "eo_mr", "cgnr"])
def test_cli_solvers(tmp_path, solver):
    rc = cli.main(LAPLACE + ["--res-threshold", "1e-9", "--solver", solver,
                             "--gauge", "random", "--skip-tests",
                             "--out-dir", str(tmp_path)])
    s = _summary(tmp_path)
    assert rc == 0 and s["converged"] and s["resmag"] < 1e-9, s


def test_cli_gs_lex_joint_qr(tmp_path):
    """Lexicographic GS (plain sweeps) with joint-QR near-null setup, with
    the self-tests."""
    rc = cli.main(LAPLACE + ["--res-threshold", "1e-9", "--smoother",
                             "gs_lex", "--null-joint-qr", "--null-iters",
                             "20", "--debug-nans", "--out-dir",
                             str(tmp_path)])
    assert rc == 0 and _summary(tmp_path)["converged"]


@pytest.mark.parametrize("flags", [["--mode", "geo"], ["--mode", "geo2"],
                                   ["--mesh", "2,2"],
                                   ["--platform", "cuda"],
                                   ["--platform", "tpu"]])
def test_cli_rejects_with_exit_2(tmp_path, flags, capsys):
    """--mesh 2,2 in a run of world size 1 (no torchrun) is refused; a
    missing or unknown device is refused, by the geometric modes too
    (never a silent CPU run)."""
    missing = ["--platform", "cuda"]
    if torch.cuda.is_available():
        missing = ["--platform", f"cuda:{torch.cuda.device_count()}"]
    if flags == ["--platform", "cuda"]:
        flags = missing
    elif "--mode" in flags:
        flags = flags + missing
    base = [a for a in LAPLACE if a not in ("--platform", "cpu")]
    with pytest.raises(SystemExit) as e:
        cli.main(base + flags + ["--out-dir", str(tmp_path)])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "world size" in err if "--mesh" in flags else "--platform" in err
    assert not (tmp_path / "solve_summary.json").exists()


GEO = ["--L", "32", "--m", "0.5", "--nlevels", "3", "--num-iters", "4",
       "--max-iters", "100", "--platform", "cpu"]


@pytest.mark.parametrize("flags", [
    ["--mode", "geo", "--res-threshold", "1e-12"],
    ["--mode", "geo", "--geo-ir", "--res-threshold", "1e-11"],
    ["--mode", "geo2", "--smoother", "gs_lex", "--res-threshold", "1e-12"],
    ["--mode", "geo2", "--smoother", "gs_lex", "--ntl",
     "--res-threshold", "1e-12"],
    ["--mode", "geo2", "--ntl", "--ntl-combine", "avg_coarse",
     "--res-threshold", "1e-12"],
    ["--mode", "geo", "--max-iters", "5"]])
def test_cli_geometric_matches_jax(tmp_path, flags, capsys):
    """The geometric programs through both CLIs at L=32: the same printed
    lines (but sum|r|'s rounding and the seconds), summary keys, cycle
    count, sum|r| history and exit code (1 where the cycles run out)."""
    rc = cli.main(GEO + flags + ["--out-dir", str(tmp_path / "t")])
    out = capsys.readouterr().out.splitlines()
    jrc = jcli.main(GEO + flags + ["--out-dir", str(tmp_path / "j")])
    jout = capsys.readouterr().out.splitlines()
    s, js = _summary(tmp_path / "t"), _summary(tmp_path / "j")
    assert rc == jrc == (0 if js["converged"] else 1)
    assert s.keys() == js.keys()
    for k in ("mode", "L", "m", "nlevels", "iters", "converged"):
        assert s[k] == js[k], k
    # float32 inner cycles (--geo-ir) round apart; float64 to its floor
    rtol = 1e-5 if "--geo-ir" in flags else 1e-9
    np.testing.assert_allclose(s["history"], js["history"], rtol=rtol,
                               atol=1e-14)
    assert out[0] == jout[0]
    assert out[-1].split(" = ")[0] == jout[-1].split(" = ")[0]
    if "gs_lex" in flags:       # the count chip_smoke.py holds the card to
        assert s["iters"] == 10


def test_debug_nans_raises():
    with pytest.raises(FloatingPointError):
        cli._check_finite(float("nan"), "residual")
    cli._check_finite(1e300, "residual")


def test_scan_two_points(tmp_path):
    rc = scan.main(["--L", "16", "--m", "0.05,0.2", "--nlevels", "2",
                    "--num-iters", "8", "--stencil", "laplace",
                    "--null-iters", "60", "--res-threshold", "1e-9",
                    "--max-iters", "300", "--out-dir", str(tmp_path),
                    "--platform", "cpu"])
    assert rc == 0
    rows = [json.loads(x) for x in
            (tmp_path / "scan_summary.jsonl").read_text().splitlines()]
    assert len(rows) == 2 and all(r["converged"] for r in rows)
    # the heavier mass converges in no more cycles (scaling invariant)
    assert rows[1]["iters"] <= rows[0]["iters"]
    lines = (tmp_path / "results_gen_scaling.txt").read_text().splitlines()
    assert len(lines) == 2 and lines[0].startswith("16\t8\t0.05")
