"""The import guard: top-level names compared whole."""
import sys
import types

from h100_bench import harness


def test_guard_names_jax_and_the_jax_package(monkeypatch):
    assert "tpu_multigrid_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu_multigrid_torch.fake",
                        types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "tpu_multigrid.solver",
                        types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jaxlib", "tpu_multigrid"]


def test_a_run_loads_neither():
    """A whole run on the CPU in a fresh process leaves neither loaded."""
    import subprocess
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from h100_bench import harness\n"
            "from h100_bench.tests.helpers import SEED, small\n"
            "harness.run('flagship_rhs', SEED, 0.1, False, 'cpu',"
            " overrides=small('flagship_rhs'), log=lambda *a: None)\n"
            "print(harness.forbidden_modules())" % str(harness.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
