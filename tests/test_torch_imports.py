"""The port stands alone: every module of tpu_multigrid_torch, imported in
a fresh interpreter, loads neither jax nor the JAX package. Its imports
between the kernels and the plain versions run one way: solver and
parallel -> ops/dispatch.py -> ops/cuda_stencil.py and the plain modules."""
import ast
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CODE = """
import importlib, json, pkgutil, sys
import tpu_multigrid_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "tpu_multigrid_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "tpu_multigrid"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", CODE], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.splitlines()[-1])
    assert got["bad"] == []
    for name in ("analysis", "cli", "scan", "parallel.halo",
                 "parallel.multihost", "parallel.sharded", "parallel.setup",
                 "solver.ensemble", "ops.cuda_stencil", "ops.dispatch"):
        assert f"tpu_multigrid_torch.{name}" in got["modules"], name


def _imports(path):
    """(module names imported, names of the modules imported inside a
    function) of a source file, relative ones by their last part."""
    tree = ast.parse(path.read_text())
    local = {id(n) for f in ast.walk(tree)
             if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
             for n in ast.walk(f)}
    names, inner = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            got = {node.module.split(".")[-1]} if node.module else set()
            if not node.module or node.level:
                got |= {a.name for a in node.names}
        elif isinstance(node, ast.Import):
            got = {a.name.split(".")[-1] for a in node.names}
        else:
            continue
        names |= got
        if id(node) in local:
            inner |= got
    return names, inner


def test_the_imports_run_one_way():
    ops = ROOT / "tpu_multigrid_torch" / "ops"
    for plain in ("stencil", "gauge_stencil", "smoothers", "transfer"):
        names, _ = _imports(ops / f"{plain}.py")
        assert not names & {"cuda_stencil", "dispatch"}, plain
    names, _ = _imports(ops / "cuda_stencil.py")
    assert not names & {"gauge_stencil", "smoothers", "stencil", "dispatch"}
    for path in (ROOT / "tpu_multigrid_torch").rglob("*.py"):
        _, inner = _imports(path)
        assert not inner & {"cuda_stencil", "dispatch"}, path
