"""The port stands alone: every module of tpu_multigrid_torch, imported in
a fresh interpreter, loads neither jax nor the JAX package."""
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
                 "solver.ensemble", "ops.cuda_stencil"):
        assert f"tpu_multigrid_torch.{name}" in got["modules"], name
