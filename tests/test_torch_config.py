"""The port's package boundary: MGConfig and SolveResult agree field for
field with the JAX package's, and no module of tpu_multigrid_torch (nor
chip_smoke.py) imports jax or tpu_multigrid."""
import ast
import dataclasses
from pathlib import Path

import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402
import torch_port_helpers  # noqa: E402,F401  (pins torch threads)

import tpu_multigrid as mg  # noqa: E402
import tpu_multigrid_torch as mgt  # noqa: E402
from tpu_multigrid_torch.utils.convert import config_from_dict  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        default = f.default
        if f.default_factory is not dataclasses.MISSING:
            default = f.default_factory()
        out[f.name] = default
    return out


def test_mgconfig_fields_match_jax():
    assert _fields(mgt.MGConfig) == _fields(mg.MGConfig)
    assert list(_fields(mgt.MGConfig)) == list(_fields(mg.MGConfig))


def test_solveresult_fields_match_jax():
    from tpu_multigrid.solver.driver import SolveResult
    assert _fields(mgt.SolveResult) == _fields(SolveResult)
    assert list(_fields(mgt.SolveResult)) == list(_fields(SolveResult))


@pytest.mark.parametrize("kw", [
    {},
    dict(L=256, stencil="wilson", m=-0.005, nlevels=3, ntl=True,
         num_iters=4, null_iters=100, dtype="complex64",
         res_threshold=1e-6, smoother="rbgs"),
    dict(L=64, stencil="laplace", nlevels=2, ndof_coarse=3, quad=3,
         smoother="jacobi", links="off", pallas="off"),
])
def test_config_from_dict_and_geometry(kw):
    jcfg = mg.MGConfig(**kw)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    for prop in ("sizes", "n_dof", "scale0", "max_levels", "spinor_dim",
                 "n_dof_scale"):
        assert getattr(tcfg, prop) == getattr(jcfg, prop), prop
    want = torch.complex128 if jcfg.dtype == "complex128" else torch.complex64
    assert tcfg.cdtype == want
    assert tcfg.rdtype == want.to_real()


def test_mgconfig_validation_matches_jax():
    for bad in (dict(stencil="dirac"), dict(ntl=True, nlevels=1),
                dict(n_copies=5), dict(L=30, nlevels=2),
                dict(links="maybe")):
        with pytest.raises(ValueError):
            mg.MGConfig(**bad)
        with pytest.raises(ValueError):
            mgt.MGConfig(**bad)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "tpu_multigrid")


def test_port_never_imports_jax():
    pkg = ROOT / "tpu_multigrid_torch"
    files = sorted(f for f in pkg.rglob("*.py")
                   if "_build" not in f.relative_to(pkg).parts)
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert not bad, bad
