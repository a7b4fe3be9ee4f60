"""The plain reference operator: the free Wilson spectrum, a hand-built
case, agreement with the program's operator, and its imports."""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from h100_bench.reference import control, wilson

REF = Path(wilson.__file__).resolve().parent


def matrix(U, m, L):
    """The operator as a dense [2 L L, 2 L L] matrix, column by column."""
    n = 2 * L * L
    eye = torch.eye(n, dtype=torch.complex128).reshape(n, 2, L, L)
    return wilson.apply(U, m, eye).reshape(n, n).T.numpy()


@pytest.mark.parametrize("L,m", [(4, 0.1), (6, -0.005)])
def test_free_spectrum(L, m):
    """At U = 1 the eigenvalues are (2+m) + cos kx + cos ky
    +- i sqrt(sin^2 kx + sin^2 ky), k = 2 pi n / L. (BASELINE.md states
    2 cos and 2 i sqrt(...): that is the operator without the
    projectors' 1/2, whose smallest real part would be m - 2.)"""
    U = wilson.links(torch.zeros(2, L, L))
    ev = np.linalg.eigvals(matrix(U, m, L))
    k = 2 * np.pi * np.arange(L) / L
    kx, ky = np.meshgrid(k, k, indexing="ij")
    re = (2 + m) + np.cos(kx) + np.cos(ky)
    im = np.sqrt(np.sin(kx) ** 2 + np.sin(ky) ** 2)
    an = np.concatenate([(re + 1j * im).ravel(), (re - 1j * im).ravel()])
    assert max(np.abs(an - e).min() for e in ev) < 1e-12
    assert max(np.abs(ev - a).min() for a in an) < 1e-12


def test_hand_built_case():
    """Every matrix element at L = 3 from the definition, site by site."""
    L, m = 3, -0.3
    ph = torch.from_numpy(np.random.default_rng(7).normal(size=(2, L, L)))
    u = np.exp(1j * ph.numpy())
    g = [np.array([[0, 1], [1, 0]]), np.array([[0, -1j], [1j, 0]])]
    eye = np.eye(2)
    want = np.zeros((2, L, L, 2, L, L), complex)
    for x in range(L):
        for y in range(L):
            want[:, x, y, :, x, y] += (2 + m) * eye
            for mu in (0, 1):
                fx, fy = ((x + 1) % L, y) if mu == 0 else (x, (y + 1) % L)
                bx, by = ((x - 1) % L, y) if mu == 0 else (x, (y - 1) % L)
                want[:, x, y, :, fx, fy] += 0.5 * (eye - g[mu]) * u[mu, x, y]
                want[:, x, y, :, bx, by] += (0.5 * (eye + g[mu])
                                             * np.conj(u[mu, bx, by]))
    got = matrix(wilson.links(ph), m, L)
    assert np.abs(got - want.reshape(2 * L * L, -1)).max() < 1e-14


def test_relres_of_exact_solution():
    L, m = 4, 0.2
    ph = torch.from_numpy(np.random.default_rng(3).normal(size=(2, L, L)))
    b = wilson.point_source(L, (1, 2), 1)
    x = np.linalg.solve(matrix(wilson.links(ph), m, L),
                        b.reshape(-1).numpy())
    r = wilson.relres(ph, m, torch.from_numpy(x).reshape(2, L, L), b)
    assert float(r) < 1e-14
    assert float(wilson.relres(ph, m, torch.zeros_like(b), b)) == 1.0


def test_agrees_with_the_program():
    """The reference and the program's assembled stencil give the same
    D x (the reference is written apart from it)."""
    import tpu_multigrid_torch as mgt
    L, m = 8, -0.005
    ph = torch.from_numpy(np.random.default_rng(5).normal(size=(2, L, L)))
    U = wilson.links(ph)
    x = torch.randn(2, L, L, dtype=torch.complex128,
                    generator=torch.Generator().manual_seed(1))
    D = mgt.models.operators.assemble("wilson", U, m)
    want = mgt.ops.stencil.apply_D(D, x)
    assert (wilson.apply(U, m, x) - want).abs().max() < 1e-13


def test_bf16_rounds():
    z = torch.tensor([1 + 1e-3j, 3.14159 - 2.71828j], dtype=torch.complex64)
    r = control.bf16(z)
    assert (r - z).abs().max() > 1e-4
    assert torch.equal(control.bf16(r), r)


def test_reference_imports_nothing_of_the_program_or_jax():
    banned = {"jax", "jaxlib", "flax", "tpu_multigrid",
              "tpu_multigrid_torch"}
    for f in REF.glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in banned, f"{f.name}: {n}"
