"""The level-0 convergence check of the port (cycles.residual_norm_ratio0)
against the JAX package's, and its dispatcher (dispatch.links_residual_norm,
one launch of cuda_stencil.wilson_u_residual_norm on the card) on CPU
tensors.

The JAX side runs as its own tests run it: complex128 through its plain
links residual, held at 1e-12; complex64 through the Pallas links residual
kernel (_u_resid_vmem_kernel) in interpret mode, held at the repo's 2e-5.
On CPU tensors the dispatcher is today's composition (the links residual,
then the two float64 norms) bit for bit; the kernel itself is held against
it on the card (tests/test_torch_cuda.py). Which implementation the check
takes is a route of ops/dispatch (tests/test_torch_dispatch.py).

Also: solve_ir's outer residual through dispatch.residual."""
import functools
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from torch_port_helpers import (C128_BAR, C64_BAR, crandn, phases,  # noqa: E402
                                rel_err, spy_dispatch, t_of)

import tpu_multigrid as mg  # noqa: E402
from tpu_multigrid.ops import pallas_stencil as ps  # noqa: E402
from tpu_multigrid.solver import cycles as jcy  # noqa: E402
import tpu_multigrid_torch as mgt  # noqa: E402
from tpu_multigrid_torch.ops import cuda_stencil as cs  # noqa: E402
from tpu_multigrid_torch.ops import dispatch  # noqa: E402
from tpu_multigrid_torch.ops import gauge_stencil as tgs  # noqa: E402
from tpu_multigrid_torch.solver import cycles as tcy  # noqa: E402

M = -0.005
BARS = {"complex64": C64_BAR, "complex128": C128_BAR}


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _level0(rng, L, dtype, batch=None, shared_b=False):
    """Links, phi [batch?, 2, L, L] and b (batched like phi, or shared) as
    numpy, from the seed."""
    U = np.exp(1j * phases(rng, L)).astype(dtype)
    lead = () if batch is None else (batch,)
    phi = crandn(rng, lead + (2, L, L), dtype)
    b = crandn(rng, (2, L, L) if shared_b else lead + (2, L, L), dtype)
    return U, phi, b


def _hier(U, D=None):
    """What residual_norm_ratio0 reads of a hierarchy: level 0's D and the
    links."""
    return types.SimpleNamespace(levels=[types.SimpleNamespace(D=D)],
                                 gauge=U)


# ---- against the JAX package


@pytest.mark.parametrize("batch,shared_b", [(None, False), (3, False),
                                            (3, True)])
@pytest.mark.parametrize("dtype", ["complex128", "complex64"])
def test_residual_norm_ratio0_matches_jax(interpret_pallas, monkeypatch,
                                          dtype, batch, shared_b):
    """A links-active level 0 (links='on'), L=16: the port's check, each
    batch entry against JAX's check of that entry."""
    rng = np.random.default_rng(40)
    L = 16
    U, phi, b = _level0(rng, L, np.dtype(dtype), batch, shared_b)
    jcfg = mg.MGConfig(L=L, stencil="wilson", m=M, nlevels=1, dtype=dtype,
                       links="on")
    tcfg = mgt.MGConfig(L=L, stencil="wilson", m=M, nlevels=1, dtype=dtype,
                        links="on")
    if dtype == "complex64":    # JAX's check through the Pallas kernel
        monkeypatch.setattr(ps, "u_mode", lambda dt, L: "vmem")
    jh = _hier(jnp.asarray(U))

    def want_of(p, q):
        return np.asarray(jcy.residual_norm_ratio0(jh, jnp.asarray(p),
                                                   jnp.asarray(q), jcfg))

    got = tcy.residual_norm_ratio0(_hier(t_of(U)), t_of(phi), t_of(b), tcfg)
    if batch is None:
        want = want_of(phi, b)
    else:
        want = np.stack([want_of(phi[i], b if shared_b else b[i])
                         for i in range(batch)])
    assert got.dtype == torch.from_numpy(np.zeros(1, dtype)).real.dtype
    assert tuple(got.shape) == want.shape
    assert rel_err(got, want) < BARS[dtype]


# ---- the wrapper on CPU tensors: today's composition, bit for bit


def _todays_check(U, phi, b):
    """The check as residual_norm_ratio0 computed it before the one-launch
    wrapper: the links residual, ||res|| and ||b|| summed in float64 over
    the field axes, their ratio in b's real dtype."""
    res = tgs.residual_u("wilson", U, M, phi, b)

    def norm(x):
        if x.dim() == 3:
            return torch.sqrt(torch.sum(x.abs() ** 2, dtype=torch.float64))
        return torch.sqrt(torch.sum(x.abs() ** 2, dim=(-3, -2, -1),
                                    dtype=torch.float64))
    return (norm(res) / norm(b)).to(b.real.dtype)


@pytest.mark.parametrize("batch,shared_b", [(None, False), (4, False),
                                            (4, True)])
@pytest.mark.parametrize("dtype", [np.complex64, np.complex128])
@pytest.mark.parametrize("L", [8, 9])
def test_wrapper_on_cpu_is_todays_composition(dtype, batch, shared_b, L):
    rng = np.random.default_rng(41)
    U, phi, b = (t_of(x) for x in _level0(rng, L, dtype, batch, shared_b))
    before = dict(cs.launches)
    got = dispatch.links_residual_norm(U, M, phi, b)
    assert cs.launches == before              # no kernel for CPU tensors
    want = _todays_check(U, phi, b)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


# ---- solve_ir's outer residual


@pytest.mark.parametrize("pallas", ["auto", "off"])
def test_solve_ir_outer_residual_on_the_residual_wrapper(monkeypatch,
                                                         pallas):
    """One dispatch.residual call an outer step, with cfg.pallas, on the
    complex128 level-0 operator; on CPU tensors both give the same
    bits."""
    L = 8
    cfg = mgt.MGConfig(L=L, stencil="wilson", m=0.1, nlevels=1, ntl=False,
                       num_iters=2, null_iters=8, dtype="complex128",
                       res_threshold=1e-10, pallas=pallas)
    rng = np.random.default_rng(43)
    U = mgt.models.gauge.gauge_from_phases(phases(rng, L), cfg.cdtype)
    D = mgt.models.operators.assemble("wilson", U, cfg.m)
    hier = mgt.build_hierarchy(D, cfg, U=U, check=False)
    b = mgt.point_source(cfg)
    plain = mgt.solve_ir(hier, b, cfg.replace(pallas="off"), max_iters=40)
    calls = spy_dispatch(monkeypatch, "residual")
    out = mgt.solve_ir(hier, b, cfg, max_iters=40)
    outer = len(out.history)
    assert out.converged and outer > 1
    assert calls == [("residual", pallas)] * outer
    assert out.iters == plain.iters and torch.equal(out.phi, plain.phi)
