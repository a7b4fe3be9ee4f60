"""The port's gauge-field module and native loader against the JAX
package's: the heat-bath chains (NumPy and native C++) give exactly JAX's
phases from the same seed, and plaquette and gauge_transform agree at
1e-12. (That no port module imports jax is
tests/test_torch_config.py::test_port_never_imports_jax.)"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_port_helpers import C128_BAR, phases, rel_err, t_of  # noqa: E402

from tpu_multigrid.models import gauge as jgauge  # noqa: E402
from tpu_multigrid.utils import native as jnative  # noqa: E402
from tpu_multigrid_torch.models import gauge as tgauge  # noqa: E402
from tpu_multigrid_torch.utils import native as tnative  # noqa: E402


@pytest.mark.parametrize("L,beta,sweeps,seed", [(8, 32.0, 5, 7),
                                                (6, 4.0, 3, 4302529)])
def test_numpy_heatbath_is_jax_exactly(L, beta, sweeps, seed):
    want = jgauge.heatbath_ensemble(L, beta, sweeps, seed,
                                    prefer_native=False)
    got = tgauge.heatbath_ensemble(L, beta, sweeps, seed,
                                   prefer_native=False)
    assert got.dtype == np.float64 and np.array_equal(got, want)
    th0 = phases(np.random.default_rng(3), L)
    assert np.array_equal(
        tgauge.heatbath_ensemble(L, beta, 2, seed, th0, prefer_native=False),
        jgauge.heatbath_ensemble(L, beta, 2, seed, th0, prefer_native=False))
    for mu in (0, 1):
        assert np.array_equal(tgauge._staples(got, mu),
                              jgauge._staples(got, mu))
    assert tgauge.wilson_action_density(got, beta) == \
        jgauge.wilson_action_density(got, beta)


def test_native_heatbath_is_jax_native_exactly():
    """Both libraries are built from the same sources with the same flags on
    this machine, so the chains agree bit for bit; heatbath_ensemble with
    prefer_native takes the native chain, as the JAX function does."""
    if not (tnative.available() and jnative.available()):
        pytest.skip("no C++ compiler for the native heat-bath")
    th0 = np.zeros((2, 12, 12))
    want = jnative.heatbath_run(th0.copy(), 32.0, 20, 12345)
    got = tnative.heatbath_run(th0, 32.0, 20, 12345)
    assert np.array_equal(got, want)
    assert not th0.any()                     # the caller's phases are kept
    assert np.array_equal(tgauge.heatbath_ensemble(12, 32.0, 20, 12345), got)
    assert np.array_equal(
        jgauge.heatbath_ensemble(12, 32.0, 20, 12345), got)
    assert tnative.mean_plaquette(got) == jnative.mean_plaquette(got)
    p = float(torch.real(tgauge.plaquette(t_of(np.exp(1j * got)))))
    assert abs(p - tnative.mean_plaquette(got)) < 1e-12


def test_plaquette_and_gauge_transform_match_jax():
    rng = np.random.default_rng(6)
    L = 8
    th = phases(rng, L, 0.5)
    omega = np.exp(1j * rng.normal(size=(L, L)))
    jU = jgauge.gauge_from_phases(th, jnp.complex128)
    U = tgauge.gauge_from_phases(th)
    assert abs(complex(tgauge.plaquette(U)) - complex(jgauge.plaquette(jU))
               ) < C128_BAR
    got = tgauge.gauge_transform(U, t_of(omega))
    want = jgauge.gauge_transform(jU, jnp.asarray(omega))
    assert rel_err(got, want) < C128_BAR
    # the plaquette is gauge invariant
    assert abs(complex(tgauge.plaquette(got)) - complex(tgauge.plaquette(U))
               ) < C128_BAR

