"""Shared helpers for the PyTorch port's parity tests: seeded numpy inputs
fed to both packages, JAX -> numpy -> torch conversion, and the error
measure of every bar.

torch is pinned to one thread: the tier-1 suite runs under xdist with
several workers per machine.
"""
import numpy as np
import torch

torch.set_num_threads(1)

# Per-module bar in complex128: the reference's self-test tolerance
# (tpu_multigrid.testing.EPSILON).
C128_BAR = 1e-12
# complex64 bar of the Pallas kernels against their plain versions
# (tests/test_pallas.py:166).
C64_BAR = 2e-5


def np_of(x) -> np.ndarray:
    """Any JAX array, torch tensor or numpy array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def t_of(x, device="cpu") -> torch.Tensor:
    """JAX array or numpy array as a contiguous torch tensor."""
    return torch.from_numpy(np.array(x, order="C")).to(device)


def rel_err(port, ref) -> float:
    """max |port - ref| / max |ref|."""
    p, r = np_of(port), np_of(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    return float(np.max(np.abs(p - r)) / np.max(np.abs(r)))


def weights_bar(res_in: float, bar: float = 1e-9) -> float:
    """Bar for one cycle's NTL weights, given the residual the cycle starts
    from. The weights solve a 4x4 system built from the prolonged
    corrections of that residual, and the residual carries an absolute
    rounding error of ~eps |b|: the weights' relative rounding grows as
    eps / residual (measured on the JAX package itself: the port on the
    JAX-built hierarchy gives err * residual <= ~2e-15 in every cycle).
    So `bar` down to residual 1e-4, then growing as 1 / residual."""
    return bar * max(1.0, 1e-4 / res_in)


def crandn(rng, shape, dtype=np.complex128) -> np.ndarray:
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(dtype)


def phases(rng, L, width=0.2) -> np.ndarray:
    return width * rng.normal(size=(2, L, L))


def jax_hierarchy_leaves(hier):
    """A JAX Hierarchy's leaves as numpy, in hierarchy_from_numpy's form."""
    levels = [(np.asarray(l.D), np.asarray(l.D0inv),
               None if l.phi_null is None else np.asarray(l.phi_null))
              for l in hier.levels]
    ntl = None
    if hier.ntl is not None:
        ntl = (np.asarray(hier.ntl.phi_null), np.asarray(hier.ntl.D),
               np.asarray(hier.ntl.D0inv))
    gauge = None if hier.gauge is None else np.asarray(hier.gauge)
    return levels, ntl, gauge
