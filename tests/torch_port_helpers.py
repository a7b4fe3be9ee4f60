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


def read_results(path):
    """A results_*.txt file of the reference format ("it," then
    "re+i im," per value) as (iterations, [values per line])."""
    its, rows = [], []
    with open(path) as f:
        for line in f:
            head, *vals = line.rstrip(",\n").split(",")
            its.append(int(head))
            rows.append(np.array([complex(float(v.partition("+i")[0]),
                                          float(v.partition("+i")[2]))
                                  for v in vals]))
    return its, rows


def spy_dispatch(monkeypatch, *names):
    """Replace each ops.dispatch.<name> by a recorder that runs the
    original; returns the list of (name, pallas) of the calls in order,
    pallas as the call passed it ("auto" where it did not). The package
    calls the dispatchers through the module, so a dispatcher's calls of
    another dispatcher are recorded too."""
    import inspect

    from tpu_multigrid_torch.ops import dispatch
    calls = []
    for name in names:
        orig = getattr(dispatch, name)

        def rec(*a, _orig=orig, _name=name, _sig=inspect.signature(orig),
                **k):
            calls.append((_name, _sig.bind(*a, **k).arguments.get(
                "pallas", "auto")))
            return _orig(*a, **k)

        monkeypatch.setattr(dispatch, name, rec)
    return calls


# Solves with levels that no kernel takes, which the plain versions run on
# the card as JAX's _relax runs them on plain XLA: a Laplace level 1 of n = 3
# (the case of the JAX package's tests/test_solve.py
# test_configurable_coarse_dof) and a 3 x 3 coarsest level smoothed
# red-black (L=48, 2 x 2 blocks, 4 levels). Each: its MGConfig fields, the
# width of its gauge phases (0: the identity gauge) and the JAX package's
# cycle count from the same hierarchy inputs (phases and near-null starts
# from numpy_inputs), which tests/test_torch_solve.py holds.
FALLBACK_SOLVES = {
    "ndof_coarse3": (dict(L=16, stencil="laplace", m=0.3, nlevels=2,
                          num_iters=8, null_iters=80, res_threshold=1e-9,
                          ndof_coarse=3), 0.0, 3),
    "coarsest_3x3": (dict(L=48, stencil="wilson", m=0.1, nlevels=4,
                          num_iters=4, null_iters=40, res_threshold=1e-9,
                          smoother="rbgs"), 0.2, 8),
}


def numpy_inputs(cfg, width):
    """(gauge phases [2, L, L], near-null starts [k, nf, S, S] a level) from
    np.random.default_rng(cfg.seed): phases width N(0, 1), starts uniform
    in (-pi, pi) as the packages' random_starts draw them, in cfg's
    dtype."""
    rng = np.random.default_rng(cfg.seed)
    phases = width * rng.normal(size=(2, cfg.L, cfg.L))
    starts = []
    for lvl in range(cfg.nlevels):
        nc, nf, S = cfg.n_dof[lvl + 1], cfg.n_dof[lvl], cfg.sizes[lvl]
        k = nc // 2 if cfg.stencil == "wilson" else nc
        u = rng.random(size=(k, nf, S, S))
        starts.append(((2.0 * u - 1.0) * np.pi).astype(cfg.dtype))
    return phases, starts
