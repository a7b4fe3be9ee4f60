"""U(1) gauge fields on the 2D periodic lattice: links ``U[2, L, L]``,
``U[0]`` the +x links and ``U[1]`` the +y links (counterpart of
tpu_multigrid/models/gauge.py).

The heat-bath ensemble generator works on numpy phases on the host: the
native C++ chain (utils/native.py) when it builds, else the same
checkerboard algorithm in NumPy, which gives exactly the JAX package's
`prefer_native=False` phases from the same seed.
"""
from __future__ import annotations

import numpy as np
import torch


def identity_gauge(L: int, dtype=torch.complex128, device=None) -> torch.Tensor:
    """Free field: all links 1 (reference gauge.h:35)."""
    return torch.ones((2, L, L), dtype=dtype, device=device)


def gauge_from_phases(phases: np.ndarray, dtype=torch.complex128,
                      device=None) -> torch.Tensor:
    """U = exp(i * phase), phases a numpy array shaped [2, L, L] in any
    memory layout; U is contiguous, as the kernels take it."""
    u = np.exp(1j * np.ascontiguousarray(phases, dtype=np.float64))
    return torch.from_numpy(u).to(device=device, dtype=dtype)


def random_gauge(L: int, generator: torch.Generator, width: float = 0.2,
                 dtype=torch.complex128, device=None) -> torch.Tensor:
    """Gaussian-phase links about the identity (reference gauge.h:25-36's
    commented-out 'Gaussian local phase' option), phases width * N(0, 1)
    drawn from `generator` on its device, then moved to `device`."""
    ph = width * torch.randn((2, L, L), generator=generator,
                             dtype=torch.float64, device=generator.device)
    return torch.polar(torch.ones_like(ph), ph).to(device=device, dtype=dtype)


def plaquette(U: torch.Tensor) -> torch.Tensor:
    """Average plaquette, complex mean over sites:
    P(x) = U0(x) U1(x+x^) U0(x+y^)^* U1(x)^*  (reference gauge.h:58-59)."""
    u0, u1 = U[0], U[1]
    p = (u0 * torch.roll(u1, -1, dims=-2)
         * torch.conj(torch.roll(u0, -1, dims=-1)) * torch.conj(u1))
    return torch.mean(p)


def gauge_transform(U: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """U'_mu(x) = Omega(x) U_mu(x) Omega(x+mu)^dagger, omega an [L, L]
    unit-modulus complex field."""
    u0 = omega * U[0] * torch.conj(torch.roll(omega, -1, dims=-2))
    u1 = omega * U[1] * torch.conj(torch.roll(omega, -1, dims=-1))
    return torch.stack([u0, u1])


# ---------------------------------------------------------------------------
# Heat-bath ensemble generation (setup-time; NumPy on the host).
#
# U(1) Wilson action S = -beta * sum_plaq Re P. The single-link conditional
# distribution is von Mises: p(theta) ~ exp(beta*|V| cos(theta + arg V))
# where V is the link's staple sum; links are swept in checkerboard order.
# ---------------------------------------------------------------------------

def _staples(theta: np.ndarray, mu: int) -> np.ndarray:
    """Sum of the two staples attached to link (x, mu), as complex numbers:
    the plaquettes containing U_mu(x) contribute Re[U_mu(x) V(x, mu)]."""
    u = np.exp(1j * theta)
    u0, u1 = u[0], u[1]

    def xp(a):
        return np.roll(a, -1, axis=-2)   # value at (x+1, y)

    def yp(a):
        return np.roll(a, -1, axis=-1)   # value at (x, y+1)

    def xm(a):
        return np.roll(a, 1, axis=-2)

    def ym(a):
        return np.roll(a, 1, axis=-1)

    if mu == 0:
        v1 = xp(u1) * np.conj(yp(u0)) * np.conj(u1)
        v2 = np.conj(xp(ym(u1))) * np.conj(ym(u0)) * ym(u1)
    else:
        v1 = np.conj(xp(u1)) * np.conj(u0) * yp(u0)
        v2 = xm(u0) * np.conj(yp(xm(u0))) * np.conj(xm(u1))
    return v1 + v2


def heatbath_ensemble(L: int, beta: float, n_sweeps: int = 200,
                      seed: int = 4302529, theta0: np.ndarray | None = None,
                      prefer_native: bool = True) -> np.ndarray:
    """U(1) link phases [2, L, L] (float64) by checkerboard heat-bath:
    theta ~ vonMises(kappa = beta |V|, mu = -arg V).

    With prefer_native, the native C++ chain (utils/native.py, built from
    tpu_multigrid/native/heatbath.cpp) when it is available, as the JAX
    function picks it; else the NumPy chain below, vectorised per parity
    class."""
    if prefer_native:
        try:
            from ..utils import native
            if native.available():
                th = (np.zeros((2, L, L)) if theta0 is None
                      else np.array(theta0, dtype=np.float64))
                return native.heatbath_run(th, beta, n_sweeps, seed)
        except Exception:
            pass
    rng = np.random.default_rng(seed)
    theta = np.zeros((2, L, L)) if theta0 is None else np.array(theta0)
    x = np.arange(L)[:, None]
    y = np.arange(L)[None, :]
    parity = (x + y) % 2
    for _ in range(n_sweeps):
        for mu in (0, 1):
            for par in (0, 1):
                V = _staples(theta, mu)
                kappa = beta * np.abs(V)
                mean = -np.angle(V)
                prop = rng.vonmises(mean, np.maximum(kappa, 1e-12))
                mask = parity == par
                theta[mu][mask] = prop[mask]
    return theta


def wilson_action_density(theta: np.ndarray, beta: float) -> float:
    """-beta <Re P> of phases theta [2, L, L]."""
    u = np.exp(1j * theta)
    p = (u[0] * np.roll(u[1], -1, axis=-2)
         * np.conj(np.roll(u[0], -1, axis=-1)) * np.conj(u[1]))
    return float(-beta * np.mean(np.real(p)))


# ---------------------------------------------------------------------------
# Reference file formats (the JAX package's models/gauge.py; SURVEY.md
# Appendix B).
# ---------------------------------------------------------------------------

def read_heatbath_file(path: str, L: int, dtype=torch.complex128,
                       device=None) -> torch.Tensor:
    """Read `phase_{L}_b{beta}.dat`: one phase per line, order x->y->mu
    (reference gauge.h:103-107: outer x, then y, then mu)."""
    ph = np.loadtxt(path).reshape(L, L, 2)          # [x, y, mu]
    return gauge_from_phases(np.transpose(ph, (2, 0, 1)), dtype, device)


def write_heatbath_file(path: str, theta: np.ndarray):
    """Write phases theta [2, L, L] in read_heatbath_file's order, %.18e."""
    ph = np.transpose(np.asarray(theta), (1, 2, 0)).reshape(-1)  # x, y, mu
    np.savetxt(path, ph, fmt="%.18e")


def read_gauge_text(path: str, L: int, dtype=torch.complex128,
                    device=None) -> torch.Tensor:
    """Read `Uphases.txt`-format complex links 're+i im' per line
    (reference gauge.h:65-86), order x->y->mu."""
    vals = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            re, im = line.split("+i")
            vals.append(complex(float(re), float(im)))
    u = np.transpose(np.array(vals).reshape(L, L, 2), (2, 0, 1))
    return torch.from_numpy(np.ascontiguousarray(u)).to(device=device,
                                                        dtype=dtype)


def write_gauge_text(path: str, U: torch.Tensor):
    """Write links U [2, L, L] as '%25.20e+i%25.20e' lines, x->y->mu."""
    u = np.transpose(U.detach().cpu().numpy(), (1, 2, 0)).reshape(-1)
    with open(path, "w") as f:
        for v in u:
            f.write(f"{v.real:25.20e}+i{v.imag:25.20e}\n")
