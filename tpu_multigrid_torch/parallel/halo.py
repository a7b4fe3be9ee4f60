"""Halo exchange and the collectives of the distributed port, for lattice
fields block-partitioned over a 2D mesh of ranks (counterpart of
tpu_multigrid/parallel/halo.py).

The L x L torus is cut into one [lx, ly] tile per rank of an ('x', 'y')
mesh (parallel.sharded.Mesh); the 5-point stencil needs a width-1 halo of
neighbour sites. Where the JAX package permutes an edge with
`lax.ppermute` inside `shard_map`, each rank here posts its edges as
`torch.distributed` isend/irecv pairs in one `batch_isend_irecv`, and
`lax.psum` / `lax.all_gather` become `all_reduce` / `all_gather` over the
mesh's process group. Complex tensors travel as `view_as_real` (NCCL has
no complex type). On a mesh axis of size 1 an edge comes from the tile
itself, with no collective, as JAX's one-device permute does.

Every function takes the rank's local tiles ([..., lx, ly] on the lattice
axes) and the mesh; every rank of the mesh calls it in the same order.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import SAME, XP, XM, YP, YM
from ..ops.stencil import _site_matvec

AXIS_X = "x"   # mesh axis partitioning the lattice x (tensor axis -2)
AXIS_Y = "y"   # mesh axis partitioning the lattice y (tensor axis -1)

# direction -> (lattice axis, step along the mesh axis)
_STEP = {XP: (-2, 1), XM: (-2, -1), YP: (-1, 1), YM: (-1, -1)}


# --- the collectives -------------------------------------------------------

def _real(t: torch.Tensor) -> torch.Tensor:
    """A view of t that NCCL and gloo take: complex as its real pairs."""
    return torch.view_as_real(t) if t.is_complex() else t


def _check(t: torch.Tensor, mesh) -> torch.Tensor:
    """t, contiguous, after refusing a tensor off the mesh's device (a
    CUDA tensor never goes through gloo, a CPU one never through NCCL)."""
    if t.device != mesh.device:
        raise ValueError(f"a tensor on {t.device} in a collective of a mesh "
                         f"on {mesh.device} ({mesh.backend})")
    return t.contiguous()


def psum(t: torch.Tensor, mesh) -> torch.Tensor:
    """Sum of t over the mesh's ranks (lax.psum over ('x', 'y')), in t's
    dtype; a new tensor."""
    t = _check(t, mesh).clone()
    dist.all_reduce(_real(t), op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def all_gather(t: torch.Tensor, mesh):
    """Every rank's t, in rank order (a list of new tensors)."""
    t = _check(t, mesh)
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather([_real(p) for p in parts], _real(t), group=mesh.group)
    return parts


# --- halo exchange -----------------------------------------------------------

def _edge(v: torch.Tensor, d: int) -> torch.Tensor:
    """The width-1 edge of v that the rank on the other side of direction
    d needs to shift in direction d: the first row (column) for a + shift,
    the last for a - shift."""
    ax, step = _STEP[d]
    sl = slice(0, 1) if step == 1 else slice(-1, None)
    return v[..., sl, :] if ax == -2 else v[..., sl]


class Edges:
    """Edges in flight (halo_edges): wait() returns them, by direction."""

    def __init__(self, works, sent, edges):
        self._works, self._sent, self._edges = works, sent, edges

    def wait(self):
        for w in self._works:
            w.wait()
        self._works, self._sent = [], []
        return self._edges


def halo_edges(v: torch.Tensor, mesh, dirs=(XP, XM, YP, YM)) -> Edges:
    """Post the edge exchange for each direction d of `dirs` and return at
    once: after wait(), edges[d] is the row (column) of the neighbour in
    direction d that borders this tile, [..., 1, ly] or [..., lx, 1]. Each
    rank sends its own edge to the rank on the other side; the tag names
    the direction, and between one pair of ranks the messages are posted
    in the same order on both, so an axis of size 2 (both neighbours one
    rank) pairs them too."""
    v = _check(v, mesh)
    ops, sent, edges = [], [], {}
    for d in dirs:
        e = _edge(v, d)
        if mesh.axis_size(d) == 1:
            edges[d] = e
            continue
        out = e.contiguous()
        into = torch.empty_like(out)
        ops.append(dist.P2POp(dist.isend, _real(out), mesh.neighbour(d, -1),
                              mesh.group, tag=d))
        ops.append(dist.P2POp(dist.irecv, _real(into), mesh.neighbour(d, 1),
                              mesh.group, tag=d))
        sent.append(out)
        edges[d] = into
    works = dist.batch_isend_irecv(ops) if ops else []
    return Edges(works, sent, edges)


def shift_halo(v: torch.Tensor, d: int, mesh) -> torch.Tensor:
    """Sharded ops.stencil.shift: the field of neighbour values in
    direction d, with the tile-boundary row (column) fetched from the
    neighbouring rank."""
    if d not in _STEP:
        raise ValueError(f"bad direction {d}")
    edge = halo_edges(v, mesh, (d,)).wait()[d]
    ax, step = _STEP[d]
    body = (v[..., 1:, :] if step == 1 else v[..., :-1, :]) if ax == -2 \
        else (v[..., 1:] if step == 1 else v[..., :-1])
    return torch.cat([body, edge] if step == 1 else [edge, body], dim=ax)


def roll_halo(v: torch.Tensor, shift: int, axis: int, mesh) -> torch.Tensor:
    """Sharded torch.roll for |shift| <= 1 on the lattice axes (-2, -1):
    roll(v, +1, ax)[i] = v[i-1], the shift in the minus direction."""
    if shift == 0:
        return v
    assert shift in (1, -1) and axis in (-2, -1)
    if axis == -2:
        return shift_halo(v, XM if shift == 1 else XP, mesh)
    return shift_halo(v, YM if shift == 1 else YP, mesh)


# --- sharded versions of the core stencil ops ------------------------------

def _plane(D, d):
    return D[..., d, :, :, :, :]


def apply_hop_sharded_concat(D, v, mesh):
    """Baseline hop: fetch each edge, concatenate, then contract; the
    boundary rows wait behind each exchange."""
    out = _site_matvec(_plane(D, XP), shift_halo(v, XP, mesh))
    out = out + _site_matvec(_plane(D, XM), shift_halo(v, XM, mesh))
    out = out + _site_matvec(_plane(D, YP), shift_halo(v, YP, mesh))
    out = out + _site_matvec(_plane(D, YM), shift_halo(v, YM, mesh))
    return out


def apply_hop_sharded_overlap(D, v, mesh):
    """Hop with the interior/boundary split: the four edge exchanges are
    posted first, then the interior hop-sum (local data only) is computed
    while they are in flight, then they are waited on and the boundary
    rows and columns patched in. The same per-site contractions as the
    concat path; only the association of the boundary terms differs."""
    pending = halo_edges(v, mesh)
    zrow = torch.zeros_like(v[..., :1, :])
    zcol = torch.zeros_like(v[..., :, :1])
    out = _site_matvec(_plane(D, XP), torch.cat([v[..., 1:, :], zrow], -2))
    out = out + _site_matvec(_plane(D, XM),
                             torch.cat([zrow, v[..., :-1, :]], -2))
    out = out + _site_matvec(_plane(D, YP), torch.cat([v[..., 1:], zcol], -1))
    out = out + _site_matvec(_plane(D, YM), torch.cat([zcol, v[..., :-1]], -1))
    e = pending.wait()
    out[..., -1:, :] += _site_matvec(_plane(D, XP)[..., -1:, :], e[XP])
    out[..., :1, :] += _site_matvec(_plane(D, XM)[..., :1, :], e[XM])
    out[..., :, -1:] += _site_matvec(_plane(D, YP)[..., :, -1:], e[YP])
    out[..., :, :1] += _site_matvec(_plane(D, YM)[..., :, :1], e[YM])
    return out


def apply_hop_sharded(D, v, mesh, overlap: bool = True):
    """Sharded hop-sum; overlap=True (default) the interior/boundary
    schedule, False the concat baseline."""
    if overlap:
        return apply_hop_sharded_overlap(D, v, mesh)
    return apply_hop_sharded_concat(D, v, mesh)


def apply_D_sharded(D, v, mesh, overlap: bool = True):
    return _site_matvec(_plane(D, SAME), v) + apply_hop_sharded(D, v, mesh,
                                                                overlap)


def residual_sharded(D, phi, r, mesh, overlap: bool = True):
    return r - apply_D_sharded(D, phi, mesh, overlap)


def _sumsq(v):
    return torch.sum(v.abs() ** 2)


def global_norm_sharded(v, mesh):
    return torch.sqrt(psum(_sumsq(v), mesh))


def residual_norm_ratio_sharded(D, phi, r, mesh, overlap: bool = True):
    """||r - D phi|| / ||r|| over the whole lattice: both partial sums
    reduced in one all_reduce, in the field's real dtype."""
    res = residual_sharded(D, phi, r, mesh, overlap)
    num, den = psum(torch.stack([_sumsq(res), _sumsq(r)]), mesh)
    return torch.sqrt(num) / torch.sqrt(den)


def _local_solve(D0inv, hop, r):
    return -_site_matvec(D0inv, hop - r)


def jacobi_sweep_sharded(D, D0inv, phi, r, mesh, omega: float = 1.0,
                         overlap: bool = True):
    new = _local_solve(D0inv, apply_hop_sharded(D, phi, mesh, overlap), r)
    if omega == 1.0:
        return new
    return phi + omega * (new - phi)


def rbgs_sweep_sharded(D, D0inv, phi, r, mesh, omega: float = 1.0,
                       overlap: bool = True):
    lx, ly = phi.shape[-2], phi.shape[-1]
    assert lx % 2 == 0 and ly % 2 == 0, (
        "sharded red-black GS requires even local tiles")
    x = torch.arange(lx, device=phi.device)[:, None]
    y = torch.arange(ly, device=phi.device)[None, :]
    # even tiles start on an even site, so the local parity is the global
    par = ((x + y) % 2).to(phi.real.dtype)
    for mask in (1.0 - par, par):
        upd = _local_solve(D0inv, apply_hop_sharded(D, phi, mesh, overlap), r)
        phi = phi + omega * mask * (upd - phi)
    return phi


def chebyshev_smooth_sharded(D, D0inv, phi, r, degree: int, lmin: float,
                             lmax: float, mesh, overlap: bool = True):
    """Sharded Chebyshev smoother: the three-term recurrence of
    ops.smoothers.chebyshev_smooth with the halo-exchange apply. The
    interval is a per-level config constant (solver.eigs), so the apply's
    halos are its only exchanges."""
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta
    real = np.float64 if phi.dtype == torch.complex128 else np.float32

    def A(v):
        return _site_matvec(D0inv, apply_D_sharded(D, v, mesh, overlap))

    f = _site_matvec(D0inv, r)
    d = (f - A(phi)) / theta
    x = phi + d
    rho_prev = real(1.0 / sigma1)
    for _ in range(degree - 1):
        rho = real(1.0) / (real(2.0 * sigma1) - rho_prev)
        d = (complex(rho * rho_prev) * d
             + complex(real(2.0) * rho / real(delta)) * (f - A(x)))
        x = x + d
        rho_prev = rho
    return x


def smooth_sharded(D, D0inv, phi, r, n_sweeps: int, kind: str, mesh,
                   omega: float = 1.0, cheby_interval=None,
                   overlap: bool = True):
    if kind == "chebyshev":
        if cheby_interval is None:
            raise ValueError("chebyshev smoother needs cheby_interval="
                             "(lmin, lmax); see solver.eigs")
        return chebyshev_smooth_sharded(D, D0inv, phi, r, n_sweeps,
                                        *cheby_interval, mesh,
                                        overlap=overlap)
    sweep = {"jacobi": jacobi_sweep_sharded,
             "rbgs": rbgs_sweep_sharded}[kind]
    for _ in range(n_sweeps):
        phi = sweep(D, D0inv, phi, r, mesh, omega, overlap)
    return phi
