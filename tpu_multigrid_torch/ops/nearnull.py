"""Adaptive near-null vector generation (counterpart of
tpu_multigrid/ops/nearnull.py; reference Level::f_near_null,
level.h:177-249).

The k candidates relax D x = 0 from random starts as ONE batch through
`smooth` (the dense_update kernel on CUDA tensors, D shared by the
batch), renormalized each globally every `iters_per_norm` sweeps, or,
with joint_qr, orthonormalized together. Wilson candidates are split
chirally into upper/lower rows (level.h:223-248).
"""
from __future__ import annotations

import math

import torch

from .smoothers import smooth


def relax_null_vectors(D, D0inv, starts, null_iters: int,
                       iters_per_norm: int, smoother: str, omega: float = 1.0,
                       joint_qr: bool = False, pallas: str = "auto"):
    """Relax the start vectors toward the near-null space of D.

    starts: [k, nf, L, L]. Returns the same shape.

    joint_qr=False is the reference's scheme: each candidate relaxes
    independently and is normalized globally every iters_per_norm sweeps.
    joint_qr=True (MGConfig.null_joint_qr, beyond the reference)
    orthonormalizes the candidate set by global modified Gram-Schmidt at
    the start and at every renormalization: block power iteration toward
    the lowest k modes, robust where independent candidates all collapse
    onto the lowest mode (<= ~4^2 setup levels).
    """
    zero_r = torch.zeros_like(starts[0])
    renorm = _mgs if joint_qr else _normalize_each
    v = _mgs(starts) if joint_qr else starts
    for _ in range(max(null_iters // iters_per_norm, 1)):
        v = renorm(smooth(D, D0inv, v, zero_r, iters_per_norm, smoother,
                          omega, pallas=pallas))
    return v


def _normalize_each(v):
    return v / torch.sqrt(torch.sum(v.abs() ** 2, dim=(1, 2, 3),
                                    keepdim=True))


def _mgs(vs):
    """Global modified Gram-Schmidt over the candidate axis."""
    out = []
    for v in vs:
        for u in out:
            v = v - u * torch.sum(torch.conj(u) * v)
        n = torch.sqrt(torch.sum(v.abs() ** 2))
        out.append(v / torch.where(n > 0, n, torch.ones_like(n)))
    return torch.stack(out)


def candidates_to_phi_null(vecs: torch.Tensor, stencil: str, nc: int):
    """Pack relaxed candidates into phi_null[nc, nf, L, L].

    laplace: row d = conj(vec_d) (level.h:218-219).
    wilson:  vec_d (d < nc/2) splits chirally into rows d and nc/2 + d.
    """
    k, nf = vecs.shape[:2]
    if stencil == "laplace":
        if k != nc:
            raise ValueError(f"laplace needs {nc} candidates, got {k}")
        return torch.conj(vecs)
    if k != nc // 2:
        raise ValueError(f"wilson needs {nc // 2} candidates, got {k}")
    half = nf // 2
    zeros = torch.zeros_like(vecs[:, :half])
    upper = torch.cat([torch.conj(vecs[:, :half]), zeros], dim=1)
    lower = torch.cat([zeros, torch.conj(vecs[:, half:])], dim=1)
    return torch.cat([upper, lower], dim=0)


def random_starts(generator: torch.Generator, k: int, nf: int, L: int,
                  dtype, device=None) -> torch.Tensor:
    """Random real uniform(-pi, pi) starts, as the reference's
    f_init_near_null_vector(rand=1) (modules_indiv.h:51-68). Drawn on the
    generator's device, then moved to `device`."""
    u = torch.rand((k, nf, L, L), generator=generator, dtype=torch.float64,
                   device=generator.device)
    return ((2.0 * u - 1.0) * math.pi).to(device=device, dtype=dtype)
