"""Adaptive near-null vector generation (counterpart of
tpu_multigrid/ops/nearnull.py; reference Level::f_near_null,
level.h:177-249).

The k candidates relax D x = 0 from random starts as ONE batch through
`smooth` (the dense_update kernel on CUDA tensors, D shared by the
batch), renormalized each globally every `iters_per_norm` sweeps. Wilson
candidates are split chirally into upper/lower rows (level.h:223-248).
"""
from __future__ import annotations

import math

import torch

from .smoothers import smooth


def relax_null_vectors(D, D0inv, starts, null_iters: int,
                       iters_per_norm: int, smoother: str, omega: float = 1.0,
                       joint_qr: bool = False, pallas: str = "auto"):
    """Relax each start vector toward the near-null space of D, each
    candidate independently (the reference's scheme).

    starts: [k, nf, L, L]. Returns the same shape, each candidate globally
    normalized. joint_qr (MGConfig.null_joint_qr) is not ported yet.
    """
    if joint_qr:
        raise NotImplementedError("null_joint_qr is not ported yet")
    zero_r = torch.zeros_like(starts[0])
    v = starts
    for _ in range(max(null_iters // iters_per_norm, 1)):
        v = smooth(D, D0inv, v, zero_r, iters_per_norm, smoother, omega,
                   pallas=pallas)
        v = v / torch.sqrt(torch.sum(v.abs() ** 2, dim=(1, 2, 3),
                                     keepdim=True))
    return v


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
