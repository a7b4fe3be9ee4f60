"""Galerkin coarse-operator construction D_c = Phi D_f Phi^dagger in the
same 5-point block-stencil format (counterpart of
tpu_multigrid/ops/galerkin.py; reference f_compute_coarse_matrix,
modules_main.h:81-185).

For each direction mu the per-fine-site triple product
M_mu(x) = Phi(x) D_mu(x) Phi(x+mu)^dagger is one batched einsum; in the
block frame, interior positions accumulate into the coarse diagonal and
face positions into the coarse off-diagonals. Every axis is counted from
the right, so D and phi_null may carry a leading configuration axis (the
JAX package vmaps over it).
"""
from __future__ import annotations

import torch

from ..config import SAME, XP, XM, YP, YM
from .stencil import shift
from .transfer import to_block_frame, _blocked


def coarse_operator(D: torch.Tensor, phi_null: torch.Tensor, quad: int,
                    bx: int, by: int) -> torch.Tensor:
    """Build D_c[C?, 5, nc, nc, Lc, Lc] from D[C?, 5, nf, nf, L, L] and
    phi_null[C?, nc, nf, L, L] for blocking quadrant `quad`."""
    P = to_block_frame(phi_null, quad)
    Db = to_block_frame(D, quad)
    Pc = torch.conj(P)

    def triple(d: int) -> torch.Tensor:
        """[C?, nc, nc, Lc, bx, Lc, by]"""
        Pn = Pc if d == SAME else shift(Pc, d)
        half = torch.einsum("...afxy,...fgxy->...agxy", P,
                            Db[..., d, :, :, :, :])
        return _blocked(torch.einsum("...agxy,...bgxy->...abxy", half, Pn),
                        bx, by)

    M0, M1, M2, M3, M4 = (triple(d) for d in (SAME, XP, XM, YP, YM))

    def bsum(m):                # over the block's positions (a, b)
        return torch.sum(m, dim=(-3, -1))

    dc0 = (bsum(M0)
           + bsum(M1[..., :bx - 1, :, :])
           + bsum(M2[..., 1:, :, :])
           + bsum(M3[..., :by - 1])
           + bsum(M4[..., 1:]))
    dc1 = torch.sum(M1[..., bx - 1, :, :], dim=-1)
    dc2 = torch.sum(M2[..., 0, :, :], dim=-1)
    dc3 = torch.sum(M3[..., by - 1], dim=-2)
    dc4 = torch.sum(M4[..., 0], dim=-2)
    return torch.stack([dc0, dc1, dc2, dc3, dc4], dim=-5)
