"""Aggregation-based transfer operators: restriction / prolongation with
near-null vectors, block normalization and quadrant blocking (counterpart
of tpu_multigrid/ops/transfer.py; reference near_null.h:217-264,
modules_indiv.h:6-14).

Near-null vectors are ``phi_null[nc, nf, L, L]``. Quadrant q offsets the
block origin by QUAD_OFFSETS[q]; a pair of rolls moves the lattice into
the "block frame" where blocks are axis-aligned, and a reshape to
[.., Lc, bx, Lc, by] exposes them.

`restrict_plain`, `prolong_plain`, `block_dot`, `block_norms`,
`block_normalize` and the block-frame helpers take any number of leading
batch axes on their fields and on phi_null, broadcast against each other:
a batch of right-hand sides on one hierarchy (phi_null shared) or a batch
of hierarchies (phi_null [B, nc, nf, L, L]), as the JAX package gets by
vmap. `normalize_rows`, `ortho_pass` and `check_ortho` count the row axis
from the right (-4), so a leading configuration axis passes through them.

`restrict_plain` and `prolong_plain` are the plain versions of the
cycle's transfers, beside the kernels of csrc/transfer.cu (ops/dispatch
chooses); quad None: the NTL copies, copy q of phi_null [..., nq, nc, nf,
L, L] at quadrant q + 1.
"""
from __future__ import annotations

import torch

QUAD_OFFSETS = {1: (0, 0), 2: (-1, 0), 3: (-1, -1), 4: (0, -1)}


def to_block_frame(v: torch.Tensor, quad: int) -> torch.Tensor:
    """Roll so fine site (base + (a,b)) lands at block position (a,b)."""
    ox, oy = QUAD_OFFSETS[quad]
    if ox:
        v = torch.roll(v, -ox, dims=-2)
    if oy:
        v = torch.roll(v, -oy, dims=-1)
    return v


def from_block_frame(v: torch.Tensor, quad: int) -> torch.Tensor:
    ox, oy = QUAD_OFFSETS[quad]
    if ox:
        v = torch.roll(v, ox, dims=-2)
    if oy:
        v = torch.roll(v, oy, dims=-1)
    return v


def _blocked(v: torch.Tensor, bx: int, by: int) -> torch.Tensor:
    """[..., Lx, Ly] -> [..., Lx/bx, bx, Ly/by, by]."""
    Lx, Ly = v.shape[-2], v.shape[-1]
    return v.reshape(*v.shape[:-2], Lx // bx, bx, Ly // by, by)


def _batched_like(pb: torch.Tensor, lead) -> torch.Tensor:
    """phi_null's blocks pb [..., nc, nf, Lc, bx, Lc, by] expanded to the
    leading (batch) axes `lead` of the field they act on. The product then
    runs over the batch as over the blocks, one small matrix-vector product
    each, as unbatched; left to broadcasting, the batch becomes the N of a
    GEMM with N = batch, whose tiles waste most of their work on the card
    (PERF.md §6)."""
    if pb.shape[:-6] == tuple(lead):
        return pb
    lead = torch.broadcast_shapes(pb.shape[:-6], tuple(lead))
    return pb.expand(*lead, *pb.shape[-6:])


def restrict_plain(phi_null: torch.Tensor, vf: torch.Tensor, quad, bx: int,
                   by: int) -> torch.Tensor:
    """vec_c = sum_block Phi vf (reference near_null.h:217-240) by einsum
    over the blocks of the rolled fields; quad None: the copies' stacked."""
    if quad is None:
        return torch.stack([
            restrict_plain(phi_null[..., q, :, :, :, :], vf, q + 1, bx, by)
            for q in range(phi_null.shape[-5])], dim=-4)
    vb = _blocked(to_block_frame(vf, quad), bx, by)
    pb = _batched_like(_blocked(to_block_frame(phi_null, quad), bx, by),
                       vb.shape[:-5])
    return torch.einsum("...cfXaYb,...fXaYb->...cXY", pb, vb).contiguous()


def prolong_plain(phi_null: torch.Tensor, vc: torch.Tensor, quad, bx: int,
                  by: int, base: torch.Tensor | None = None) -> torch.Tensor:
    """vec_f = Phi^dagger vec_c (reference near_null.h:242-264) by einsum
    over the blocks of the rolled phi_null, then base + it; as restrict's."""
    if quad is None:
        out = torch.stack([
            prolong_plain(phi_null[..., q, :, :, :, :],
                          vc[..., q, :, :, :], q + 1, bx, by)
            for q in range(phi_null.shape[-5])], dim=-4)
        return out if base is None else base + out
    pb = _batched_like(_blocked(to_block_frame(phi_null, quad), bx, by),
                       vc.shape[:-3])
    vfb = torch.einsum("...cfXaYb,...cXY->...fXaYb", torch.conj(pb), vc)
    Lx, Ly = phi_null.shape[-2], phi_null.shape[-1]
    out = from_block_frame(vfb.reshape(*vfb.shape[:-4], Lx, Ly),
                           quad).contiguous()
    return out if base is None else base + out


def block_norms(v: torch.Tensor, quad: int, bx: int, by: int) -> torch.Tensor:
    """Per-block 2-norm over (dof, block sites): [..., Lc, Lc] real."""
    vb = _blocked(to_block_frame(v, quad), bx, by)
    return torch.sqrt(torch.sum(vb.abs() ** 2, dim=(-5, -3, -1)))


def block_normalize(v: torch.Tensor, quad: int, bx: int, by: int) -> torch.Tensor:
    """Divide each block by its norm (reference f_block_norm,
    modules_indiv.h:94-135); NaN / tiny-norm guards are the caller's."""
    vb = _blocked(to_block_frame(v, quad), bx, by)
    norms = torch.sqrt(torch.sum(vb.abs() ** 2, dim=(-5, -3, -1)))
    vb = vb / norms[..., None, :, None, :, None]
    return from_block_frame(vb.reshape(v.shape), quad)


def block_dot(u: torch.Tensor, v: torch.Tensor, quad: int, bx: int, by: int):
    """Per-block complex dot <u, v> = sum_block conj(u)·v : [..., Lc, Lc]."""
    ub = _blocked(to_block_frame(u, quad), bx, by)
    vb = _blocked(to_block_frame(v, quad), bx, by)
    return torch.einsum("...fXaYb,...fXaYb->...XY", torch.conj(ub), vb)


def ortho_pass(phi_null: torch.Tensor, quad: int, bx: int, by: int):
    """One block-Gram-Schmidt pass over the near-null rows: row d1 is
    orthogonalized against rows d2 < d1 per block, then block-normalized
    (reference Near_null::f_ortho, near_null.h:97-173)."""
    rows = list(phi_null.unbind(-4))
    for d1 in range(len(rows)):
        cur = rows[d1]
        for d2 in range(d1):
            prev = rows[d2]
            coef = (block_dot(prev, cur, quad, bx, by)
                    / block_norms(prev, quad, bx, by))
            cb = _blocked(to_block_frame(cur, quad), bx, by)
            pb = _blocked(to_block_frame(prev, quad), bx, by)
            cb = cb - coef[..., None, :, None, :, None] * pb
            cur = from_block_frame(cb.reshape(cur.shape), quad)
        rows[d1] = block_normalize(cur, quad, bx, by)
    return torch.stack(rows, dim=-4)


def normalize_rows(phi_null: torch.Tensor, quad: int, bx: int, by: int):
    """Block-normalize every near-null row (reference f_norm_nn,
    near_null.h:24-48)."""
    return torch.stack([block_normalize(row, quad, bx, by)
                        for row in phi_null.unbind(-4)], dim=-4)


def check_ortho(phi_null: torch.Tensor, quad: int, bx: int, by: int):
    """Max pairwise block-dot magnitude between distinct rows (reference
    f_check_ortho, near_null.h:175-214): a 0-d tensor, or one a
    configuration of phi_null's leading axes."""
    rows = phi_null.unbind(-4)
    worst = torch.zeros(phi_null.shape[:-4], dtype=phi_null.real.dtype,
                        device=phi_null.device)
    for d1 in range(len(rows)):
        for d2 in range(d1):
            dots = block_dot(rows[d1], rows[d2], quad, bx, by)
            worst = torch.maximum(worst, dots.abs().amax(dim=(-2, -1)))
    return worst
