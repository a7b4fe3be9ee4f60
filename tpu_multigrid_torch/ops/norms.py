"""Global norms and dot products (reference modules_indiv.h:70-92)."""
from __future__ import annotations

import torch


def global_norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v.abs() ** 2))


def normalize(v: torch.Tensor):
    """Return (v / ||v||, ||v||) — the rescale=1 path of f_g_norm."""
    n = global_norm(v)
    return v / n, n


def cdot(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Complex inner product <u, v> = sum conj(u) * v."""
    return torch.sum(torch.conj(u) * v)
