"""U(1) gauge fields on the 2D periodic lattice: links ``U[2, L, L]``,
``U[0]`` the +x links and ``U[1]`` the +y links (counterpart of
tpu_multigrid/models/gauge.py)."""
from __future__ import annotations

import numpy as np
import torch


def identity_gauge(L: int, dtype=torch.complex128, device=None) -> torch.Tensor:
    """Free field: all links 1 (reference gauge.h:35)."""
    return torch.ones((2, L, L), dtype=dtype, device=device)


def gauge_from_phases(phases: np.ndarray, dtype=torch.complex128,
                      device=None) -> torch.Tensor:
    """U = exp(i * phase), phases a numpy array shaped [2, L, L]."""
    u = np.exp(1j * np.asarray(phases, dtype=np.float64))
    return torch.from_numpy(u).to(device=device, dtype=dtype)
