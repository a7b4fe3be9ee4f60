"""Configuration of the PyTorch port: `MGConfig`, field for field with the
JAX package's `tpu_multigrid.config.MGConfig` (the reference's parameter
surface, params.h:42-69), with `cdtype`/`rdtype` as torch dtypes.

`tests/test_torch_config.py` pins the field names and defaults against
the JAX dataclass so the two cannot drift.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

STENCILS = ("laplace", "wilson")
SMOOTHERS = ("jacobi", "rbgs", "gs_lex", "chebyshev")

# Stencil direction index convention (reference D(X, idx), level.h:8):
#   0 = same site, 1 = +x, 2 = -x, 3 = +y, 4 = -y
SAME, XP, XM, YP, YM = 0, 1, 2, 3, 4


@dataclasses.dataclass(frozen=True)
class MGConfig:
    """Static configuration of an adaptive-MG solve (see the JAX
    `MGConfig` for each knob's meaning; the fields and defaults agree).

    `pallas` keeps its JAX name: 'auto' runs the hand-written CUDA kernels
    on CUDA tensors, 'off' forces the plain torch versions.
    """

    L: int = 64
    stencil: str = "laplace"
    m: float = 0.1
    nlevels: int = 2
    block_x: int = 2
    block_y: int = 2
    num_iters: int = 20
    smoother: str = "rbgs"
    omega: float = 1.0
    cheby_lmax: Optional[Tuple[float, ...]] = None
    cheby_lmin_frac: float = 0.25

    ntl: bool = False
    n_copies: int = 4
    min_res: bool = True
    ntl_combine: str = "auto"
    minres_src: str = "auto"

    gen_null: bool = True
    null_iters: int = 500
    iters_per_norm: int = 4
    ortho_passes: int = 2
    null_joint_qr: bool = False

    max_iters: int = 50000
    res_threshold: float = 1.0e-13
    div_threshold: float = 1.0e6
    write_interval: int = 1

    quad: int = 1
    cycle_gamma: int = 1
    beta: float = 32.0
    seed: int = 4302529

    n_color: int = 1
    ndof_coarse: Optional[int] = None
    dtype: str = "complex128"
    pallas: str = "auto"
    links: str = "auto"
    halo_overlap: bool = True

    def __post_init__(self):
        if self.stencil not in STENCILS:
            raise ValueError(
                f"stencil must be one of {STENCILS}, got {self.stencil!r}")
        if self.smoother not in SMOOTHERS:
            raise ValueError(
                f"smoother must be one of {SMOOTHERS}, got {self.smoother!r}")
        if self.ntl and self.nlevels < 2:
            raise ValueError("non-telescoping needs nlevels >= 2")
        if not (1 <= self.n_copies <= 4):
            raise ValueError("n_copies must be in 1..4")
        if not (1 <= self.quad <= 4):
            raise ValueError("quad must be in 1..4")
        if self.ntl_combine not in ("auto", "minres", "avg_prolong",
                                    "avg_coarse"):
            raise ValueError(f"bad ntl_combine {self.ntl_combine!r}")
        if self.links not in ("auto", "on", "off"):
            raise ValueError(f"bad links {self.links!r}")
        if self.pallas not in ("auto", "off"):
            raise ValueError(f"bad pallas {self.pallas!r}")
        if self.dtype not in ("complex64", "complex128"):
            raise ValueError(f"bad dtype {self.dtype!r}")
        if self.smoother == "chebyshev":
            if (self.cheby_lmax is None
                    or len(self.cheby_lmax) != self.nlevels + 1):
                raise ValueError(
                    "chebyshev smoother needs cheby_lmax with one entry "
                    "per level (nlevels+1)")
        if self.ndof_coarse is not None:
            if self.stencil == "wilson" and self.ndof_coarse % 2:
                raise ValueError("wilson coarse dof must be even "
                                 "(chirality-split rows)")
            if self.ndof_coarse < 1:
                raise ValueError("ndof_coarse must be >= 1")
        if self.nlevels > self.max_levels:
            raise ValueError(
                f"too many levels {self.nlevels}: L={self.L} with block "
                f"{self.block_x} supports at most {self.max_levels}")
        if self.L % (self.block_x ** self.nlevels) != 0:
            raise ValueError("L must be divisible by block^nlevels")

    # ---- derived geometry (reference params.h:72-83, 114-121) ----

    @property
    def max_levels(self) -> int:
        return int(math.ceil(math.log2(self.L) / math.log2(self.block_x)))

    @property
    def spinor_dim(self) -> int:
        return 2 if self.stencil == "wilson" else 1

    @property
    def n_dof_scale(self) -> int:
        if self.ndof_coarse is not None:
            return self.ndof_coarse
        return 4 if self.stencil == "wilson" else 2

    @property
    def sizes(self) -> Tuple[int, ...]:
        s = [self.L]
        for _ in range(self.nlevels):
            s.append(s[-1] // self.block_x)
        return tuple(s)

    @property
    def n_dof(self) -> Tuple[int, ...]:
        n0 = 2 if self.stencil == "wilson" else 1
        return (n0,) + (self.n_dof_scale,) * self.nlevels

    @property
    def scale0(self) -> float:
        return 1.0 / ((2.0 if self.stencil == "wilson" else 4.0) + self.m)

    @property
    def cheby_intervals(self) -> Tuple[Tuple[float, float], ...]:
        return tuple((self.cheby_lmin_frac * l, 1.02 * l)
                     for l in self.cheby_lmax)

    @property
    def cdtype(self) -> torch.dtype:
        return torch.complex128 if self.dtype == "complex128" else torch.complex64

    @property
    def rdtype(self) -> torch.dtype:
        return torch.float64 if self.dtype == "complex128" else torch.float32

    def replace(self, **kw) -> "MGConfig":
        return dataclasses.replace(self, **kw)
