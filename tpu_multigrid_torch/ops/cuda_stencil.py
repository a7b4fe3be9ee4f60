"""Hand-written CUDA kernels of the smoother and SpMV paths, their
wrappers, launch counters, the L2 rule and the build-and-load code
(counterpart of tpu_multigrid/ops/pallas_stencil.py).

Kernels, each with its plain torch version. Global kernels
(csrc/stencil.cu), for levels whose sweep fits the L2:

- links_update   <- _u_smooth_vmem_kernel (pallas_stencil.py:669), via
  `wilson_u_smooth`. Plain version: gauge_stencil.smooth_u.
- links_residual <- _u_resid_vmem_kernel (pallas_stencil.py:662), via
  `wilson_u_residual`. Plain version: gauge_stencil.residual_u.
- links_residual_restrict <- the same, fused with the restriction of its
  output, via `wilson_u_residual_restrict`. Plain version:
  transfer.restrict_plain of gauge_stencil.residual_u.
- links_residual_norm <- the same, with the two norms of the level-0
  convergence check, via `wilson_u_residual_norm`. Plain version:
  gauge_stencil.residual_norm_ratio_u.
- dense_update   <- _rbgs_kernel (pallas_stencil.py:125) and
  _jacobi_kernel (pallas_stencil.py:86), via `dense_smooth`. Plain
  version: smoothers.smooth_plain.
- links_apply    <- _u_apply_vmem_kernel (pallas_stencil.py:656), via
  `wilson_u_apply`. Plain version: gauge_stencil.apply_wilson_u.
- dense_apply    <- _apply_d_kernel (pallas_stencil.py:64), via
  `dense_apply`. Plain version: stencil.apply_D.
- dense_residual <- the same kernel with a residual epilogue, r - D v,
  via `dense_residual`. Plain version: stencil.residual.

x-tiled kernels (csrc/stencil_tiled.cu), for levels past it; a block
stages a tile of phi and its halo in shared memory:

- links_update_tiled   <- _u_update_tile_kernel (pallas_stencil.py:711),
  via `wilson_u_smooth_tiled`. Plain version: gauge_stencil.smooth_u.
- links_residual_tiled <- _u_resid_tile_kernel (pallas_stencil.py:703),
  via `wilson_u_residual_tiled`. Plain version: gauge_stencil.residual_u.
- dense_update_tiled   <- _tiled_update_kernel (pallas_stencil.py:358),
  via `dense_smooth_tiled`. Plain version: smoothers.smooth_plain.
- links_apply_tiled    <- _u_apply_tile_kernel (pallas_stencil.py:695),
  via `wilson_u_apply_tiled`. Plain version: gauge_stencil.apply_wilson_u.
- dense_apply_tiled    <- _tiled_apply_kernel (pallas_stencil.py:236), via
  `dense_apply_tiled`. Plain version: stencil.apply_D.
- dense_residual_tiled <- the same kernel with the residual epilogue, via
  `dense_residual_tiled`. Plain version: stencil.residual.

The cycle's transfers (csrc/transfer.cu), which replace no TPU kernel
(the JAX package leaves them to XLA):

- restrict <- the JAX package's transfer.restrict (an einsum), via
  `transfer_restrict`. Plain version: transfer.restrict_plain.
- prolong  <- transfer.prolong, with the correction's sum in the same
  launch, via `transfer_prolong`. Plain version: transfer.prolong_plain.

`u_mode` / `smoother_mode` / `apply_mode` give the bytes a level streams
per sweep or apply against the H100's L2, from which the route functions
of ops/dispatch.py, the one module that chooses an implementation, pick
the global or the x-tiled kernel.

What bounds them on the H100 is bytes, not flops: 8 complex words a site
per links smooth and 5n^2 + 3n per dense smooth (92 at n=4), each word
once (`profiling.kernel_work`). The two global smoothers (links_update,
dense_update) run a whole smooth call, every sweep, in ONE cooperative
launch, as the TPU kernels run it in one call with the lattice in VMEM: a
grid barrier separates the red/black half-sweeps (or the Jacobi sweeps),
and each block owns a band of (batch, x) rows for all of them, its
read-only operands staged once in shared memory where the band fits
(`plan_band`; counted per launch in `band_launches`). The dense ones
take the batch in groups of G entries that share one operator (an
ensemble's k near-null candidates a configuration: fields [C, k, n, L,
L] on D [C, ...]); a band stages a group's operator rows once, and the
x-tiled grid runs a group's blocks of one tile side by side (counted in
`group_launches`). The x-tiled
smoothers make one launch per sweep: a Jacobi sweep, or a whole red-black
sweep (red, then black) in one pass over the operands, each block updating
the red sites of its tile and of a one-site ring around it before its
black sites; the dense red-black smoother, where its operands pass the
L2, runs two sweeps a launch instead (a column march, `rb_plan`; counted
in `rb_sweeps`). They write out of place, into buffers the wrapper
allocates (`_sweeps`). The links SpMV, residual and check give a thread a
pair of sites. The SpMV and residual read 16-byte loads where the lattice is
even and the operands aligned (`_links_paired`), and a block of 4 x rows
stages v over its tile and halo in shared memory for one batch entry;
the check reads a word a load through L1, sums the residual's and r's
squares in float64 and reduces the blocks' sums after a grid barrier, in
a fixed order. The dense
SpMV and residual give n lanes a pair of sites for a group of batch
entries that share one D, which they read once for the group
(`dense_groups`); the fused level-0 residual-restriction stages phi's
tile and gives bx lanes a coarse site, a fine row each, their sums added
by a warp shuffle. In the tiled ones a thread owns two
sites of a tile whose phi sits in shared memory. An SpMV moves 5n^2 + 2n
words a site (dense) or 6 (links), once each.

The wrappers are kernel-only: a tensor that is not on a CUDA device is
refused like any other input the kernel does not take (a ValueError).

The library is built at first use from the package's csrc/ sources into
tpu_multigrid_torch/_build/, keyed by a hash of the sources and flags:
one nvcc per .cu file, all started together, then one link. It is bound
with ctypes (a plain C interface: no PyTorch headers, so the build takes
seconds).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Callable

import torch

from .transfer import QUAD_OFFSETS

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")
KERNEL_KINDS = ("jacobi", "rbgs")        # the smoother kinds with a kernel

# Launch counts per kernel: each wrapper adds one where it launches.
launches = {"links_update": 0, "links_residual": 0,
            "links_residual_restrict": 0, "links_residual_norm": 0,
            "dense_update": 0,
            "links_update_tiled": 0, "links_residual_tiled": 0,
            "dense_update_tiled": 0, "links_apply": 0, "dense_apply": 0,
            "dense_residual": 0, "links_apply_tiled": 0,
            "dense_apply_tiled": 0, "dense_residual_tiled": 0,
            "restrict": 0, "prolong": 0}
# Launches of the persistent smoothers by where their read-only operands
# sat: staged in shared memory or streamed from global memory (plan_band).
band_launches = {k: {"staged": 0, "streamed": 0}
                 for k in ("links_update", "dense_update")}
# Launches of the dense smoothers whose entries came in groups of G > 1
# sharing one operator (an ensemble's near-null candidates; each is also
# counted in `launches`).
group_launches = {"dense_update": 0, "dense_update_tiled": 0}
# The red-black sweeps of dense_update_tiled by the launch that ran them:
# "multi", two a launch (the column march, rb_plan); "one", a launch a
# sweep (an odd count's last sweep, and every shape the march does not
# take). multi / (multi + one) is how often the march engages.
rb_sweeps = {"multi": 0, "one": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    for k in group_launches:
        group_launches[k] = 0
    for k in rb_sweeps:
        rb_sweeps[k] = 0
    for modes in band_launches.values():
        for k in modes:
            modes[k] = 0


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    """nvcc under CUDA_HOME if set, else on PATH, else the toolkit's
    default prefix."""
    if "CUDA_HOME" in os.environ:
        nvcc = Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"
    else:
        nvcc = Path(shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc")
    if not nvcc.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return str(nvcc)


def library_path() -> Path:
    """Path of the shared library for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtmg_stencil_{h.hexdigest()[:16]}.so"


def _check_run(cmd, proc, stdout: str, stderr: str) -> None:
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{stdout}{stderr}")


def build() -> Path:
    """Compile csrc/*.cu into the build directory unless a library for the
    same sources exists; returns its path. One nvcc per source, started
    together, then one link."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in _sources():
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        done = [(cmd, proc, *proc.communicate()) for cmd, _, proc in jobs]
        for cmd, proc, stdout, stderr in done:
            _check_run(cmd, proc, stdout, stderr)
        lib = Path(tmp) / "lib.so"
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(lib),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        _check_run(cmd, proc, proc.stdout, proc.stderr)
        os.replace(lib, out)
    return out


_P, _I, _D, _LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                   ctypes.c_longlong)
_PI = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "links_residual": (_P, _P, _P, _P, _I, _I, _D, _LL, _I, _P),
    "links_residual_norm": (_P, _P, _P, _P, _P, _I, _I, _D, _LL, _LL, _P),
    "links_residual_norm_scratch": (_I, _I, ctypes.POINTER(_LL)),
    "links_residual_restrict": (_P, _P, _P, _P, _P, _I, _I, _I, _D, _LL, _I,
                                _I, _I, _I, _P),
    "links_update": (_P, _P, _P, _P, _P, _I, _I, _D, _D, _I, _I, _LL, _I, _I,
                     _LL, _P),
    "links_update_occupancy": (_I, _LL, _PI),
    "dense_update": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL,
                     _I, _I, _D, _I, _I, _LL, _P),
    "dense_update_occupancy": (_I, _I, _I, _LL, _PI),
    "links_residual_tiled": (_P, _P, _P, _P, _I, _I, _D, _LL, _I, _I, _P),
    "links_update_tiled": (_P, _P, _P, _P, _I, _I, _D, _D, _I, _LL, _I, _I,
                           _P),
    "dense_update_tiled": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL,
                           _LL, _I, _D, _I, _I, _P),
    "links_apply": (_P, _P, _P, _I, _I, _D, _I, _P),
    "dense_apply": (_P, _P, _P, _I, _I, _I, _I, _LL, _LL, _P),
    "dense_residual": (_P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL, _P),
    "links_apply_tiled": (_P, _P, _P, _I, _I, _D, _I, _I, _P),
    "dense_apply_tiled": (_P, _P, _P, _I, _I, _I, _I, _LL, _LL, _I, _I, _P),
    "dense_residual_tiled": (_P, _P, _P, _P, _I, _I, _I, _I, _LL, _LL, _LL,
                             _I, _I, _P),
    "restrict": (_P, _P, _P) + (_I,) * 10 + (_LL,) * 4 + (_I, _P),
    "prolong": (_P, _P, _P, _P) + (_I,) * 10 + (_LL,) * 4 + (_P,),
}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        for suffix in ("c64", "c128"):
            fn = getattr(lib, f"tmg_{name}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def _entry(name: str, dtype: torch.dtype):
    suffix = {torch.complex64: "c64", torch.complex128: "c128"}.get(dtype)
    if suffix is None:
        raise TypeError(f"{name}: kernels take complex64 or complex128, "
                        f"got {dtype}")
    return getattr(_library(), f"tmg_{name}_{suffix}")


def _launch(name: str, dtype: torch.dtype, device, *args) -> None:
    fn = _entry(name, dtype)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def _check(name: str, t: torch.Tensor, like: torch.Tensor, shape) -> None:
    _on_card(name, t)
    if t.device != like.device:
        raise ValueError(f"{name} on {t.device}, expected {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {like.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _on_card(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} is on {t.device}, not on a CUDA device")


def _check_lattice(L: int, kind: str) -> None:
    if kind not in KERNEL_KINDS:
        raise NotImplementedError(f"no kernel for smoother {kind!r}")
    if kind == "rbgs" and L % 2:
        raise ValueError(f"red-black sweeps need an even lattice, got L={L}")


def _sweeps(launch, phi, n_sweeps: int, kind: str, passes=None):
    """The launches launch(src, dst, rb) of n_sweeps x-tiled smoother
    sweeps: rb=0 a Jacobi sweep, else rb whole red-black sweeps, one launch
    a sweep unless `passes` (red-black: the sweeps of each launch, summing
    to n_sweeps; rb_plan) groups them. Out of place, ping-pong between two
    buffers allocated here (phi -> A -> B -> A ...): the caller's phi is
    never written. No sweeps: a copy of phi, no launch."""
    if n_sweeps <= 0:
        return phi.clone()
    if kind != "rbgs" or passes is None:
        passes = (1,) * n_sweeps
    bufs = [torch.empty_like(phi) for _ in range(min(len(passes), 2))]
    src = phi
    for i, k in enumerate(passes):
        launch(src, bufs[i % 2], k if kind == "rbgs" else 0)
        src = bufs[i % 2]
    return src


def _check_out_of_place(src, dst) -> None:
    """A tiled sweep reads src over a halo two sites deep, where other
    blocks write dst in the same launch: dst must not overlap src."""
    a, b = src.data_ptr(), dst.data_ptr()
    if (a < b + dst.numel() * dst.element_size()
            and b < a + src.numel() * src.element_size()):
        raise ValueError("a tiled smoother sweep writes out of place: dst "
                         "overlaps src")


# --------------------------------------------------------------------------
# the L2 rule: global kernels while a level's sweep fits the L2, else x-tiled
# --------------------------------------------------------------------------

# The H100's L2 holds 50 MB. While a level's sweep streams less than that,
# what one launch reads (the neighbour rows, the other colour's sites of a
# red/black half-sweep) is still in L2 for the next, and the global kernels
# need no staging. Past it every such re-read goes to HBM, and the x-tiled
# kernels, which stage a tile and its halo in shared memory, take over.
L2_BYTES = 50 * 2**20


def u_mode(L: int, dtype=torch.complex64) -> str:
    """'global' or 'tiled' for the level-0 links kernels (counterpart of
    pallas_stencil.u_mode). A links sweep streams U, r and phi in and phi
    out: 8 complex words per site."""
    return "tiled" if 8 * L * L * dtype.itemsize > L2_BYTES else "global"


def smoother_mode(n: int, L: int, dtype=torch.complex64) -> str:
    """'global' or 'tiled' for the dense n-dof smoother kernels
    (counterpart of pallas_stencil.smoother_mode). A sweep streams D
    (5 n^2 complex words per site), D0inv (n^2), and phi in, r and phi out
    (n each)."""
    words = 6 * n * n + 3 * n
    return "tiled" if words * L * L * dtype.itemsize > L2_BYTES else "global"


def apply_mode(n: int, L: int, dtype=torch.complex64,
               links: bool = False) -> str:
    """'global' or 'tiled' for the SpMV kernels, by the rule of
    smoother_mode. A dense apply streams D (5 n^2 complex words per site),
    v in and out (n each); the links apply (links=True; n is then 2) U, v
    and out, 6 words."""
    words = 6 if links else 5 * n * n + 2 * n
    return "tiled" if words * L * L * dtype.itemsize > L2_BYTES else "global"


# --------------------------------------------------------------------------
# the band of the persistent smoothers (links_update, dense_update)
# --------------------------------------------------------------------------

# Shared memory one block of the H100 may ask for: 227 KB of the SM's
# 228 KB, above the 48 KB default only once the kernel opts in (the C side
# does, for each launch).
SMEM_BLOCK_MAX = 232448


@dataclasses.dataclass(frozen=True)
class Band:
    """How one persistent smoother launch cuts the lattice: each of `grid`
    blocks owns `rows` consecutive (batch, x) rows for every sweep (the
    last block the rest); `staged`: the block keeps its rows' read-only
    operands in `smem_bytes` of shared memory for the whole call, else it
    reads them from global memory each sweep."""
    rows: int
    grid: int
    staged: bool
    smem_bytes: int


def band_xrows(rows: int, B: int, L: int) -> int:
    """The most x rows that `rows` consecutive rows g = x B + b of a batch
    of B touch (csrc/stencil.cu band_xrows)."""
    return min(L, (rows + B - 2) // B + 1)


def links_band_bytes(L: int, rows: int, itemsize: int, B: int = 1) -> int:
    """Shared memory of a links band of `rows` (x, batch entry) rows, the B
    entries of one x next to each other: U_x of its x rows and of the row
    before (the -x hop reads U_x(x-1)) and U_y of its x rows, each once for
    the whole batch (U is shared), and r_0, r_1 of each of its rows;
    (4 rows + 1) L words at B = 1."""
    nx = band_xrows(rows, B, L)
    return (2 * nx + 1 + 2 * rows) * L * itemsize


def band_ops_rows(rows: int, G: int) -> int:
    """The most (group, x) rows that `rows` consecutive rows g = (c L + x)
    G + m of a dense smoother touch (csrc/stencil.cu band_ops_rows)."""
    return (rows + G - 2) // G + 1


def dense_band_bytes(n: int, L: int, rows: int, itemsize: int,
                     G: int = 1) -> int:
    """Shared memory of a dense band: D's 4n^2 hop planes and D0inv's n^2
    over the (group, x) rows its rows touch, once for each group of G
    entries that share them, and r's n over its rows ((5n^2 + n) L words a
    row at G = 1)."""
    return (5 * n * n * band_ops_rows(rows, G) + n * rows) * L * itemsize


def plan_band(total_rows: int, band_bytes: Callable[[int], int],
              sm_count: int, occupancy: Callable[[bool, int], int]) -> Band:
    """The band of a persistent smoother launch over `total_rows` (batch,
    x) rows: the fewest rows a block such that the operands of the band
    (band_bytes(rows)) fit SMEM_BLOCK_MAX and every block of the grid is
    resident at once (grid <= occupancy(True, smem) * sm_count, as a
    cooperative launch needs); if no band fits, streamed operands (no
    shared memory), the fewest rows a block that the card holds resident
    (occupancy(False, 0) blocks an SM). `occupancy(staged, smem)` is the
    blocks of the kernel one SM holds with `smem` bytes of shared memory:
    the card's own count on the card, any given numbers in tests."""
    def ceil_div(a, b):
        return -(-a // b)

    for rows in range(1, total_rows + 1):
        smem = band_bytes(rows)
        if smem > SMEM_BLOCK_MAX:
            break
        grid = ceil_div(total_rows, rows)
        if grid <= occupancy(True, smem) * sm_count:
            return Band(rows, grid, True, smem)
    resident = occupancy(False, 0) * sm_count
    if resident < 1:
        raise RuntimeError("the smoother kernel cannot be resident on the "
                           "card")
    rows = ceil_div(total_rows, resident)
    return Band(rows, ceil_div(total_rows, rows), False, 0)


def _occupancy(name: str, dtype: torch.dtype, *head) -> Callable:
    """occupancy(staged, smem) of the kernel `name` on the current card."""
    def occ(staged: bool, smem: int) -> int:
        blocks = ctypes.c_int(0)
        err = _entry(f"{name}_occupancy", dtype)(*head, int(staged), smem,
                                                 ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"{name} occupancy query failed: CUDA error "
                               f"{err}")
        return blocks.value
    return occ


@functools.lru_cache(maxsize=None)
def _band(name: str, dtype: torch.dtype, n: int, B: int, L: int,
          device: torch.device, G: int = 1) -> Band:
    """plan_band for one call's shapes with the card's SM count and the
    kernel's occupancy (cached per shape)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    size = torch.empty((), dtype=dtype).element_size()
    if name == "links_update":
        return plan_band(B * L, lambda k: links_band_bytes(L, k, size, B),
                         sms, _occupancy(name, dtype))
    return plan_band(B * L, lambda k: dense_band_bytes(n, L, k, size, G),
                     sms, _occupancy(name, dtype, n, int(G > 1)))


def _smooth_once(name: str, band: Band, phi, n_sweeps: int, kind: str,
                 launch) -> torch.Tensor:
    """One persistent smoother launch: launch(out, scratch, rb) with out
    and a Jacobi scratch buffer (2+ sweeps) allocated here; the caller's
    phi is left as it was. No sweeps: a copy of phi, no launch."""
    if n_sweeps <= 0:
        return phi.clone()
    out = torch.empty_like(phi)
    scratch = (torch.empty_like(phi) if kind == "jacobi" and n_sweeps > 1
               else None)
    launch(out.data_ptr(), 0 if scratch is None else scratch.data_ptr(),
           int(kind == "rbgs"))
    band_launches[name]["staged" if band.staged else "streamed"] += 1
    return out


# Largest tile of the tiled kernels: a block of 32 x 8 threads, two sites a
# thread along x; a red-black block of 16 pairs of sites along y by TX rows
# (csrc/stencil_tiled.cu).
MAX_TILE = (16, 32)


def rb_smem_bytes(n: int, TX: int, TY: int, itemsize: int) -> int:
    """Shared memory of one block of the dense red-black sweep
    (dense_rb_tiled_kernel): phi's n planes over the tile and a two-site
    halo, and the 5n^2 + n operand words (D's hop blocks, D0inv, r) of the
    black site of each of its 16 x TX threads (TX rounded up to even)."""
    threads = 16 * (TX + TX % 2)
    return itemsize * (n * (TX + 4) * (TY + 4) + (5 * n * n + n) * threads)


def default_tile(L: int):
    """(TX, TY) of the tiled kernels: the largest tile, 16 x-rows by 32
    y-columns; 8 rows below L=1024, so that a level of 256^2 still spreads
    over 256 blocks."""
    return (16 if L >= 1024 else 8), 32


def rb_tile(L: int, n: int, itemsize: int):
    """(TX, TY) of the dense red-black sweep (dense_rb_tiled_kernel): 12
    x-rows by 32 from L=1024 (6 in complex128): one block an SM, with room
    left in the SM's 228 KB for the L1 where a red load and the black copy
    of the same sector meet; 16 below (one wave of 128 blocks at 256^2);
    fewer where the block would not fit the shared memory."""
    TX = 16 if L < 1024 else (12 if itemsize <= 8 else 6)
    while rb_smem_bytes(n, TX, 32, itemsize) > SMEM_BLOCK_MAX:
        TX -= 2
    return TX, 32


# The column march (dense_rb_tiled_kernel<..., 2>, csrc/stencil_tiled.cu):
# two red-black sweeps a launch. A block owns a strip of `cols` lattice
# columns over a segment of `rows` x rows; its window adds MARCH_HALO
# columns on each side. Its four stages trail each other by 2 rows, so the
# march runs MARCH_STEPS more steps than the segment has rows, and keeps
# MARCH_OPS_ROWS rows of the window's 5n^2 + n operand words (MARCH_AHEAD
# of them in flight) and MARCH_PHI_ROWS of its n components of phi in
# shared memory. Each of a block's MARCH_THREADS threads makes at most
# MARCH_COPIES copies a step.
MARCH_HALO = 4
MARCH_STEPS = 9
MARCH_AHEAD = 2
MARCH_OPS_ROWS = 7 + MARCH_AHEAD
MARCH_PHI_ROWS = 16
MARCH_THREADS = 256
MARCH_COPIES = 12
# A march step's time, as its window's columns plus a fixed part worth
# MARCH_STEP_COLS columns (H100 80GB HBM3: ~1.0 us + ~0.012 us a column,
# n=4 complex64, 22 to 34 columns).
MARCH_STEP_COLS = 84


def march_pitch(n: int, cols: int) -> int:
    """Complex words a row of a march block's shared memory takes: the
    window's cols + 8 columns, padded so that n * pitch = 8 mod 16 (n > 1;
    the word planes of a site's n components on different bank halves);
    csrc/stencil_tiled.cu march_pitch."""
    pitch = cols + 2 * MARCH_HALO
    while n > 1 and (n * pitch) % 16 != 8:
        pitch += 2
    return pitch


def march_smem_bytes(n: int, cols: int, itemsize: int) -> int:
    """Shared memory of a march block whose strip has `cols` columns."""
    return itemsize * march_pitch(n, cols) * (
        MARCH_OPS_ROWS * (5 * n * n + n) + MARCH_PHI_ROWS * n)


@dataclasses.dataclass(frozen=True)
class RbPlan:
    """The launches of a dense x-tiled red-black smooth call: `passes`, the
    sweeps of each launch in order (2: a pass of the column march on
    strips of `cols` columns and segments of `rows` rows, `smem_bytes` a
    block; 1: a launch of the one-pass kernel)."""
    passes: tuple
    rows: int = 0
    cols: int = 0
    smem_bytes: int = 0


@functools.lru_cache(maxsize=None)
def rb_plan(n_sweeps: int, n: int, L: int, B: int, G: int, itemsize: int,
            sm_count: int, aligned: bool = True) -> RbPlan:
    """The launches of n_sweeps dense red-black sweeps of B entries in
    groups of G on L x L, from the call's shapes: a march pass for each
    pair of sweeps and one launch of the one-pass kernel for an odd count's
    last, where the march takes the call; else a launch a sweep. The march
    takes complex64, G = 1, n in {1, 2, 4}, even L and 16-byte aligned
    operands, where a sweep's operand words, 5n^2 + n a site, pass the L2
    (below it the one-pass kernel finds them there from one sweep to the
    next, and is faster: n=4 at L=256, 19 us a sweep against 44 a pass).
    Strip and segment: the even strip width whose block fits the shared
    memory and the segment rows that fill the grid's `sm_count` blocks (one
    an SM) at the least time, waves * (rows + 9) * (cols + 8 + 84)."""
    one = RbPlan((1,) * max(n_sweeps, 0))
    if (n_sweeps < 2 or G != 1 or itemsize != 8 or n not in (1, 2, 4)
            or L % 2 or not aligned
            or (5 * n * n + n) * L * L * itemsize <= L2_BYTES):
        return one

    def ceil_div(a, b):
        return -(-a // b)

    best = None
    for cols in range(2, L + 1, 2):
        smem = march_smem_bytes(n, cols, itemsize)
        if (smem > SMEM_BLOCK_MAX or (5 * n * n + 2 * n) * (
                cols // 2 + MARCH_HALO) > MARCH_COPIES * MARCH_THREADS):
            break
        strips = ceil_div(L, cols)
        rows = ceil_div(L, max(1, min(L, sm_count // (strips * B))))
        waves = ceil_div(strips * ceil_div(L, rows) * B, sm_count)
        cost = (waves * (rows + MARCH_STEPS)
                * (cols + 2 * MARCH_HALO + MARCH_STEP_COLS))
        if best is None or cost < best[0]:
            best = (cost, rows, cols, smem)
    if best is None:
        return one
    return RbPlan((2,) * (n_sweeps // 2) + (1,) * (n_sweeps % 2), *best[1:])


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _tile(tile, L: int, rb_n: int = 0, itemsize: int = 8):
    """The (TX, TY) of a call: `tile`, else default_tile(L), or rb_tile for
    a dense red-black sweep of rb_n components; refused (a ValueError)
    outside MAX_TILE, or for a dense red-black sweep past the shared memory
    of a block."""
    if tile is None:
        TX, TY = rb_tile(L, rb_n, itemsize) if rb_n else default_tile(L)
    else:
        TX, TY = map(int, tile)
    if not (1 <= TX <= MAX_TILE[0] and 1 <= TY <= MAX_TILE[1]):
        raise ValueError(f"tile {tile} outside 1..{MAX_TILE[0]} x "
                         f"1..{MAX_TILE[1]}")
    if rb_n and rb_smem_bytes(rb_n, TX, TY, itemsize) > SMEM_BLOCK_MAX:
        raise ValueError(f"tile {tile}: a red-black block of n={rb_n} would "
                         f"need {rb_smem_bytes(rb_n, TX, TY, itemsize)} "
                         f"bytes of shared memory, past {SMEM_BLOCK_MAX}")
    return TX, TY


# --------------------------------------------------------------------------
# links-only Wilson level 0 (B1, B2; x-tiled B5a, B5b)
# --------------------------------------------------------------------------

def _links_operands(U, phi, r):
    """Checks of a links kernel call: phi [B?, 2, L, L] (an optional batch
    axis), U [2, L, L] shared by the batch, r [2, L, L] shared or batched
    like phi; (B, L, r's batch stride)."""
    L = phi.shape[-1]
    batched = phi.dim() == 4
    B = phi.shape[0] if batched else 1
    _check("phi", phi, phi, ((B,) if batched else ()) + (2, L, L))
    _check("U", U, phi, (2, L, L))
    r_bs = _batch_stride("r", r, 3, (B,)) if batched else 0
    _check("r", r, phi, ((B,) if r_bs else ()) + (2, L, L))
    return B, L, r_bs


def _apply_operands(U, v) -> int:
    """Checks of a links apply call: v and U [2, L, L]; returns L."""
    L = v.shape[-1]
    _check("v", v, v, (2, L, L))
    _check("U", U, v, (2, L, L))
    return L


def aligned(*operands) -> bool:
    """Whether every operand (None: absent) starts on a 16-byte line (a fresh
    tensor does; a view may not), as 16-byte loads of two sites need."""
    return all(t is None or t.data_ptr() % 16 == 0 for t in operands)


def _links_paired(*operands) -> bool:
    """Whether the links SpMV and residual read a pair of sites in 16-byte
    loads (PAIRED): an even lattice and every operand aligned. Else they
    read a word a load, at any L."""
    return operands[0].shape[-1] % 2 == 0 and aligned(*operands)


def wilson_u_residual(U, m: float, phi, r):
    """r - D_U phi, D_U = (2+m) + links-only Wilson hop; phi and r [B?, 2,
    L, L] with an optional batch axis (r shared or batched), U [2, L, L]
    shared by the batch: one launch for the whole batch, any L.

    Replaces tpu_multigrid/ops/pallas_stencil.py _u_resid_vmem_kernel
    (via wilson_u_residual_pallas). Bound by bytes: U once, phi and r read
    once, out written once (8 complex words per site, 2 + 6 B in a
    batch)."""
    B, L, r_bs = _links_operands(U, phi, r)
    out = torch.empty_like(phi)
    _launch("links_residual", phi.dtype, phi.device, U.data_ptr(),
            phi.data_ptr(), r.data_ptr(), out.data_ptr(), B, L, float(m),
            r_bs, int(_links_paired(U, phi, r, out)))
    return out


@functools.lru_cache(maxsize=None)
def _norm_scratch(dtype: torch.dtype, B: int, L: int) -> int:
    """The float64 scratch (doubles) the check of B entries at L needs
    for its blocks' sums (csrc/stencil.cu links_norm_scratch)."""
    n = ctypes.c_longlong()
    err = _entry("links_residual_norm_scratch", dtype)(B, L, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"links_residual_norm scratch query failed: CUDA "
                           f"error {err}")
    return n.value


def wilson_u_residual_norm(U, m: float, phi, b):
    """||b - D_U phi|| / ||b|| in b's real dtype, the level-0 convergence
    check: a 0-d tensor for phi [2, L, L], one a batch entry for phi [B, 2,
    L, L] (b shared or batched), U [2, L, L] shared by the batch. One
    cooperative launch computes the residual in registers, never writes
    it, and sums its squares and b's in float64 in a fixed order (the same
    bits from call to call).

    Replaces tpu_multigrid/ops/pallas_stencil.py _u_resid_vmem_kernel (via
    wilson_u_residual_pallas) together with the norms of
    solver/cycles.residual_norm_ratio0. Bound by bytes: U 2, phi 2 and b 2
    complex words a site. Plain version: gauge_stencil.residual_norm_ratio_u
    (the links residual, then the two float64 norms)."""
    B, L, b_bs = _links_operands(U, phi, b)
    out = torch.empty((B,) if phi.dim() == 4 else (), dtype=b.real.dtype,
                      device=phi.device)
    partial = torch.empty(_norm_scratch(phi.dtype, B, L),
                          dtype=torch.float64, device=phi.device)
    _launch("links_residual_norm", phi.dtype, phi.device, U.data_ptr(),
            phi.data_ptr(), b.data_ptr(), partial.data_ptr(), out.data_ptr(),
            B, L, float(m), b_bs, partial.numel())
    return out


def links_restrict_fits(nc: int, bx: int, by: int) -> bool:
    """Whether wilson_u_residual_restrict takes nc near-null rows and bx x by
    blocks."""
    return nc in (1, 2, 4) and bx in (2, 4) and by in (2, 4)


def wilson_u_residual_restrict(U, m: float, phi, r, phi_null, quad: int,
                               bx: int, by: int):
    """transfer.restrict_plain(phi_null, r - D_U phi, quad, bx, by) in one
    launch: the level-0 residual of wilson_u_residual, restricted in
    registers, the fine residual never written. phi and r [B?, 2, L, L] (r
    shared or batched), U [2, L, L] and phi_null [nc, 2, L, L] shared by
    the batch; out [B?, nc, L / bx, L / by]. nc in {1, 2, 4}, bx and by in
    {2, 4} (links_restrict_fits); anything else raises.

    Replaces tpu_multigrid/ops/pallas_stencil.py _u_resid_vmem_kernel (via
    wilson_u_residual_pallas) together with the restriction of its output.
    Bound by bytes: U 2, phi 2, r 2, phi_null 2 nc and out nc / (bx by)
    complex words a fine site (15 at nc=4, 2 x 2). Plain version: the
    composition of transfer.restrict_plain and gauge_stencil.residual_u."""
    B, L, r_bs = _links_operands(U, phi, r)
    nc = phi_null.shape[0] if phi_null.dim() == 4 else 0
    if not links_restrict_fits(nc, bx, by) or L % bx or L % by:
        raise ValueError(f"wilson_u_residual_restrict takes nc in (1, 2, 4) "
                         f"and blocks of 2 or 4 dividing L; got phi_null "
                         f"{tuple(phi_null.shape)}, {bx} x {by}, L={L}")
    _check("phi_null", phi_null, phi, (nc, 2, L, L))
    _check_aligned("wilson_u_residual_restrict", U=U, phi=phi, r=r,
                   phi_null=phi_null)
    ox, oy = QUAD_OFFSETS[quad]
    lead = (B,) if phi.dim() == 4 else ()
    out = torch.empty(lead + (nc, L // bx, L // by), dtype=phi.dtype,
                      device=phi.device)
    _launch("links_residual_restrict", phi.dtype, phi.device, U.data_ptr(),
            phi.data_ptr(), r.data_ptr(), phi_null.data_ptr(), out.data_ptr(),
            B, nc, L, float(m), r_bs, bx, by, ox, oy)
    return out


def wilson_u_residual_tiled(U, m: float, phi, r, tile=None):
    """r - D_U phi on (TX, TY) tiles (default: default_tile(L)), with
    wilson_u_residual's batch axis (the batch entry a grid axis).

    Replaces tpu_multigrid/ops/pallas_stencil.py _u_resid_tile_kernel (via
    wilson_u_residual_pallas(mode='tiled')). Same bytes as
    wilson_u_residual, each word read once per pass from HBM."""
    TX, TY = _tile(tile, phi.shape[-1])
    B, L, r_bs = _links_operands(U, phi, r)
    out = torch.empty_like(phi)
    _launch("links_residual_tiled", phi.dtype, phi.device, U.data_ptr(),
            phi.data_ptr(), r.data_ptr(), out.data_ptr(), B, L, float(m),
            r_bs, TX, TY)
    return out


def wilson_u_smooth(U, m: float, phi, r, n_sweeps: int, kind: str = "rbgs",
                    omega: float = 1.0):
    """n_sweeps links-only Wilson smoother sweeps (Jacobi or red-black);
    phi and r [B?, 2, L, L] with an optional batch axis (r shared or
    batched), U [2, L, L] shared by the batch.

    Replaces tpu_multigrid/ops/pallas_stencil.py _u_smooth_vmem_kernel
    (via wilson_u_smooth_pallas): one cooperative launch runs every sweep
    of the whole batch, each block on its band of (x, batch entry) rows
    (plan_band over B L rows). Bound by bytes: U, r, phi in and out, 8
    complex words per site once per smooth (U once for the batch). The
    result is a new tensor; phi is left as it was."""
    B, L, r_bs = _links_operands(U, phi, r)
    _check_lattice(L, kind)
    band = _band("links_update", phi.dtype, 2, B, L, phi.device)

    def launch(out, scratch, rb):
        _launch("links_update", phi.dtype, phi.device, U.data_ptr(),
                phi.data_ptr(), r.data_ptr(), out, scratch, B, L, float(m),
                float(omega), rb, n_sweeps, r_bs, band.rows, int(band.staged),
                band.smem_bytes)

    return _smooth_once("links_update", band, phi, n_sweeps, kind, launch)


def wilson_u_smooth_tiled(U, m: float, phi, r, n_sweeps: int,
                          kind: str = "rbgs", omega: float = 1.0, tile=None):
    """wilson_u_smooth on (TX, TY) tiles (default: default_tile(L)), with
    its batch axis (the batch entry a grid axis).

    Replaces tpu_multigrid/ops/pallas_stencil.py _u_update_tile_kernel
    (via wilson_u_smooth_pallas_tiled): one launch per sweep of the whole
    batch, a red-black sweep in one pass (U, r, phi in and out, 8 complex
    words per site once per sweep). The result is a new tensor; phi is
    left as it was."""
    TX, TY = _tile(tile, phi.shape[-1])
    _links_operands(U, phi, r)
    _check_lattice(phi.shape[-1], kind)
    return _sweeps(functools.partial(_links_sweep, U, m, r, omega, TX, TY),
                   phi, n_sweeps, kind)


def _links_sweep(U, m: float, r, omega: float, TX: int, TY: int, src, dst,
                 rb: int) -> None:
    """One launch of links_update_tiled over the batch of src [B?, 2, L, L]
    (r shared or batched), src -> dst: a whole red-black sweep (rb=1) or a
    Jacobi sweep (rb=0); dst must not overlap src."""
    _check_out_of_place(src, dst)
    B = src.shape[0] if src.dim() == 4 else 1
    L, r_bs = src.shape[-1], (r[0].numel() if r.dim() == 4 else 0)
    _launch("links_update_tiled", src.dtype, src.device, U.data_ptr(),
            src.data_ptr(), r.data_ptr(), dst.data_ptr(), B, L, float(m),
            float(omega), rb, r_bs, TX, TY)


def wilson_u_apply(U, m: float, v):
    """D_U v = (2+m) v + links-only Wilson hop (v), v [2, L, L] (no batch
    axis: the kernel's batch entry is held at 1), any L.

    Replaces tpu_multigrid/ops/pallas_stencil.py _u_apply_vmem_kernel (via
    apply_wilson_u_pallas_vmem). Bound by bytes: U, v in and out, 6
    complex words per site. Plain version: gauge_stencil.apply_wilson_u."""
    L = _apply_operands(U, v)
    out = torch.empty_like(v)
    _launch("links_apply", v.dtype, v.device, U.data_ptr(), v.data_ptr(),
            out.data_ptr(), 1, L, float(m), int(_links_paired(U, v, out)))
    return out


def wilson_u_apply_tiled(U, m: float, v, tile=None):
    """D_U v on (TX, TY) tiles (default: default_tile(L)), v [2, L, L].

    Replaces tpu_multigrid/ops/pallas_stencil.py _u_apply_tile_kernel (via
    apply_wilson_u_pallas). Same bytes as wilson_u_apply, each word of v
    read once per pass from HBM (the halo from the staged tile)."""
    TX, TY = _tile(tile, v.shape[-1])
    L = _apply_operands(U, v)
    out = torch.empty_like(v)
    _launch("links_apply_tiled", v.dtype, v.device, U.data_ptr(),
            v.data_ptr(), out.data_ptr(), 1, L, float(m), TX, TY)
    return out


# --------------------------------------------------------------------------
# dense 5-point block stencil (B3, B4; x-tiled B6; SpMV B7a, x-tiled B7b)
# --------------------------------------------------------------------------

def _check_aligned(name: str, **operands) -> None:
    """The kernels that read a pair of sites in one 16-byte load need every
    operand 16-byte aligned (a fresh tensor is; a view may not be)."""
    for what, t in operands.items():
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} is not 16-byte aligned")


@dataclasses.dataclass(frozen=True)
class DenseDims:
    """The shapes of a dense smoother call: B entries of n components on an
    L x L lattice, in groups of G that share one copy of D and D0inv, and
    the element strides between copies of D, of D0inv and between entries
    of r (0: shared)."""
    B: int
    n: int
    L: int
    G: int
    d_bs: int
    dinv_bs: int
    r_bs: int

    def args(self):
        return (self.B, self.n, self.L, self.G, self.d_bs, self.dinv_bs,
                self.r_bs)


def _batch_stride(name: str, t: torch.Tensor, unbatched_ndim: int,
                  lead) -> int:
    """Element stride between copies of an operand: 0 for one shared by
    every entry, else one copy for each index of phi's first batch axis
    (lead[0]: an entry, or a group of entries)."""
    if t.dim() == unbatched_ndim:
        return 0
    if t.dim() == unbatched_ndim + 1 and lead and t.shape[0] == lead[0]:
        return t[0].numel()
    raise ValueError(f"{name} of shape {tuple(t.shape)} does not match the "
                     f"batch {tuple(lead)} of phi")


def _dense_operands(name, D, D0inv, phi, r, kind) -> DenseDims:
    """Checks of a dense smoother call. phi [n, L, L], [B, n, L, L] or [C,
    k, n, L, L] (C groups of G = k entries); D [5, n, n, L, L] and D0inv [n,
    n, L, L] shared, or with a copy for each index of phi's first batch axis
    (an entry of [B], a group of [C, k]); r shared [n, L, L] or batched like
    phi."""
    n, L = phi.shape[-3], phi.shape[-1]
    lead = tuple(phi.shape[:-3])
    if n not in (1, 2, 4):
        raise ValueError(f"{name} takes n in (1, 2, 4), got {n}")
    if len(lead) > 2:
        raise ValueError(f"{name} takes phi [C?, k?, n, L, L], got "
                         f"{tuple(phi.shape)}")
    _check_lattice(L, kind)
    _check("phi", phi, phi, lead + (n, L, L))
    d_bs = _batch_stride("D", D, 5, lead)
    dinv_bs = _batch_stride("D0inv", D0inv, 4, lead)
    _check("D", D, phi, lead[:1 if d_bs else 0] + (5, n, n, L, L))
    _check("D0inv", D0inv, phi, lead[:1 if dinv_bs else 0] + (n, n, L, L))
    r_bs = 0 if r.dim() == 3 else n * L * L
    _check("r", r, phi, (lead if r_bs else ()) + (n, L, L))
    B = 1
    for k in lead:
        B *= k
    return DenseDims(B, n, L, lead[1] if len(lead) == 2 else 1, d_bs,
                     dinv_bs, r_bs)


def dense_smooth(D, D0inv, phi, r, n_sweeps: int, kind: str = "rbgs",
                 omega: float = 1.0):
    """n_sweeps dense 5-point block-stencil sweeps,
    phi <- -D0inv (sum_mu D_mu phi(x+mu) - r), red-black or Jacobi.

    Replaces tpu_multigrid/ops/pallas_stencil.py _rbgs_kernel (via
    rbgs_smooth_pallas) and _jacobi_kernel (via jacobi_smooth_pallas):
    one cooperative launch runs every sweep, each block on its band of
    (batch, x) rows (plan_band). phi [B?, n, L, L] with an optional batch
    axis, or [C, k, n, L, L]: C groups of k entries, each group on its own
    D [C, 5, n, n, L, L] and D0inv [C, n, n, L, L] (an ensemble's k
    near-null candidates a configuration), which a band stages once for
    the group; else D [B?, 5, n, n, L, L], D0inv [B?, n, n, L, L] each
    shared or batched; r [n, L, L] shared or batched like phi. Bound by
    bytes: D's 4n^2 hop blocks and D0inv's n^2 once a copy, r, phi in and
    out, once per smooth (92 complex words per site at n=4). The result is
    a new tensor; phi is left as it was."""
    dims = _dense_operands("dense_update", D, D0inv, phi, r, kind)
    band = _band("dense_update", phi.dtype, dims.n, dims.B, dims.L,
                 phi.device, dims.G)

    def launch(out, scratch, rb):
        _launch("dense_update", phi.dtype, phi.device, D.data_ptr(),
                D0inv.data_ptr(), phi.data_ptr(), r.data_ptr(), out, scratch,
                *dims.args(), rb, n_sweeps, float(omega), band.rows,
                int(band.staged), band.smem_bytes)
        if dims.G > 1:
            group_launches["dense_update"] += 1

    return _smooth_once("dense_update", band, phi, n_sweeps, kind, launch)


def dense_smooth_tiled(D, D0inv, phi, r, n_sweeps: int, kind: str = "rbgs",
                       omega: float = 1.0, tile=None):
    """dense_smooth on (TX, TY) tiles (default: rb_tile for red-black,
    default_tile(L) for Jacobi), with the same batch axes, groups and
    per-operand batch strides; the G blocks of a group's tile run side by
    side, so HBM gives the group's operators once.

    Replaces tpu_multigrid/ops/pallas_stencil.py _tiled_update_kernel (via
    _tiled_update_call / smooth_pallas_tiled): a Jacobi sweep a launch; a
    red-black call by rb_plan, two sweeps a pass of the column march where
    it takes the call (D's 4n^2 hop blocks, D0inv and r once every two
    sweeps, phi in and out once a pass), else a sweep a launch in one pass
    (all of it once a sweep). An explicit `tile` is the one-pass kernel's,
    a launch a sweep. The result is a new tensor, the same bits whichever
    launches ran; phi is left as it was."""
    TX, TY = _tile(tile, phi.shape[-1],
                   phi.shape[-3] if kind == "rbgs" else 0, phi.element_size())
    dims = _dense_operands("dense_update_tiled", D, D0inv, phi, r, kind)
    one = functools.partial(_dense_sweep, D, D0inv, r, dims, omega, TX, TY)
    if kind != "rbgs" or tile is not None:
        return _sweeps(one, phi, n_sweeps, kind)
    plan = rb_plan(n_sweeps, dims.n, dims.L, dims.B, dims.G,
                   phi.element_size(), _sm_count(phi.device),
                   aligned(D, D0inv, phi, r))
    two = functools.partial(_dense_sweep, D, D0inv, r, dims, omega,
                            plan.rows, plan.cols)
    return _sweeps(lambda src, dst, rb: (two if rb == 2 else one)(src, dst,
                                                                   rb),
                   phi, n_sweeps, kind, plan.passes)


def _dense_sweep(D, D0inv, r, dims: DenseDims, omega: float, TX: int,
                 TY: int, src, dst, rb: int) -> None:
    """One launch of dense_update_tiled, src -> dst: a Jacobi sweep (rb=0),
    a whole red-black sweep on TX x TY tiles (rb=1), or two by the column
    march on segments of TX rows and strips of TY columns (rb=2); dims of
    _dense_operands; dst must not overlap src."""
    _check_out_of_place(src, dst)
    _launch("dense_update_tiled", src.dtype, src.device, D.data_ptr(),
            D0inv.data_ptr(), src.data_ptr(), r.data_ptr(), dst.data_ptr(),
            *dims.args(), rb, float(omega), TX, TY)
    if dims.G > 1:
        group_launches["dense_update_tiled"] += 1
    if rb:
        rb_sweeps["multi" if rb > 1 else "one"] += rb


@dataclasses.dataclass(frozen=True)
class Groups:
    """The batch of a dense SpMV or residual call: B entries in groups of G
    that share one copy of D (entry b reads copy b // G), `lead` the batch
    axis of the result ((B,) or ()), and the element strides between
    copies of D, entries of v and of r (0: shared)."""
    B: int
    G: int
    lead: tuple
    d_bs: int
    v_bs: int
    r_bs: int


def dense_groups(name: str, D, v, r=None) -> Groups:
    """Shapes of a dense SpMV or residual call: D [E?, 5, n, n, L, L], v [B?,
    n, L, L], r (residual) shaped like the result or shared [n, L, L]. A D
    without a batch axis is shared by every entry (G = B); with E copies and
    B entries of v, E divides B and the entries go in E groups of G = B / E
    (G = 1: a copy an entry; the NTL copies of an ensemble: G = 4); v without
    a batch axis is shared by the E entries. Raises ValueError for shapes
    that do not fit together."""
    n, L = v.shape[-3], v.shape[-1]
    if D.dim() not in (5, 6) or v.dim() not in (3, 4) or (
            tuple(D.shape[-5:]) != (5, n, n, L, L)):
        raise ValueError(f"{name}: D {tuple(D.shape)} and v {tuple(v.shape)} "
                         "are not [E?, 5, n, n, L, L] and [B?, n, L, L]")
    E = D.shape[0] if D.dim() == 6 else None
    Bv = v.shape[0] if v.dim() == 4 else None
    if E and Bv and Bv % E:
        raise ValueError(f"{name}: {Bv} entries of v do not split into "
                         f"groups over {E} copies of D")
    B = Bv or E or 1
    G = B // E if E else B
    lead = (B,) if (E or Bv) else ()
    r_bs = 0
    if r is not None:
        if tuple(r.shape) not in (lead + (n, L, L), (n, L, L)):
            raise ValueError(f"{name}: r {tuple(r.shape)} is not "
                             f"{lead + (n, L, L)} or {(n, L, L)}")
        r_bs = n * L * L if r.dim() == 4 else 0
    return Groups(B, G, lead, D[0].numel() if E else 0,
                  n * L * L if Bv else 0, r_bs)


def _dense_call(name, D, v, r, *tile):
    """out = D v (r None) or r - D v by the kernel `name`, the batch in
    groups (dense_groups); out is allocated here and never aliases v."""
    n, L = v.shape[-3], v.shape[-1]
    if n not in (1, 2, 4):
        raise ValueError(f"{name} takes n in (1, 2, 4), got {n}")
    g = dense_groups(name, D, v, r)
    _check("v", v, v, tuple(v.shape))
    _check("D", D, v, tuple(D.shape))
    if r is not None:
        _check("r", r, v, tuple(r.shape))
    if not tile:                # the global kernel: pairs of sites
        if L % 2:
            raise ValueError(f"{name} takes an even lattice, got L={L}")
        _check_aligned(name, D=D, v=v, r=r)
    out = torch.empty(g.lead + (n, L, L), dtype=v.dtype, device=v.device)
    ptrs = (D.data_ptr(), v.data_ptr()) + (
        () if r is None else (r.data_ptr(),)) + (out.data_ptr(),)
    strides = (g.d_bs, g.v_bs) + (() if r is None else (g.r_bs,))
    _launch(name, v.dtype, v.device, *ptrs, g.B, n, L, g.G, *strides, *tile)
    return out


def dense_apply(D, v):
    """Dense 5-point block SpMV out = D v, (D v)(x) = sum_mu D_mu(x) v(x+mu).

    Replaces tpu_multigrid/ops/pallas_stencil.py _apply_d_kernel (via
    apply_D_pallas). D [E?, 5, n, n, L, L] and v [B?, n, L, L], n in {1, 2,
    4}, L even: a D shared by the batch, or E copies each shared by a group
    of B / E entries (dense_groups), v batched or shared. Bound by bytes:
    D's 5 n^2 words once a group, v in and out (5n^2 + 2n complex words a
    site unbatched). Plain version: stencil.apply_D."""
    return _dense_call("dense_apply", D, v, None)


def dense_residual(D, phi, r):
    """r - D phi by dense_apply's kernel with its residual epilogue (the same
    groups; r shaped like the result or shared). Bound by bytes: 5n^2 + 3n
    complex words a site unbatched (92 at n=4). Plain version:
    stencil.residual."""
    return _dense_call("dense_residual", D, phi, r)


def dense_apply_tiled(D, v, tile=None):
    """dense_apply on (TX, TY) tiles (default: default_tile(L)), with the
    same groups.

    Replaces tpu_multigrid/ops/pallas_stencil.py _tiled_apply_kernel (via
    apply_D_pallas_tiled): v's tile and its periodic halo are staged in
    shared memory, so each word of v crosses HBM once per pass."""
    return _dense_call("dense_apply_tiled", D, v, None,
                       *_tile(tile, v.shape[-1]))


def dense_residual_tiled(D, phi, r, tile=None):
    """dense_residual on (TX, TY) tiles: dense_apply_tiled's kernel with the
    residual epilogue."""
    return _dense_call("dense_residual_tiled", D, phi, r,
                       *_tile(tile, phi.shape[-1]))


# --------------------------------------------------------------------------
# the cycle's transfers: restriction and prolongation (csrc/transfer.cu)
# --------------------------------------------------------------------------

def _transfer_operand(name: str, t, ndim: int, nq):
    """Checks of one operand of a transfer call: t [E?, nq?, *entry] with
    `ndim` entry axes, each entry contiguous; nq None: no copy axis.
    Returns (E or None, the element stride between entries of the outer
    axis, between copies), a stride 0 where the axis is absent or of size
    1 (shared)."""
    head = t.dim() - ndim - (nq is not None)
    if head not in (0, 1) or (nq is not None and t.shape[head] != nq):
        raise ValueError(f"{name} of shape {tuple(t.shape)}: the transfer "
                         f"kernels take [E?, {'nq, ' if nq else ''}"
                         f"{ndim} axes]")
    stride, want = t.stride(), 1
    for k in range(t.dim() - 1, t.dim() - ndim - 1, -1):
        if stride[k] != want and t.shape[k] > 1:
            raise ValueError(f"{name} must be contiguous in its last {ndim} "
                             "axes")
        want *= t.shape[k]
    E = t.shape[0] if head else None
    outer = stride[0] if head and t.shape[0] > 1 else 0
    copy = stride[head] if nq is not None and nq > 1 else 0
    return E, outer, copy


def _transfer_call(phi_null, field, quad, bx: int, by: int,
                   copies_on_field: bool):
    """The checks and launch shapes shared by transfer_restrict and
    transfer_prolong: phi_null [E?, nq?, nc, nf, Lx, Ly] (nq: quad None,
    copy q at quadrant q + 1), `field` the other input, [E?, nq?, 3 axes]
    (its copy axis only where copies_on_field). Returns (lead, nq or None, args) with args the
    kernel's (E, NQ, nc, nf, Lx, Ly, bx, by, ox_mask, oy_mask, phi strides,
    field strides)."""
    if field.device != phi_null.device:
        raise ValueError(f"phi_null on {phi_null.device}, the field on "
                         f"{field.device}")
    if field.dtype != phi_null.dtype:
        raise TypeError(f"phi_null has dtype {phi_null.dtype}, the field "
                        f"{field.dtype}")
    if phi_null.dim() < 4:
        raise ValueError(f"phi_null of shape {tuple(phi_null.shape)} is not "
                         "[..., nc, nf, Lx, Ly]")
    nc, nf, Lx, Ly = phi_null.shape[-4:]
    if Lx % bx or Ly % by or bx < 1 or by < 1:
        raise ValueError(f"blocks {bx} x {by} do not divide {Lx} x {Ly}")
    nq = None
    if quad is None:
        if phi_null.dim() < 5:
            raise ValueError("the copies form takes phi_null [E?, nq, nc, nf, "
                             f"Lx, Ly], got {tuple(phi_null.shape)}")
        nq = phi_null.shape[-5]
        quads = range(1, nq + 1)
    else:
        quads = (quad,)
    ox_mask = oy_mask = 0
    for q, qd in enumerate(quads):
        ox, oy = QUAD_OFFSETS[qd]
        ox_mask |= (ox == -1) << q
        oy_mask |= (oy == -1) << q
    Ep, p_so, p_sq = _transfer_operand("phi_null", phi_null, 4, nq)
    Ef, f_so, f_sq = _transfer_operand(
        "the field", field, 3, nq if copies_on_field else None)
    if Ep and Ef and Ep != Ef and 1 not in (Ep, Ef):
        raise ValueError(f"phi_null's batch {Ep} and the field's {Ef} differ")
    E = max(Ep or 1, Ef or 1)
    lead = (E,) if (Ep or Ef) else ()
    args = (E, nq or 1, nc, nf, Lx, Ly, bx, by, ox_mask, oy_mask, p_so, p_sq,
            f_so, f_sq)
    return lead, nq, args


def transfer_restrict(phi_null, vf, quad, bx: int, by: int):
    """transfer.restrict_plain in one launch of transfer_restrict_kernel:
    vc[..., c, X, Y] = sum_{f, a, b} phi_null[..., c, f, s] vf[..., f, s],
    s = (bx X + a + ox, by Y + b + oy) mod L with (ox, oy) the quadrant's
    QUAD_OFFSETS. phi_null [E?, nc, nf, Lx, Ly] and vf [E?, nf, Lx, Ly],
    each with or without the batch axis (without: shared), each entry
    contiguous; quad None: the NTL copies, phi_null [E?, nq, nc, nf, Lx,
    Ly], copy q at quadrant q + 1, vf shared by the copies, the result [E?,
    nq, nc, Lx / bx, Ly / by]. Other shapes, devices or strides raise.

    Replaces no TPU kernel (the JAX package's transfer.restrict is an
    einsum). Bound by bytes: phi_null nc nf words a fine site a copy, vf nf
    a field and the result nc / (bx by) an entry, each once; the einsum it
    replaces copied phi_null into the block frame each call and ran a
    batched gemv. Plain version: transfer.restrict_plain."""
    _on_card("vf", vf)
    lead, nq, args = _transfer_call(phi_null, vf, quad, bx, by, False)
    E, NQ, nc, nf, Lx, Ly = args[:6]
    if tuple(vf.shape[-3:]) != (nf, Lx, Ly):
        raise ValueError(f"vf of shape {tuple(vf.shape)} does not match "
                         f"phi_null {tuple(phi_null.shape)}")
    out = torch.empty(lead + ((nq,) if nq else ()) + (nc, Lx // bx, Ly // by),
                      dtype=vf.dtype, device=vf.device)
    paired = (vf.dtype == torch.complex64 and args[9] == 0 and by % 2 == 0
              and Ly % 2 == 0 and phi_null.data_ptr() % 16 == 0
              and vf.data_ptr() % 16 == 0
              and all(st % 2 == 0 for st in args[10:]))
    _launch("restrict", vf.dtype, vf.device, phi_null.data_ptr(),
            vf.data_ptr(), out.data_ptr(), *args, int(paired))
    return out


def transfer_prolong(phi_null, vc, quad, bx: int, by: int, base=None):
    """transfer.prolong_plain in one launch of transfer_prolong_kernel:
    out[..., f, s] = base[..., f, s] + sum_c conj(phi_null[..., c, f, s])
    vc[..., c, X, Y], s as in transfer_restrict; base (None: 0) shaped like
    the result and contiguous, never written. phi_null [E?, nc, nf, Lx, Ly]
    and vc [E?, nc, Lx / bx, Ly / by], each with or without the batch axis;
    quad None: the NTL copies, phi_null [E?, nq, nc, nf, Lx, Ly], vc [E?,
    nq, nc, Lx / bx, Ly / by], the result [E?, nq, nf, Lx, Ly].

    Replaces no TPU kernel. Bound by bytes: phi_null nc nf words a fine
    site a copy, vc nc / (bx by), base nf and the result nf an entry, each
    once; conj(phi_null) is formed in registers. Plain version:
    transfer.prolong_plain."""
    _on_card("vc", vc)
    lead, nq, args = _transfer_call(phi_null, vc, quad, bx, by, True)
    E, NQ, nc, nf, Lx, Ly = args[:6]
    if tuple(vc.shape[-3:]) != (nc, Lx // bx, Ly // by):
        raise ValueError(f"vc of shape {tuple(vc.shape)} does not match "
                         f"phi_null {tuple(phi_null.shape)} in {bx} x {by} "
                         "blocks")
    shape = lead + ((nq,) if nq else ()) + (nf, Lx, Ly)
    if base is not None:
        _check("base", base, vc, shape)
    out = torch.empty(shape, dtype=vc.dtype, device=vc.device)
    _launch("prolong", vc.dtype, vc.device, phi_null.data_ptr(),
            vc.data_ptr(), 0 if base is None else base.data_ptr(),
            out.data_ptr(), *args)
    return out
