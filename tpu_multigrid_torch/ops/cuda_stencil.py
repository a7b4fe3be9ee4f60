"""Hand-written CUDA kernels of the smoother and SpMV paths, their
wrappers, launch counters, their dispatch and the build-and-load code
(counterpart of tpu_multigrid/ops/pallas_stencil.py).

Kernels, each with its plain torch version. Global kernels
(csrc/stencil.cu), for levels whose sweep fits the L2:

- links_update   <- _u_smooth_vmem_kernel (pallas_stencil.py:669), via
  `wilson_u_smooth`. Plain version: gauge_stencil.smooth_u.
- links_residual <- _u_resid_vmem_kernel (pallas_stencil.py:662), via
  `wilson_u_residual`. Plain version: gauge_stencil.residual_u.
- dense_update   <- _rbgs_kernel (pallas_stencil.py:125) and
  _jacobi_kernel (pallas_stencil.py:86), via `dense_smooth`. Plain
  version: smoothers.smooth_plain.
- links_apply    <- _u_apply_vmem_kernel (pallas_stencil.py:656), via
  `wilson_u_apply`. Plain version: gauge_stencil.apply_wilson_u.
- dense_apply    <- _apply_d_kernel (pallas_stencil.py:64), via
  `dense_apply`. Plain version: stencil.apply_D.

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

`u_mode` / `smoother_mode` / `apply_mode` choose between the two from the
bytes a level streams per sweep or apply against the H100's L2;
`apply_D` and `wilson_u_apply_auto` (counterpart of
pallas_stencil.apply_D_pallas_auto) dispatch the SpMV by `apply_mode`.

What bounds them on the H100 is bytes, not flops: ~4.5 complex words per
site per links sweep and ~26 per dense n=4 sweep (the accounting of
pallas_stencil.py:669-673). In the global kernels one thread per site
reads its neighbours from global memory and L2 serves the reuse; in the
tiled ones a thread owns two sites of a tile whose phi sits in shared
memory. The TPU kernels ran all sweeps in one launch with the lattice
resident in VMEM; here each Jacobi sweep is one launch and each red-black
sweep two (the launch boundary is the grid-wide colour barrier), with
red/black half-updates written in place. An SpMV moves 5n^2 + 2n words a
site (dense) or 6 (links), once each.

A CUDA tensor always goes to its kernel, or the wrapper raises; the plain
version runs only for CPU tensors (or when the caller passes
MGConfig.pallas='off' and calls the plain function itself).

The library is built at first use from the package's csrc/ sources into
tpu_multigrid_torch/_build/, keyed by a hash of the sources and flags:
one nvcc per .cu file, all started together, then one link. It is bound
with ctypes (a plain C interface: no PyTorch headers, so the build takes
seconds).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from . import gauge_stencil, smoothers, stencil

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC")

# Launch counts per kernel: each wrapper adds one where it launches.
launches = {"links_update": 0, "links_residual": 0, "dense_update": 0,
            "links_update_tiled": 0, "links_residual_tiled": 0,
            "dense_update_tiled": 0, "links_apply": 0, "dense_apply": 0,
            "links_apply_tiled": 0, "dense_apply_tiled": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


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
_SIGNATURES = {
    "links_residual": (_P, _P, _P, _P, _I, _D, _P),
    "links_update": (_P, _P, _P, _P, _I, _D, _D, _I, _P),
    "dense_update": (_P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _LL, _I, _D,
                     _P),
    "links_residual_tiled": (_P, _P, _P, _P, _I, _D, _I, _I, _P),
    "links_update_tiled": (_P, _P, _P, _P, _I, _D, _D, _I, _I, _I, _P),
    "dense_update_tiled": (_P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL, _LL,
                           _I, _D, _I, _I, _P),
    "links_apply": (_P, _P, _P, _I, _D, _P),
    "dense_apply": (_P, _P, _P, _I, _I, _I, _LL, _LL, _P),
    "links_apply_tiled": (_P, _P, _P, _I, _D, _I, _I, _P),
    "dense_apply_tiled": (_P, _P, _P, _I, _I, _I, _LL, _LL, _I, _I, _P),
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
    if t.device != like.device:
        raise ValueError(f"{name} on {t.device}, expected {like.device}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {like.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_lattice(L: int, kind: str) -> None:
    if kind not in smoothers.KERNEL_KINDS:
        raise NotImplementedError(f"no kernel for smoother {kind!r}")
    if kind == "rbgs" and L % 2:
        raise ValueError(f"red-black sweeps need an even lattice, got L={L}")


def _sweeps(launch, phi, n_sweeps: int, kind: str):
    """n_sweeps of launch(src, dst, colour). Red-black: colours 0 then 1,
    in place on a copy of phi (the caller's phi is left as it was);
    Jacobi: colour -1, ping-pong between two fresh buffers."""
    if kind == "rbgs":
        out = phi.clone()
        for _ in range(n_sweeps):
            launch(out, out, 0)
            launch(out, out, 1)
        return out
    src, bufs = phi, (torch.empty_like(phi), torch.empty_like(phi))
    for i in range(n_sweeps):
        launch(src, bufs[i % 2], -1)
        src = bufs[i % 2]
    return src


# --------------------------------------------------------------------------
# dispatch: global kernels while a level's sweep fits the L2, else x-tiled
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


# Largest tile of the tiled kernels: a block of 32 x 8 threads, two sites a
# thread along x (csrc/stencil_tiled.cu).
MAX_TILE = (16, 32)


def default_tile(L: int):
    """(TX, TY) of the tiled kernels: the largest tile, 16 x-rows by 32
    y-columns; 8 rows below L=1024, so that a level of 256^2 still spreads
    over 256 blocks."""
    return (16 if L >= 1024 else 8), 32


def _tile(tile, L: int):
    TX, TY = default_tile(L) if tile is None else map(int, tile)
    if not (1 <= TX <= MAX_TILE[0] and 1 <= TY <= MAX_TILE[1]):
        raise ValueError(f"tile {tile} outside 1..{MAX_TILE[0]} x "
                         f"1..{MAX_TILE[1]}")
    return TX, TY


# --------------------------------------------------------------------------
# links-only Wilson level 0 (B1, B2; x-tiled B5a, B5b)
# --------------------------------------------------------------------------

def _check_links(U, phi, r):
    L = phi.shape[-1]
    _check("phi", phi, phi, (2, L, L))
    _check("U", U, phi, (2, L, L))
    _check("r", r, phi, (2, L, L))


def wilson_u_residual(U, m: float, phi, r):
    """r - D_U phi, D_U = (2+m) + links-only Wilson hop.

    Replaces tpu_multigrid/ops/pallas_stencil.py _u_resid_vmem_kernel
    (via wilson_u_residual_pallas). Bound by bytes: U, phi and r read once,
    out written once (8 complex words per site)."""
    if not phi.is_cuda:
        return gauge_stencil.residual_u("wilson", U, m, phi, r)
    _check_links(U, phi, r)
    out = torch.empty_like(phi)
    _launch("links_residual", phi.dtype, phi.device, U.data_ptr(),
            phi.data_ptr(), r.data_ptr(), out.data_ptr(), phi.shape[-1],
            float(m))
    return out


def wilson_u_residual_tiled(U, m: float, phi, r, tile=None):
    """r - D_U phi on (TX, TY) tiles (default: default_tile(L)).

    Replaces tpu_multigrid/ops/pallas_stencil.py _u_resid_tile_kernel (via
    wilson_u_residual_pallas(mode='tiled')). Same bytes as
    wilson_u_residual, each word read once per pass from HBM."""
    L = phi.shape[-1]
    TX, TY = _tile(tile, L)
    if not phi.is_cuda:
        return gauge_stencil.residual_u("wilson", U, m, phi, r)
    _check_links(U, phi, r)
    out = torch.empty_like(phi)
    _launch("links_residual_tiled", phi.dtype, phi.device, U.data_ptr(),
            phi.data_ptr(), r.data_ptr(), out.data_ptr(), L, float(m), TX,
            TY)
    return out


def _links_smooth(name, U, m, phi, r, n_sweeps, kind, omega, *tile):
    if not phi.is_cuda:
        return gauge_stencil.smooth_u("wilson", U, m, phi, r, n_sweeps, kind,
                                      omega)
    _check_links(U, phi, r)
    L = phi.shape[-1]
    _check_lattice(L, kind)

    def launch(src, dst, colour):
        _launch(name, phi.dtype, phi.device, U.data_ptr(), src.data_ptr(),
                r.data_ptr(), dst.data_ptr(), L, float(m), float(omega),
                colour, *tile)

    return _sweeps(launch, phi, n_sweeps, kind)


def wilson_u_smooth(U, m: float, phi, r, n_sweeps: int, kind: str = "rbgs",
                    omega: float = 1.0):
    """n_sweeps links-only Wilson smoother sweeps (Jacobi or red-black).

    Replaces tpu_multigrid/ops/pallas_stencil.py _u_smooth_vmem_kernel
    (via wilson_u_smooth_pallas). Bound by bytes (~4.5 complex words per
    site per sweep); red-black half-sweeps update a copy of phi in place,
    Jacobi ping-pongs between two buffers."""
    return _links_smooth("links_update", U, m, phi, r, n_sweeps, kind, omega)


def wilson_u_smooth_tiled(U, m: float, phi, r, n_sweeps: int,
                          kind: str = "rbgs", omega: float = 1.0, tile=None):
    """wilson_u_smooth on (TX, TY) tiles (default: default_tile(L)).

    Replaces tpu_multigrid/ops/pallas_stencil.py _u_update_tile_kernel
    (via wilson_u_smooth_pallas_tiled): one launch per Jacobi sweep or
    red/black half-sweep, as there."""
    return _links_smooth("links_update_tiled", U, m, phi, r, n_sweeps, kind,
                         omega, *_tile(tile, phi.shape[-1]))


def wilson_u_apply(U, m: float, v):
    """D_U v = (2+m) v + links-only Wilson hop (v).

    Replaces tpu_multigrid/ops/pallas_stencil.py _u_apply_vmem_kernel (via
    apply_wilson_u_pallas_vmem). Bound by bytes: U, v in and out, 6
    complex words per site. Plain version: gauge_stencil.apply_wilson_u."""
    if not v.is_cuda:
        return gauge_stencil.apply_wilson_u(U, m, v)
    _check_links(U, v, v)
    out = torch.empty_like(v)
    _launch("links_apply", v.dtype, v.device, U.data_ptr(), v.data_ptr(),
            out.data_ptr(), v.shape[-1], float(m))
    return out


def wilson_u_apply_tiled(U, m: float, v, tile=None):
    """D_U v on (TX, TY) tiles (default: default_tile(L)).

    Replaces tpu_multigrid/ops/pallas_stencil.py _u_apply_tile_kernel (via
    apply_wilson_u_pallas). Same bytes as wilson_u_apply, each word of v
    read once per pass from HBM (the halo from the staged tile)."""
    L = v.shape[-1]
    TX, TY = _tile(tile, L)
    if not v.is_cuda:
        return gauge_stencil.apply_wilson_u(U, m, v)
    _check_links(U, v, v)
    out = torch.empty_like(v)
    _launch("links_apply_tiled", v.dtype, v.device, U.data_ptr(),
            v.data_ptr(), out.data_ptr(), L, float(m), TX, TY)
    return out


def wilson_u_apply_auto(U, m: float, v):
    """D_U v by the global or the x-tiled links wrapper, as
    apply_mode(links=True) says (each takes the plain version for a CPU
    tensor)."""
    if apply_mode(2, v.shape[-1], v.dtype, links=True) == "tiled":
        return wilson_u_apply_tiled(U, m, v)
    return wilson_u_apply(U, m, v)


# --------------------------------------------------------------------------
# dense 5-point block stencil (B3, B4; x-tiled B6; SpMV B7a, x-tiled B7b)
# --------------------------------------------------------------------------

def _batch_stride(t: torch.Tensor, unbatched_ndim: int, B: int) -> int:
    """Element stride between batch entries: 0 for a tensor shared by the
    batch, else the size of one entry."""
    if t.dim() == unbatched_ndim:
        return 0
    if t.dim() == unbatched_ndim + 1 and t.shape[0] == B:
        return t[0].numel()
    raise ValueError(f"batch axis of shape {tuple(t.shape)} does not match "
                     f"batch {B}")


def _dense_smooth(name, D, D0inv, phi, r, n_sweeps, kind, omega, *tile):
    if not phi.is_cuda:
        return smoothers.smooth_plain(D, D0inv, phi, r, n_sweeps, kind, omega)
    batched = phi.dim() == 4
    B = phi.shape[0] if batched else 1
    n, L = phi.shape[-3], phi.shape[-1]
    if n not in (1, 2, 4):
        raise ValueError(f"{name} takes n in (1, 2, 4), got {n}")
    _check_lattice(L, kind)
    bd = (B,) if batched else ()
    _check("phi", phi, phi, bd + (n, L, L))
    d_bs = _batch_stride(D, 5, B)
    dinv_bs = _batch_stride(D0inv, 4, B)
    r_bs = _batch_stride(r, 3, B)
    _check("D", D, phi, ((B,) if d_bs else ()) + (5, n, n, L, L))
    _check("D0inv", D0inv, phi, ((B,) if dinv_bs else ()) + (n, n, L, L))
    _check("r", r, phi, ((B,) if r_bs else ()) + (n, L, L))

    def launch(src, dst, colour):
        _launch(name, phi.dtype, phi.device, D.data_ptr(), D0inv.data_ptr(),
                src.data_ptr(), r.data_ptr(), dst.data_ptr(), B, n, L, d_bs,
                dinv_bs, r_bs, colour, float(omega), *tile)

    return _sweeps(launch, phi, n_sweeps, kind)


def dense_smooth(D, D0inv, phi, r, n_sweeps: int, kind: str = "rbgs",
                 omega: float = 1.0):
    """n_sweeps dense 5-point block-stencil sweeps,
    phi <- -D0inv (sum_mu D_mu phi(x+mu) - r), red-black or Jacobi.

    Replaces tpu_multigrid/ops/pallas_stencil.py _rbgs_kernel (via
    rbgs_smooth_pallas) and _jacobi_kernel (via jacobi_smooth_pallas).
    phi [B?, n, L, L] with an optional batch axis; D [B?, 5, n, n, L, L],
    D0inv [B?, n, n, L, L] and r [B?, n, L, L] each shared or batched.
    Bound by bytes: D's 4n^2 hop blocks and D0inv's n^2 dominate
    (~26 complex words per site per n=4 sweep)."""
    return _dense_smooth("dense_update", D, D0inv, phi, r, n_sweeps, kind,
                         omega)


def dense_smooth_tiled(D, D0inv, phi, r, n_sweeps: int, kind: str = "rbgs",
                       omega: float = 1.0, tile=None):
    """dense_smooth on (TX, TY) tiles (default: default_tile(L)), with the
    same batch axis and per-operand batch strides.

    Replaces tpu_multigrid/ops/pallas_stencil.py _tiled_update_kernel (via
    _tiled_update_call / smooth_pallas_tiled)."""
    return _dense_smooth("dense_update_tiled", D, D0inv, phi, r, n_sweeps,
                         kind, omega, *_tile(tile, phi.shape[-1]))


def _dense_apply(name, D, v, *tile):
    """out = D v with an optional batch axis on D and on v (each shared by
    the batch or batched); out is allocated here and never aliases v."""
    if not v.is_cuda:
        return stencil.apply_D(D, v)
    n, L = v.shape[-3], v.shape[-1]
    if n not in (1, 2, 4):
        raise ValueError(f"{name} takes n in (1, 2, 4), got {n}")
    bd = D.shape[:-5] if D.dim() == 6 else ()
    bv = v.shape[:-3] if v.dim() == 4 else ()
    if D.dim() not in (5, 6) or v.dim() not in (3, 4) or (
            bd and bv and bd != bv):
        raise ValueError(f"{name}: D {tuple(D.shape)} and v {tuple(v.shape)} "
                         "are not [B?, 5, n, n, L, L] and [B?, n, L, L]")
    lead = bd or bv
    B = lead[0] if lead else 1
    d_bs, v_bs = _batch_stride(D, 5, B), _batch_stride(v, 3, B)
    _check("v", v, v, bv + (n, L, L))
    _check("D", D, v, bd + (5, n, n, L, L))
    out = torch.empty(lead + (n, L, L), dtype=v.dtype, device=v.device)
    _launch(name, v.dtype, v.device, D.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, n, L, d_bs, v_bs, *tile)
    return out


def dense_apply(D, v):
    """Dense 5-point block SpMV out = D v, (D v)(x) = sum_mu D_mu(x) v(x+mu).

    Replaces tpu_multigrid/ops/pallas_stencil.py _apply_d_kernel (via
    apply_D_pallas). D [B?, 5, n, n, L, L] and v [B?, n, L, L], each
    shared by the batch or batched, n in {1, 2, 4}. Bound by bytes: D's
    5 n^2 blocks, v in and out (5n^2 + 2n complex words per site).
    Plain version: stencil.apply_D."""
    return _dense_apply("dense_apply", D, v)


def dense_apply_tiled(D, v, tile=None):
    """dense_apply on (TX, TY) tiles (default: default_tile(L)), with the
    same batch axes.

    Replaces tpu_multigrid/ops/pallas_stencil.py _tiled_apply_kernel (via
    apply_D_pallas_tiled): v's tile and its periodic halo are staged in
    shared memory, so each word of v crosses HBM once per pass."""
    return _dense_apply("dense_apply_tiled", D, v,
                        *_tile(tile, v.shape[-1]))


def apply_D(D, v):
    """D v by dense_apply or dense_apply_tiled, as apply_mode says
    (counterpart of pallas_stencil.apply_D_pallas_auto): the plain
    stencil.apply_D for a CPU tensor; on a CUDA tensor the kernel runs or
    the wrapper raises."""
    if apply_mode(v.shape[-3], v.shape[-1], v.dtype) == "tiled":
        return dense_apply_tiled(D, v)
    return dense_apply(D, v)
