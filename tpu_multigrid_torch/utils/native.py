"""ctypes bindings of the native U(1) heat-bath generator
(tpu_multigrid/native/heatbath.cpp) and the reference-format text reader
and writer (tpu_multigrid/native/refio.cpp) — the port's own loader,
counterpart of tpu_multigrid/utils/native.py.

The sources are compiled with g++ and the flags of
tpu_multigrid/native/Makefile into tpu_multigrid_torch/_build/ at first
use, keyed by a hash of the sources and flags. This module reads those
sources as files: it never imports anything under `tpu_multigrid` (whose
`__init__` imports jax) and never loads that package's own libtpumg.so.
`available()` is False when no C++ compiler can build them; callers
(models.gauge.heatbath_ensemble, utils.io's near-null text files) then
take the NumPy / Python path.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent
NATIVE_SRC = _ROOT.parent / "tpu_multigrid" / "native"
SOURCES = ("heatbath.cpp", "refio.cpp")
BUILD_DIR = _ROOT / "_build"
# tpu_multigrid/native/Makefile's CXXFLAGS
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")


def library_path() -> Path:
    """Path of the shared library for the current sources, flags and host
    (-march=native: a library built on another machine is not reused)."""
    h = hashlib.sha256(" ".join(CXXFLAGS + (platform.node(),)).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((NATIVE_SRC / name).read_bytes())
    return BUILD_DIR / f"libtmg_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the native sources unless a library for the same sources
    exists; returns its path. Raises if the compiler fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or "g++"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = Path(tmp) / "lib.so"
        cmd = [cxx, *CXXFLAGS, *(str(NATIVE_SRC / s) for s in SOURCES),
               "-o", str(lib)]
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(lib, out)
    return out


_DP = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "tpumg_heatbath_run": (None, (_DP, ctypes.c_int, ctypes.c_double,
                                  ctypes.c_int, ctypes.c_uint64)),
    "tpumg_mean_plaquette": (ctypes.c_double, (_DP, ctypes.c_int)),
    "tpumg_read_complex_text": (ctypes.c_long, (ctypes.c_char_p, _DP,
                                                ctypes.c_long)),
    "tpumg_write_complex_text": (ctypes.c_int, (ctypes.c_char_p, _DP,
                                                ctypes.c_long)),
    "tpumg_read_phase_text": (ctypes.c_long, (ctypes.c_char_p, _DP,
                                              ctypes.c_long)),
}


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    lib = ctypes.CDLL(str(build()))
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        get_lib()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(_DP)


def heatbath_run(theta: np.ndarray, beta: float, sweeps: int,
                 seed: int) -> np.ndarray:
    """`sweeps` native heat-bath sweeps on phases theta [2, L, L] (on a
    float64 copy, returned)."""
    th = np.array(theta, dtype=np.float64, order="C")
    get_lib().tpumg_heatbath_run(_dptr(th), th.shape[-1], float(beta),
                                 int(sweeps), int(seed) & (2 ** 64 - 1))
    return th


def mean_plaquette(theta: np.ndarray) -> float:
    th = np.ascontiguousarray(theta, dtype=np.float64)
    return float(get_lib().tpumg_mean_plaquette(_dptr(th), th.shape[-1]))


def read_complex_text(path: str, max_vals: int) -> np.ndarray:
    """Up to max_vals complex values of a '%25.20e+i%25.20e' text file, as
    a complex128 array."""
    buf = np.empty(2 * max_vals, dtype=np.float64)
    k = get_lib().tpumg_read_complex_text(path.encode(), _dptr(buf), max_vals)
    if k < 0:
        raise FileNotFoundError(path)
    pairs = buf[:2 * k].reshape(-1, 2)
    return pairs[:, 0] + 1j * pairs[:, 1]


def write_complex_text(path: str, vals: np.ndarray):
    """Write complex values one per line as '%25.20e+i%25.20e'."""
    v = np.ascontiguousarray(vals, dtype=np.complex128).ravel()
    inter = np.ascontiguousarray(v.view(np.float64))   # re, im interleaved
    if get_lib().tpumg_write_complex_text(path.encode(), _dptr(inter),
                                          v.size) != 0:
        raise IOError(f"cannot write {path}")


def read_phase_text(path: str, max_vals: int) -> np.ndarray:
    """Up to max_vals bare doubles, one per line (the heat-bath phase
    file format)."""
    buf = np.empty(max_vals, dtype=np.float64)
    k = get_lib().tpumg_read_phase_text(path.encode(), _dptr(buf), max_vals)
    if k < 0:
        raise FileNotFoundError(path)
    return buf[:k]
