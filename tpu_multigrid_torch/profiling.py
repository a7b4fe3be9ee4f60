"""Performance observability on the card: per-kernel timing with CUDA
events, bandwidth/roofline accounting against the card's HBM peak,
torch.profiler trace capture (counterpart of tpu_multigrid/profiling.py),
and the program's spans.

A time from CPU tensors is a host-clock time of the plain versions and is
reported without a roofline fraction: it says nothing of a device.

Spans. `span(name)` (a context manager, or a decorator) times a stretch
of the host's work on time.perf_counter_ns. A span opened while no other
is open is a root: one request of a user (a solve, a setup), whose id
every span inside it shares; an entry point called inside another (as
solve_ensemble calls solve_batched) is a child like any other span. A
root, once closed, keeps its name, id, start and end, and for each span
name inside it (its own included) the count, the total ns and the self
ns (the total less the time of the spans directly inside each); and the
device ms recorded for a name inside it (`add_device_ms`: the warm-up's
elapsed time between CUDA events on its stream, read once complete,
never by a sync). `roots()` returns
the last RING roots, oldest first. While a torch.profiler runs, a span
also opens record_function("tmg." + name), so that it lies on the
profiler's host timeline beside the kernels its host ops launched. The
spans are always on; they add no host sync and no device work. They are
kept for one thread, the one that drives the program.

The program's spans: roots at the drivers' and the setups' entry points;
chunk.warm_up, chunk.capture, chunk.replay and chunk.release in
utils.compile; driver.read_back around every host read of the drivers
(a chunk's result, a norm) and of the setup's checks; setup.nearnull, setup.coarsen and
setup.check in solver.hierarchy.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import time
from dataclasses import dataclass, asdict
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Optional

import torch

from .config import MGConfig
from .ops import cuda_stencil as cs, dispatch

# Peak HBM bandwidth (bytes/s) by card, from NVIDIA's data sheets; the
# first entry whose every word is in torch.cuda.get_device_name() wins.
HBM_PEAK = (
    (("H200",), 4.8e12),
    (("H100", "PCIe"), 2.0e12),
    (("H100", "HBM3"), 3.35e12),
    (("H100", "SXM"), 3.35e12),
)


def peak_bandwidth(device=None) -> float:
    """HBM peak of the CUDA card `device` (default: the current one).
    Raises for a card not in HBM_PEAK."""
    name = torch.cuda.get_device_name(device)
    for words, peak in HBM_PEAK:
        if all(w in name for w in words):
            return peak
    raise ValueError(f"no HBM peak known for {name!r}")


def stencil_bytes(n: int, L: int, dtype_bytes: int = 8) -> int:
    """Minimum HBM traffic of one apply_D: read D + read v + write out."""
    return (5 * n * n + 2 * n) * L * L * dtype_bytes


# Real flops of one site: the links-only Wilson hop (4 complex products,
# 4 projections, the two spinor sums) and a complex multiply-add.
_HOP_FLOPS = 48
_CMAC_FLOPS = 8


def kernel_work(kernel: str, n: int, L: int, itemsize: int, batch: int = 1,
                op_batch: int = 1, n_sweeps: int = 1, nc: int = 4,
                block: int = 4, r_batch: int = None,
                with_base: bool = True):
    """(bytes, flops) the least that one call of a hand kernel must do:
    each input word read once and each output word written once, whatever
    the kernel reads again. `kernel` is a cuda_stencil.launches key (the
    x-tiled kernels do the same work as the global ones); `batch` fields,
    `op_batch` copies of the operator (1: shared by the batch; B / G for a
    dense SpMV, residual or smoother in groups of G; for the links kernels,
    copies of r, the links U being always shared); `r_batch` copies of a
    dense smoother's r (default op_batch); a smoother call runs `n_sweeps`
    sweeps; the fused residual-restriction has `nc` near-null rows and
    blocks of `block` fine sites. Words a site:
    - links smoother / residual: U 2, r 2 a copy, phi 2 and out 2 a field
      (8 unbatched);
    - links residual-restriction: U 2, phi_null 2 nc, r 2 a copy, phi 2 and
      out nc / block a field (15 at nc=4, 2 x 2 blocks);
    - links apply: U 2, v 2 and out 2 a field (6 unbatched);
    - links residual norm (the level-0 check): U 2, b 2 a copy, phi 2 a
      field, and one real a field out (6 words a site unbatched);
    - dense smoother: per operator copy D's 4n^2 hop blocks and D0inv's
      n^2, per copy of r n; per field phi in and out (2n): 92 at n=4;
    - dense apply: 5n^2 per operator copy, v in and out per field;
    - dense residual: the apply's, and r per field (92 at n=4);
    - restrict (n = nf fine components): phi_null nc n per copy of it
      (op_batch), the fine field n per copy (r_batch, default batch), the
      result nc / block per entry (batch): 11 at nc=4, n=2, 2 x 2 blocks;
    - prolong: phi_null nc n per copy, the coarse field nc / block, the
      base it adds to (with_base) n and the result n per entry."""
    LL = L * L
    if kernel in ("restrict", "prolong"):
        phi_words = nc * n * op_batch
        if kernel == "restrict":
            words = (phi_words + n * (batch if r_batch is None else r_batch)
                     + nc / block * batch)
        else:
            words = phi_words + (nc / block + n * (1 + with_base)) * batch
        return (round(words * LL * itemsize),
                _CMAC_FLOPS * nc * n * batch * LL)
    base = kernel.removesuffix("_tiled")
    if base == "links_residual_restrict":
        words = 2 + 2 * nc + 2 * op_batch + (2 + nc / block) * batch
        flops = _HOP_FLOPS + 12 + 2 * nc * _CMAC_FLOPS
        return round(words * LL * itemsize), flops * batch * LL
    if base == "links_residual_norm":
        words = 2 + 2 * op_batch + 2 * batch
        nbytes = words * LL * itemsize + batch * itemsize // 2
        return nbytes, (_HOP_FLOPS + 12 + 8) * batch * LL
    if base in ("links_update", "links_residual", "links_apply"):
        words = 2 + 4 * batch + (0 if base == "links_apply" else 2 * op_batch)
        flops = {"links_update": (_HOP_FLOPS + 8) * n_sweeps,
                 "links_residual": _HOP_FLOPS + 12,
                 "links_apply": _HOP_FLOPS + 8}[base]
        return words * LL * itemsize, flops * batch * LL
    if base == "dense_update":
        words = (5 * n * n * op_batch + n * (op_batch if r_batch is None
                                             else r_batch) + 2 * n * batch)
        flops = (_CMAC_FLOPS * 5 * n * n + 2 * n) * n_sweeps * batch
        return words * LL * itemsize, flops * LL
    if base in ("dense_apply", "dense_residual"):
        resid = base == "dense_residual"
        words = 5 * n * n * op_batch + (3 if resid else 2) * n * batch
        flops = (_CMAC_FLOPS * 5 * n * n + (2 * n if resid else 0)) * batch
        return words * LL * itemsize, flops * LL
    raise ValueError(f"no work model for kernel {kernel!r}")


def bound_seconds(nbytes: int, flops: int, peak_bytes_per_s: float,
                  peak_flops: float):
    """(seconds, 'bytes' or 'operations'): the least time the card could
    take for the work, the larger of bytes over its memory rate and flops
    over its peak rate for their type."""
    t_bytes, t_ops = nbytes / peak_bytes_per_s, flops / peak_flops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_op(fn: Callable, *args, reps: int = 100, warmup: bool = True,
            passes: int = 3) -> float:
    """Best-of-passes seconds per call of fn(*args[:-1], x), chained `reps`
    times with x = args[-1] fed forward (the JAX package's fori_loop).

    CUDA arguments are timed with CUDA events around the reps; CPU ones
    with the host clock. The values may overflow over many reps of an
    indefinite operator; only the time is kept."""
    *head, x0 = args
    cuda = isinstance(x0, torch.Tensor) and x0.is_cuda

    def run():
        x = x0
        for _ in range(reps):
            x = fn(*head, x)
        return x

    if warmup:
        run()
        if cuda:
            torch.cuda.synchronize(x0.device)
    best = float("inf")
    for _ in range(passes):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            sec = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            run()
            sec = time.perf_counter() - t0
        best = min(best, sec)
    return max(best / reps, 1e-12)


@dataclass
class RooflineRow:
    name: str
    sec: float
    bytes: int
    flops: int = 0
    bw_frac: Optional[float] = None

    def finish(self, peak: Optional[float]):
        """bw_frac = achieved bytes/s over `peak` (None: not a device
        measurement, no fraction)."""
        if peak is not None:
            self.bw_frac = self.bytes / self.sec / peak
        return self


def roofline_table(cfg: MGConfig, D, v, r=None, reps: int = 100) -> Dict:
    """Time the hot operations of one level and set them against the HBM
    roofline: the plain versions (rows apply_D, jacobi_sweep, rbgs_sweep)
    and the kernels the route functions of ops/dispatch.py name for this
    level (apply_D_cuda or apply_D_cuda_tiled, jacobi_cuda or
    jacobi_cuda_tiled), as the solver runs it."""
    from .ops.stencil import apply_D, site_inverse
    from .ops.smoothers import jacobi_sweep, rbgs_sweep

    n, L = v.shape[0], v.shape[-1]
    dbytes = v.element_size()
    peak = peak_bandwidth(v.device) if v.is_cuda else None
    Dinv = site_inverse(D[0])
    if r is None:
        r = torch.zeros_like(v)
    sweep_bytes = ((4 * n * n + n * n) + 3 * n) * L * L * dbytes
    rows = [
        RooflineRow("apply_D", time_op(apply_D, D, v, reps=reps),
                    stencil_bytes(n, L, dbytes)),
        RooflineRow("jacobi_sweep",
                    time_op(lambda D, x: jacobi_sweep(D, Dinv, x, r), D, v,
                            reps=reps), sweep_bytes),
        RooflineRow("rbgs_sweep",
                    time_op(lambda D, x: rbgs_sweep(D, Dinv, x, r), D, v,
                            reps=reps), 2 * sweep_bytes),
    ]
    seen = {"device": v.device.type, "pallas": cfg.pallas}
    route = dispatch.spmv_route(n, L, v.dtype, cs.aligned(D, v), **seen)
    if route != "plain":
        tiled = route == "tiled"
        rows.append(RooflineRow(
            "apply_D_cuda" + "_tiled" * tiled,
            time_op(cs.dense_apply_tiled if tiled else cs.dense_apply, D, v,
                    reps=reps), stencil_bytes(n, L, dbytes)))
    route = dispatch.smooth_route("jacobi", n, L, v.dtype, 0, **seen)
    if route != "plain":
        tiled = route == "tiled"
        smooth = cs.dense_smooth_tiled if tiled else cs.dense_smooth
        rows.append(RooflineRow(
            "jacobi_cuda" + "_tiled" * tiled,
            time_op(lambda D, x: smooth(D, Dinv, x, r, 1, "jacobi"), D, v,
                    reps=reps), sweep_bytes))
    return {"device": (torch.cuda.get_device_name(v.device) if v.is_cuda
                       else "cpu"),
            "peak_bytes_per_s": peak,
            "rows": [asdict(row.finish(peak)) for row in rows]}


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler over the block (CPU and, with a card, CUDA
    activity); writes a Chrome trace to log_dir/trace.json on exit and
    yields the profiler (key_averages() for sums by kernel)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


# ---- spans ----

# Roots kept: the busiest cell closes some 2,000 in a window.
RING = 16384


class Root(NamedTuple):
    name: str
    id: int
    start_ns: int
    end_ns: int
    spans: dict        # name -> (count, total_ns, self_ns)
    device_ms: dict    # name -> device ms recorded inside the root


_ring: collections.deque = collections.deque(maxlen=RING)
# open spans, outermost first: [span, record_function or None, child ns,
# start ns]
_stack: list = []
_touched: list = []    # the spans closed in the open root
_device: dict = {}     # the open root's name -> device ms
_root_id = 0
_clock = time.perf_counter_ns
_profiling = torch.autograd._profiler_enabled


class _Span:
    """A reusable, reentrant span of one name: its state lives on the
    stack of open spans, its sums for the open root in `acc` ([count,
    total ns, self ns] or None)."""
    __slots__ = ("name", "tag", "acc")

    def __init__(self, name: str):
        self.name, self.tag, self.acc = name, "tmg." + name, None

    def __enter__(self):
        global _root_id
        rf = None
        if _profiling():
            rf = torch.profiler.record_function(self.tag)
            rf.__enter__()
        if not _stack:
            _root_id += 1
        _stack.append([self, rf, 0, _clock()])

    def __exit__(self, *exc):
        end = _clock()
        span, rf, child, start = _stack.pop()
        dur = end - start
        acc = span.acc
        if acc is None:
            span.acc = [1, dur, dur - child]
            _touched.append(span)
        else:
            acc[0] += 1
            acc[1] += dur
            acc[2] += dur - child
        if _stack:
            _stack[-1][2] += dur
        else:
            _ring.append(Root(span.name, _root_id, start, end,
                              {t.name: tuple(t.acc) for t in _touched},
                              dict(_device)))
            for t in _touched:
                t.acc = None
            _touched.clear()
            _device.clear()
        if rf is not None:
            rf.__exit__(*exc)

    def __call__(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return spanned


_spans: dict = {}


def span(name: str) -> _Span:
    """The span `name`: `with span(name): ...` or `@span(name)`."""
    s = _spans.get(name)
    if s is None:
        s = _spans[name] = _Span(name)
    return s


def add_device_ms(name: str, ms: float) -> None:
    """Add `ms` of device time to span `name` of the open root (nothing
    when no span is open)."""
    if _stack:
        _device[name] = _device.get(name, 0.0) + ms


def roots() -> list:
    """The closed roots kept, oldest first (at most RING)."""
    return list(_ring)
