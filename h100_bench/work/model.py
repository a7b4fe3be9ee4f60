"""The frozen work model of the stencil work: the least bytes and
operations of every smooth, residual, apply and check that an adaptive
setup, an NTL cycle, a defect-correction step and a fixed-cycle check
perform, reckoned from the configuration and the counts of calls alone,
never from the launches that carried them out.

`kernel_work` is a copy of tpu_multigrid_torch.profiling.kernel_work, kept
here so that the yardstick does not move when the program does. A work
item names the kind of work by the launch-counter key of the kernel that
first did it (`links_update`, `dense_residual`, ...); the x-tiled kernels
do the same work. Restriction and prolongation are transfers, not stencil
work, and are counted in no item: the fused level-0 residual-restriction
is counted as the residual it contains, a lower bound of its own work.
Wilson level-0 work is reckoned as links work (the gauge links, 2 words a
site, in place of the dense operator's 5 n^2) wherever it runs, since the
configuration's gauge is always at hand: a dense level-0 kernel does the
same work at more bytes than its least.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent

# Real flops of one site: the links-only Wilson hop (4 complex products,
# 4 projections, the two spinor sums) and a complex multiply-add.
_HOP_FLOPS = 48
_CMAC_FLOPS = 8

ITEMSIZE = {"complex64": 8, "complex128": 16}


def kernel_work(kernel: str, n: int, L: int, itemsize: int, batch: int = 1,
                op_batch: int = 1, n_sweeps: int = 1, nc: int = 4,
                block: int = 4, r_batch: int = None, u_batch: int = 1):
    """(bytes, flops) the least that one call must do: each input word
    read once and each output word written once. `batch` fields,
    `op_batch` copies of the operator (for the links kernels, copies of r;
    `u_batch` copies of the links U), `r_batch` copies of a dense
    smoother's r (default op_batch), `n_sweeps` sweeps a smoother call;
    the fused residual-restriction has `nc` near-null rows and blocks of
    `block` fine sites. Words a site:
    - links smoother / residual: U 2 a copy, r 2 a copy, phi 2 and out 2
      a field;
    - links residual-restriction: U 2, phi_null 2 nc, r 2 a copy, phi 2
      and out nc / block a field;
    - links apply: U 2, v 2 and out 2 a field;
    - links residual norm: U 2, b 2 a copy, phi 2 a field, one real out;
    - dense smoother: per operator copy 4n^2 hop blocks and n^2 of D0inv,
      per copy of r n, per field phi in and out (2n);
    - dense apply: 5n^2 per operator copy, v in and out per field;
    - dense residual: the apply's, and r per field."""
    LL = L * L
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
        words = 2 * u_batch + 4 * batch + (0 if base == "links_apply" else 2 * op_batch)
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


def peaks() -> dict:
    """The published peaks of the card (work/peaks.json)."""
    return json.loads((HERE / "peaks.json").read_text())


def bound_seconds(nbytes: float, flops: float, dtype: str, pk=None):
    """(seconds, 'bytes' or 'operations'): the least time the card could
    take, the larger of bytes over the HBM rate and flops over the peak
    rate of the item's precision."""
    pk = pk or peaks()
    t_bytes = nbytes / pk["hbm_bytes_per_s"]
    t_ops = flops / pk["flops_per_s"][dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclass(frozen=True)
class Item:
    """`count` calls of one kind of stencil work at one shape."""
    kernel: str
    n: int
    L: int
    dtype: str
    count: float = 1
    batch: int = 1
    op_batch: int = 1
    n_sweeps: int = 1
    r_batch: int = None
    u_batch: int = 1

    def work(self):
        """(bytes, flops) of all `count` calls."""
        b, f = kernel_work(self.kernel, self.n, self.L, ITEMSIZE[self.dtype],
                           self.batch, self.op_batch, self.n_sweeps,
                           r_batch=self.r_batch, u_batch=self.u_batch)
        return b * self.count, f * self.count

    def times(self, k: float) -> "Item":
        return dataclasses.replace(self, count=self.count * k)


def sizes(cfg: dict):
    """Lattice size of each level, 0 .. nlevels."""
    s = [cfg["L"]]
    for _ in range(cfg["nlevels"]):
        s.append(s[-1] // cfg["block_x"])
    return s


def dofs(cfg: dict):
    """Degrees of freedom a site at each level (wilson: 2, then 4)."""
    n0, nc = (2, 4) if cfg["stencil"] == "wilson" else (1, 2)
    return [n0] + [nc] * cfg["nlevels"]


def links(cfg: dict) -> bool:
    """Whether level 0 is reckoned as links work (Wilson: the gauge)."""
    return cfg["stencil"] == "wilson"


def ntl_cycle(cfg: dict, dtype: str, batch: int = 1, ensemble: bool = False):
    """The stencil work of one non-telescoping cycle (reference f_MG_ntl)
    on `batch` right-hand sides: two smooths of num_iters sweeps at levels
    0 .. nlevels-1, a residual at each of them, one smooth of the
    n_copies coarse copies at once, and the min-res apply of the copies'
    prolonged corrections at level nlevels-1. `ensemble`: every field has
    its own operators (and its own links)."""
    S, N = sizes(cfg), dofs(cfg)
    n, nq, s = cfg["nlevels"], cfg["n_copies"], cfg["num_iters"]
    ops = batch if ensemble else 1
    items = []
    for lvl in range(n):
        if lvl == 0 and links(cfg):
            items.append(Item("links_update", N[0], S[0], dtype, 2, batch,
                              batch, s, u_batch=ops))
            items.append(Item("links_residual", N[0], S[0], dtype, 1, batch,
                              batch, u_batch=ops))
        else:
            items.append(Item("dense_update", N[lvl], S[lvl], dtype, 2, batch,
                              ops, s, batch))
            items.append(Item("dense_residual", N[lvl], S[lvl], dtype, 1,
                              batch, ops))
    items.append(Item("dense_update", N[n], S[n], dtype, 1, batch * nq,
                      ops * nq, s, batch * nq))
    items.append(Item("dense_apply", N[n - 1], S[n - 1], dtype, 1, batch * nq,
                      ops))
    return items


def level0_residual(cfg: dict, dtype: str, batch: int = 1,
                    ensemble: bool = False):
    """One level-0 residual on `batch` fields: solve_ir's outer residual,
    or a fixed-cycle solve's check (links work for Wilson)."""
    ops = batch if ensemble else 1
    if links(cfg):
        return [Item("links_residual", dofs(cfg)[0], cfg["L"], dtype, 1,
                     batch, batch, u_batch=ops)]
    return [Item("dense_residual", dofs(cfg)[0], cfg["L"], dtype, 1, batch,
                 ops)]


def setup(cfg: dict, dtype: str, configs: int = 1):
    """The stencil work of the adaptive setup of `configs` gauge
    configurations: at every level but the coarsest, null_iters //
    iters_per_norm smooth calls of iters_per_norm sweeps on the nc / 2
    near-null candidates a configuration (Wilson), each group of
    candidates on its configuration's operator (Wilson level 0: its
    links), with one zero right-hand side shared by all. The
    orthonormalization and the Galerkin products are dense linear
    algebra, not stencil work."""
    S, N = sizes(cfg), dofs(cfg)
    k = N[1] // 2 if links(cfg) else N[1]
    calls = max(cfg["null_iters"] // cfg["iters_per_norm"], 1)
    ipn = cfg["iters_per_norm"]
    return [Item("links_update", N[0], S[0], dtype, calls, configs * k, 1,
                 ipn, u_batch=configs) if lvl == 0 and links(cfg) else
            Item("dense_update", N[lvl], S[lvl], dtype, calls, configs * k,
                 configs, ipn, 1)
            for lvl in range(cfg["nlevels"])]


def bound(items, pk=None):
    """(seconds, seconds bound by bytes, seconds bound by operations) of
    the least time of all the items."""
    pk = pk or peaks()
    total = by_bytes = by_ops = 0.0
    for it in items:
        nbytes, flops = it.work()
        t, what = bound_seconds(nbytes, flops, it.dtype, pk)
        total += t
        if what == "bytes":
            by_bytes += t
        else:
            by_ops += t
    return total, by_bytes, by_ops


def kernel_table() -> dict:
    """{kernel function name: row} of every file in work/kernels/: which
    device kernels do the stencil work, by the name the profiler prints."""
    rows = {}
    for f in sorted((HERE / "kernels").glob("*.json")):
        row = json.loads(f.read_text())
        rows[row["kernel"]] = row
    return rows
