"""The benchmark of tpu_multigrid_torch: one run of one cell.

Everything that belongs to one cell is found by name from BENCHMARK.json:
its configuration (configs/<config>.json), its traffic mix
(traffic/<traffic>.json), the traffic kind the mix names, which sets up
and drives the program (traffic/<kind>.py), and each metric's reader
(end_to_end/<metric>.py, layer_metrics/<metric>.py, or the file of the
name before its first dot). A new cell, mix,
kind or metric is a new file and a new entry; no file here changes.

A run: set-up (the inputs from the seed, the program's set-up, one call
of the cell's driver to warm up its shapes), then a closed loop of whole
calls, one in flight, until the first call that ends after `seconds`;
with trace, a stretch of those calls under torch.profiler. Then the peak
memory is read, the program's state freed, and the plain reference
judges the answers the timed calls returned.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from h100_bench import trace as tr
from h100_bench.work import model

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_multigrid")


def manifest(root: Path = REPO) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_module(path: Path):
    """The module in one file of the benchmark, by its path (a metric's
    name may hold dots)."""
    name = "h100_bench_" + "_".join(path.relative_to(HERE).with_suffix(
        "").parts).replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _reported(entries, name, moved=None):
    """The metric entries a cell reports: those that list it under
    `workloads`, and those without the key (for a per-layer metric: where
    the cell reports the end-to-end metric it moves)."""
    out = []
    for m in entries:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif moved is None or m["moves"] in moved:
            out.append(m)
    return out


def cell(name: str, man: dict = None) -> Cell:
    man = man or manifest()
    spec = {w["name"]: w for w in man["workloads"]}.get(name)
    if spec is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfgs = {c["name"]: c for c in man["configs"]}
    config = json.loads((REPO / cfgs[spec["config"]]["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{spec['traffic']}.json")
                         .read_text())
    e2e = _reported(man["end_to_end"], name)
    layer = _reported(man["per_layer"], name, {m["name"] for m in e2e})
    return Cell(name, config, traffic, e2e, layer)


class Context:
    """What a traffic kind gets: the program's configuration, the mix's
    parameters, the device and the seed's streams."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        import tpu_multigrid_torch as mgt
        self.mgt = mgt
        self.config = config
        self.params = traffic
        self.seed = seed
        self.device = torch.device(device)
        self.cfg = mgt.MGConfig(**config["mgconfig"])

    def seed_of(self, *stream, seed: int = None) -> int:
        """A 63-bit seed of the run's seed (or of `seed`, such as a mix's
        fixed instance) and a named stream."""
        base = self.seed if seed is None else seed
        words = [base & (2 ** 64 - 1)] + [
            int.from_bytes(str(s).encode(), "little") for s in stream]
        state = np.random.SeedSequence(words).generate_state(1, np.uint64)
        return int(state[0]) & (2 ** 63 - 1)

    def generator(self, *stream, device=None,
                  seed: int = None) -> torch.Generator:
        """A torch generator on the device (or `device`), seeded from the
        run's seed (or `seed`) and the stream."""
        g = torch.Generator(device=device or self.device)
        return g.manual_seed(self.seed_of(*stream, seed=seed))

    def rng(self, *stream, seed: int = None) -> np.random.Generator:
        return np.random.default_rng(self.seed_of(*stream, seed=seed))

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def phases(self, count: int, *stream, seed: int = None) -> torch.Tensor:
        """Gauge phases [count, 2, L, L] (float64, on the device) of the
        configuration's gauge kind, drawn in one call (from the run's seed
        or `seed`)."""
        g = self.config["gauge"]
        if g["kind"] != "gaussian_phases":
            raise ValueError(f"no gauge kind {g['kind']!r}")
        L = self.cfg.L
        return g["width"] * torch.randn(
            (count, 2, L, L), generator=self.generator(*stream, seed=seed),
            dtype=torch.float64, device=self.device)


class Reservoir:
    """A uniform sample of at most k of the items offered, drawn from the
    seed (reservoir sampling): the answers the reference judges."""

    def __init__(self, k: int, rng: np.random.Generator):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.k:
                self.items[j] = item


@dataclass
class Record:
    """What the metric readers read."""
    setup_s: float
    window_s: float = 0.0
    calls: list = field(default_factory=list)
    trace: dict = None
    profiled: range = range(0)


def process_start_time() -> float:
    """time.time() at which this process started (Linux /proc)."""
    import os
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        ticks = int(fields[19])
        btime = next(int(line.split()[1]) for line in
                     Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def host_sample(t: float, calls: int):
    """(window seconds, calls done, this process's CPU seconds, all its
    threads), to tell the host's work from the device's."""
    import os
    tm = os.times()
    return t, calls, tm.user + tm.system


def host_by_tenths(samples) -> str:
    """Per tenth of the window: ms a call, this process's CPU ms a call
    and the cores it kept busy."""
    out = []
    for (t0, n0, c0), (t1, n1, c1) in zip(samples, samples[1:]):
        dt, n = t1 - t0, max(n1 - n0, 1)
        out.append(f"{1e3 * dt / n:.2f}/{1e3 * (c1 - c0) / n:.2f}/"
                   f"{(c1 - c0) / dt:.2f}")
    return " ".join(out)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or
    the JAX package's (compared whole: tpu_multigrid_torch passes)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def reader(folder: str, name: str) -> Path:
    """The reader of metric `name`: folder/<name>.py, or else the reader of
    the quantity it splits, folder/<name before its first dot>.py
    (idle_share.solve and idle_share.configs: idle_share.py)."""
    own = HERE / folder / f"{name}.py"
    return own if own.exists() else HERE / folder / \
        f"{name.split('.', 1)[0]}.py"


def read_metrics(entries, folder: str, rec: Record) -> dict:
    out = {}
    for m in entries:
        value = load_module(reader(folder, m["name"])).read(rec)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(workload: str, seed: int, seconds: float, trace: bool,
        device="cuda", t_start: float = None, overrides: dict = None,
        log=None, man: dict = None) -> dict:
    """One run of a cell; returns the result's dict. `overrides` replace
    entries of the mix's parameters and of the configuration's MGConfig
    fields (key "mgconfig"): the tests' small sizes and the control."""
    from torch.profiler import ProfilerActivity, profile, record_function

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    t_start = time.time() if t_start is None else t_start
    c = cell(workload, man)
    config, traffic = dict(c.config), dict(c.traffic)
    for k, v in (overrides or {}).items():
        if k == "mgconfig":
            config["mgconfig"] = {**config["mgconfig"], **v}
        else:
            traffic[k] = v
    kind = importlib.import_module(f"h100_bench.traffic.{traffic['kind']}")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ctx = Context(config, traffic, seed, device)
    if cuda:
        torch.cuda.init()
    log(f"program imported, card ready: {time.time() - t_start:.3f} s after "
        "the process started")
    state = kind.setup(ctx)
    ctx.sync()
    rec = Record(setup_s=time.time() - t_start)
    log(f"set-up {rec.setup_s:.3f} s")

    # the first call of the window stays untraced
    rec.profiled = range(1, 1 + traffic["profile_calls"]) if trace \
        else range(0)
    prof = None
    w0 = time.perf_counter()
    host = [host_sample(0.0, 0)]
    i = 0
    while True:
        if i == rec.profiled.start and trace:
            ctx.sync()
            prof = profile(activities=[ProfilerActivity.CPU] + (
                [ProfilerActivity.CUDA] if cuda else []))
            prof.__enter__()
            tp0 = time.perf_counter()
        t0 = time.perf_counter()
        with record_function(f"h100_bench.call.{traffic['kind']}"):
            out = kind.call(state, i)
        ctx.sync()
        t1 = time.perf_counter()
        out.update(t0=t0 - w0, t1=t1 - w0, seconds=t1 - t0)
        rec.calls.append(out)
        if prof is not None and i == rec.profiled.stop - 1:
            ctx.sync()
            tp1 = time.perf_counter()
            prof.__exit__(None, None, None)
            rec.trace = tr.reduce(prof, tp1 - tp0)
            prof = None
        i += 1
        if t1 - w0 >= len(host) * seconds / 10:
            host.append(host_sample(t1 - w0, i))
        if t1 - w0 >= seconds and (not trace or i >= rec.profiled.stop):
            break
    rec.window_s = rec.calls[-1]["t1"]
    log(f"window {rec.window_s:.3f} s, {len(rec.calls)} calls; by tenths of "
        "the window, ms a call / CPU ms a call / cores busy: "
        + host_by_tenths(host))

    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(ctx.device) if cuda
                else "cpu", "count": 1,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated(
                    ctx.device)) if cuda else 0}
    if trace:
        dev_info.update(busy_s=rec.trace["busy_s"],
                        window_s=rec.trace["window_s"])
    kind.release(state)
    if cuda:
        torch.cuda.empty_cache()
    checks = kind.check(state)
    correct = all(math.isfinite(v) and v <= lim for v, lim in checks.values())

    entries = c.per_layer if trace else c.end_to_end
    metrics = read_metrics(entries, "layer_metrics" if trace
                           else "end_to_end", rec)
    result = {"correct": bool(correct),
              "attempted": int(sum(x["units"] for x in rec.calls)),
              "failed": int(sum(x["failed"] for x in rec.calls)),
              "metrics": metrics, "device": dev_info}
    if trace:
        log_trace(rec, log)
        result["breakdown"] = rec.trace["breakdown"]
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def log_trace(rec: Record, log) -> None:
    """The per-kernel split of the traced stretch: device seconds and ops
    of each kernel in the work table, and the bound of each kind of work."""
    table = model.kernel_table()
    t = rec.trace
    log(f"traced stretch: calls {rec.profiled.start}..{rec.profiled.stop - 1}"
        f", {t['window_s']:.4f} s, device busy {t['busy_s']:.4f} s, "
        f"{t['device_ops']} device ops")
    split = {}
    for name, (sec, n) in t["by_name"].items():
        k = tr.kernel_name(name)
        row = table.get(k.split("::")[-1])
        tag = f"{row['tpu']} {row['work']}" if row else "outside the table"
        s = split.setdefault((k, tag), [0.0, 0])
        s[0] += sec
        s[1] += n
    for (k, tag), (sec, n) in sorted(split.items(), key=lambda x: -x[1][0]):
        log(f"  device {k} ({tag}): {sec * 1e3:.4f} ms, {n} ops")
    items = [it for i in rec.profiled for it in rec.calls[i]["work"]]
    by_kernel = {}
    for it in items:
        by_kernel.setdefault(it.kernel, []).append(it)
    for k, its in sorted(by_kernel.items()):
        tot, b, o = model.bound(its)
        log(f"  work {k}: bound {tot * 1e3:.4f} ms ({b * 1e3:.4f} by bytes, "
            f"{o * 1e3:.4f} by operations)")
