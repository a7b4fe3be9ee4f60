"""The arithmetic the metric readers share: a percentile over every
call, a rate over the whole window, the device's idle share of a traced
stretch and the stencil work's share of its roofline."""
from __future__ import annotations

import math

from h100_bench.trace import kernel_name
from h100_bench.work import model


def percentile(values, q: float) -> float:
    """The q-th percentile by nearest rank: the smallest value with at
    least q percent of the values at or below it."""
    v = sorted(values)
    return v[max(math.ceil(q / 100 * len(v)), 1) - 1]


def rate(rec, per_call) -> float:
    """per_call(call) summed over every call of the window, over the
    window's seconds (from the first call's start to the last call's
    end)."""
    return sum(per_call(c) for c in rec.calls) / rec.window_s


def done(call) -> int:
    """Units (solves, configurations) a call completed correctly by its
    own account."""
    return call["units"] - call["failed"]


def span_ms_per_unit(rec, span: str):
    """Milliseconds of the harness's span `span` a unit, over the calls
    outside the traced stretch (all of them in an untraced run), or None."""
    calls = [c for i, c in enumerate(rec.calls)
             if i not in rec.profiled and span in c.get("spans", {})]
    units = sum(c["units"] for c in calls)
    if not units:
        return None
    return 1e3 * sum(c["spans"][span] for c in calls) / units


def traced_cycles(rec) -> int:
    return sum(rec.calls[i].get("cycles", 0) for i in rec.profiled)


def idle_share(rec):
    """Percent of the traced stretch in which no device op ran."""
    t = rec.trace
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def kernel_roofline(rec):
    """Percent: the least time of the stencil work the traced calls
    performed (work/model.py, from the configuration and the calls'
    counts) over the device time of the ops that the kernel table maps to
    stencil work; None where the trace holds none of those ops."""
    t = rec.trace
    if not t:
        return None
    table = model.kernel_table()
    busy = sum(sec for name, (sec, _) in t["by_name"].items()
               if kernel_name(name).split("::")[-1] in table)
    if busy <= 0:
        return None
    items = [it for i in rec.profiled for it in rec.calls[i]["work"]]
    return 100.0 * model.bound(items)[0] / busy
