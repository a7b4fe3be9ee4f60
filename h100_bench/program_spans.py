"""The program's own spans (tpu_multigrid_torch.profiling.roots), matched
to the window's calls, for the readers of the per-layer metrics that read
them.

A root is one request the program served (a solve, a setup) on
time.perf_counter_ns; the harness keeps each call's start and end on
time.perf_counter, from the window's start. Nothing after the window opens a root (the reference judges the answers
in plain PyTorch), so the last root ended in the last call, and that one
offset puts every call on the roots' clock; a root belongs to the call
that holds its middle. A root of the window that falls between calls, or
an untraced call that gets no root, says the offset is wrong: nothing is
read then. Only the calls outside the traced stretch are read, as
call_ms_p95 reads them."""
from __future__ import annotations

import bisect


def calls(rec):
    """[(call, spans, device_ms)] of the window's untraced calls: spans
    {name: [count, total ns, self ns]} and device_ms {name: ms} summed
    over the roots inside the call; None where the program keeps no
    spans, where its ring of roots has dropped some of the window's, or
    where the roots do not fit the calls."""
    try:
        from tpu_multigrid_torch import profiling
    except ImportError:
        return None
    roots_of = getattr(profiling, "roots", None)
    roots = roots_of() if roots_of is not None else None
    if not roots or not rec.calls:
        return None
    w0 = roots[-1].end_ns - round(rec.calls[-1]["t1"] * 1e9)
    starts = [w0 + round(c["t0"] * 1e9) for c in rec.calls]
    ends = [w0 + round(c["t1"] * 1e9) for c in rec.calls]
    if len(roots) >= profiling.RING and roots[0].start_ns > starts[0]:
        return None
    out = [(c, {}, {}) for c in rec.calls]
    hit = [False] * len(rec.calls)
    for r in roots:
        mid = (r.start_ns + r.end_ns) // 2
        if mid < starts[0]:
            continue             # the set-up's
        i = bisect.bisect_right(starts, mid) - 1
        if mid > ends[i]:
            return None
        hit[i] = True
        _, spans, dev = out[i]
        for name, (n, total, own) in r.spans.items():
            acc = spans.setdefault(name, [0, 0, 0])
            acc[0] += n
            acc[1] += total
            acc[2] += own
        for name, ms in r.device_ms.items():
            dev[name] = dev.get(name, 0.0) + ms
    keep = [i for i in range(len(rec.calls)) if i not in rec.profiled]
    if not all(hit[i] for i in keep):
        return None
    return [out[i] for i in keep]


def _per_unit(rec, value):
    got = calls(rec)
    if got is None:
        return None
    units = sum(c["units"] for c, _, _ in got)
    if not units:
        return None
    return sum(value(spans, dev) for _, spans, dev in got) / units


def ms_per_unit(rec, names):
    """Host ms a unit (a solve, a configuration) inside the spans
    `names`, every occurrence's whole time."""
    return _per_unit(rec, lambda spans, dev: 1e-6 * sum(
        spans[n][1] for n in names if n in spans))


def count_per_unit(rec, name):
    """Spans `name` a unit."""
    return _per_unit(rec, lambda spans, dev: spans.get(name, (0,))[0])


def device_ms_per_unit(rec, name):
    """Device ms a unit recorded under span `name`."""
    return _per_unit(rec, lambda spans, dev: dev.get(name, 0.0))
