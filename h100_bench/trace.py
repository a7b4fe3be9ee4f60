"""Reduction of a torch.profiler run over the traced stretch of a window
to what the per-layer metrics read: the device intervals and their
union, the device ops by name, and the idle gaps named by what the host
was doing. Nothing is written to disk."""
from __future__ import annotations

import collections

# the harness's own spans (torch.profiler.record_function), by which an
# idle gap is named beside the host op inside it
SPAN_PREFIX = "h100_bench."


def events(prof):
    """(device, host): lists of (start_us, end_us, name) of the device's
    ops (kernels, copies, sets) and of the host's ops and spans."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for e in prof.events():
        rec = (float(e.time_range.start), float(e.time_range.end), e.name)
        if e.device_type == DeviceType.CUDA:
            # a span's shadow on the device's timeline is no device op
            if not (getattr(e, "is_user_annotation", False)
                    or e.name.startswith(SPAN_PREFIX)):
                dev.append(rec)
        elif e.device_type == DeviceType.CPU:
            host.append(rec)
    return dev, host


def merge(intervals):
    """The union of (start, end, ...) intervals as sorted, disjoint
    [start, end] pairs."""
    out = []
    for s, e, *_ in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def union_seconds(intervals) -> float:
    """Seconds covered by the union of (start_us, end_us, ...) intervals."""
    return sum(e - s for s, e in merge(intervals)) / 1e6


def kernel_name(name: str) -> str:
    """The qualified function name of a device op as the profiler prints
    it, without its return type, template arguments, parameters and
    anonymous namespace ('void (anonymous namespace)::dense_update_kernel
    <float, 4>(...)' -> 'dense_update_kernel'); a name that is no
    function's ('Memcpy DtoH (Device -> Pinned)') up to its bracket."""
    s = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(s):
        depth += {"<": 1, ">": -1}.get(ch, 0)
        if ch == "(" and depth == 0:
            s = s[:i]
            break
    s = s.strip()
    if "<" not in s and "::" not in s:
        return s
    while s.endswith(">"):
        depth = 0
        for i in range(len(s) - 1, -1, -1):
            depth += {">": 1, "<": -1}.get(s[i], 0)
            if depth == 0:
                s = s[:i].rstrip()
                break
    return s.split()[-1] if s.split() else name


def by_name(dev):
    """{name: [seconds, count]} of device ops by the name printed."""
    out = collections.defaultdict(lambda: [0.0, 0])
    for s, e, name in dev:
        out[name][0] += (e - s) / 1e6
        out[name][1] += 1
    return dict(out)


def idle_gaps(dev, host, top: int = 10):
    """The `top` longest gaps between the device's busy intervals, each
    [what the host was doing, seconds]: the innermost host op that spans
    the gap's middle, after the innermost harness span around it."""
    busy = merge(dev)
    gaps = sorted(((b[0] - a[1], a[1], b[0]) for a, b in zip(busy, busy[1:])),
                  reverse=True)[:top]
    out = []
    for length, s, e in gaps:
        mid = 0.5 * (s + e)
        around = [h for h in host if h[0] <= mid <= h[1]]
        spans = [h for h in around if h[2].startswith(SPAN_PREFIX)]
        ops = [h for h in around if not h[2].startswith(SPAN_PREFIX)]
        parts = [max(spans)[2]] if spans else []
        if ops:
            parts.append(max(ops)[2])
        out.append([" > ".join(parts) or "host idle", length / 1e6])
    return out


def reduce(prof, window_s: float, top: int = 10) -> dict:
    """What the readers take from one traced stretch of `window_s` seconds
    (host clock, the card synchronized at both ends)."""
    dev, host = events(prof)
    names = by_name(dev)
    ops = sorted(([n, v[0]] for n, v in names.items()),
                 key=lambda x: -x[1])[:top]
    return {"window_s": window_s, "busy_s": union_seconds(dev),
            "device_ops": len(dev), "by_name": names,
            "breakdown": {"device_ops": ops,
                          "idle_gaps": idle_gaps(dev, host, top)}}
