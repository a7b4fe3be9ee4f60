"""solve_ms_p95: the 95th percentile of every call's whole time in the
window (host clock, from the call to its result after a device
synchronize), in milliseconds."""
from h100_bench.metrics import percentile


def read(rec):
    return percentile([1e3 * c["seconds"] for c in rec.calls], 95)
