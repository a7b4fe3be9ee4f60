"""device_ms_per_cycle: the device's busy milliseconds in the traced
stretch (the union of its ops' intervals) over the cycles the traced
solves report."""
from h100_bench.metrics import traced_cycles


def read(rec):
    n = traced_cycles(rec)
    if not rec.trace or not n or rec.trace["busy_s"] <= 0:
        return None
    return 1e3 * rec.trace["busy_s"] / n
