"""device_ops_per_cycle: device ops in the traced stretch over the cycles
the traced solves report."""
from h100_bench.metrics import traced_cycles


def read(rec):
    n = traced_cycles(rec)
    if not rec.trace or not n or not rec.trace["device_ops"]:
        return None
    return rec.trace["device_ops"] / n
