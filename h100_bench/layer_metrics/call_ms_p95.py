"""call_ms_p95: the 95th percentile of the whole time of the calls outside
the traced stretch (host clock, from the call to its result after a device
synchronize), in milliseconds: solve_ms_p95's number where the host's
drift leaves too wide a spread for an end-to-end bound."""
from h100_bench.metrics import percentile


def read(rec):
    ms = [1e3 * c["seconds"] for i, c in enumerate(rec.calls)
          if i not in rec.profiled]
    return percentile(ms, 95) if ms else None
