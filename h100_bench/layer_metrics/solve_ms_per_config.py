"""solve_ms_per_config: the harness's span around the solve calls of a
call (synchronized), a configuration, over the untraced calls."""
from h100_bench.metrics import span_ms_per_unit


def read(rec):
    return span_ms_per_unit(rec, "solve")
