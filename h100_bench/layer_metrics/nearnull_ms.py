"""nearnull_ms: host ms a configuration in the program's setup.nearnull
spans (the near-null relaxation), over the untraced calls."""
from h100_bench.program_spans import ms_per_unit


def read(rec):
    return ms_per_unit(rec, ("setup.nearnull",))
