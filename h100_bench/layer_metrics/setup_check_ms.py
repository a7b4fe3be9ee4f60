"""setup_check_ms: host ms a configuration in the program's setup.check
spans (the setup's host checks and their waits on the card), over the
untraced calls."""
from h100_bench.program_spans import ms_per_unit


def read(rec):
    return ms_per_unit(rec, ("setup.check",))
