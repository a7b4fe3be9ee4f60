"""host_syncs: the program's driver.read_back spans a unit
(host_syncs.solve a solve, host_syncs.configs a configuration, the
setup's checks included): the host's waits on the card, over the
untraced calls."""
from h100_bench.program_spans import count_per_unit


def read(rec):
    return count_per_unit(rec, "driver.read_back")
