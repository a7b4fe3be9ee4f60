"""configs_per_s: gauge configurations set up and solved over the whole
window's seconds."""
from h100_bench.metrics import done, rate


def read(rec):
    return rate(rec, done)
