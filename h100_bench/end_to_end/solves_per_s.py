"""solves_per_s: sources solved to the cell's tolerance over the whole
window's seconds."""
from h100_bench.metrics import done, rate


def read(rec):
    return rate(rec, done)
