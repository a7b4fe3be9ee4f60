"""idle_share: percent of the traced stretch in which no device op ran."""
from h100_bench.metrics import idle_share


def read(rec):
    return idle_share(rec)
