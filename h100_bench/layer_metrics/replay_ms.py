"""replay_ms: host ms a solve in the program's chunk.replay spans (the
graphs' launches; a new graph's first replay uploads it), over the
untraced calls."""
from h100_bench.program_spans import ms_per_unit


def read(rec):
    return ms_per_unit(rec, ("chunk.replay",))
