"""graph_reuse: the program's chunk.reuse spans a unit (graph_reuse.solve a
solve, graph_reuse.configs a configuration): the calls that replayed a
program kept with their hierarchy instead of warming up and capturing
one, over the untraced calls. Nothing where the program opens no such
span (it keeps no program)."""
from h100_bench.program_spans import count_per_unit


def read(rec):
    from tpu_multigrid_torch import profiling
    if "chunk.reuse" not in getattr(profiling, "_spans", {}):
        return None
    return count_per_unit(rec, "chunk.reuse")
