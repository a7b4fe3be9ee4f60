"""capture_ms: host ms a unit (capture_ms.solve a solve,
capture_ms.configs a configuration) in the program's chunk.warm_up,
chunk.capture and chunk.release spans: what a call pays because its
drivers make their CUDA graphs anew, over the untraced calls."""
from h100_bench.program_spans import ms_per_unit


def read(rec):
    return ms_per_unit(rec, ("chunk.warm_up", "chunk.capture",
                             "chunk.release"))
