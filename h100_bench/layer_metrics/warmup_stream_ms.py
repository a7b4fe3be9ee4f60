"""warmup_stream_ms: ms a solve between the CUDA events around the
program's chunk warm-ups on their side stream, over the untraced calls:
the stream's elapsed time, which is the warm-up's device work only where
the card is slower than the host's launches (large_rhs; at L=256 it
reads the host's launch time, which capture_ms.solve already counts)."""
from h100_bench.program_spans import device_ms_per_unit


def read(rec):
    return device_ms_per_unit(rec, "chunk.warm_up")
