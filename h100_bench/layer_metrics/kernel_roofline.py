"""kernel_roofline: percent of the stencil work's roofline (the least
time of the traced calls' stencil work, over the device time of the ops
the work table maps to it; h100_bench.metrics.kernel_roofline)."""
from h100_bench.metrics import kernel_roofline


def read(rec):
    return kernel_roofline(rec)
