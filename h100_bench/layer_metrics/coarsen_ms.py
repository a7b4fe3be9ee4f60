"""coarsen_ms: host ms a configuration in the program's setup.coarsen
spans (site inverses, the transfers' normalization and Gram-Schmidt, the
Galerkin products, at each level and NTL copy), over the untraced
calls."""
from h100_bench.program_spans import ms_per_unit


def read(rec):
    return ms_per_unit(rec, ("setup.coarsen",))
