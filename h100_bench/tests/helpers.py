"""Small sizes at which a whole run of a cell fits a CPU test."""
SMALL = {"mgconfig": {"L": 16, "nlevels": 2, "null_iters": 8}}
CELLS = {
    "flagship_rhs": {},
    "large_rhs": {},
    "flagship_configs": {"pool": 4},
    "ensemble8_stream": {"pool": 8, "batch": 4, "n_cycles": 40},
}
SEED = 2 ** 31 + 4302529


def small(cell, **extra):
    return {**SMALL, **CELLS[cell], **extra}
