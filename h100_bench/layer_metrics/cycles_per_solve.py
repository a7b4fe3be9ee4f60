"""cycles_per_solve: the mean of SolveResult.iters over the window's
solves (the program's own count)."""


def read(rec):
    units = sum(c["units"] for c in rec.calls)
    return sum(c["cycles"] for c in rec.calls) / units if units else None
