"""The readings a correctness limit is set from, on the card, in one
process: the numbers compared in sound runs of a cell over many seeds
(the lower reading), in runs with the cell's control switched on (its
mix's `control`: the reference one precision below the configuration's
put in the program's place, or the program's own lower-precision path;
the upper reading), and in runs with a fault of h100_bench.faults
planted under the timed path:

    python3 h100_bench/readings.py --workload flagship_rhs \
        --seeds 1,2,3 --control-seeds 4,5,6 --seconds 10
    python3 h100_bench/readings.py --workload ensemble8_stream \
        --fault wrong_config_setup --fault-seeds 7,8,9 --seconds 10

Each run prints one JSON line: the seed, what was switched on, the
numbers compared with their limits, the calls attempted and failed. The
benchmark's own runs never run a control or a fault.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


@contextlib.contextmanager
def patched(replacements: dict):
    """The program's entry points {name: replacement} put in place for the
    time of the block."""
    import tpu_multigrid_torch as mgt
    saved = {k: getattr(mgt, k) for k in replacements}
    for k, v in replacements.items():
        setattr(mgt, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(mgt, k, v)


def switched_on(workload: str, what: str):
    """(overrides of the mix's parameters, replacements of entry points)
    of the cell's control ("control") or of a fault's name."""
    import tpu_multigrid_torch as mgt
    from h100_bench import faults, harness
    from h100_bench.reference import control
    if what == "control":
        ctl = harness.cell(workload).traffic["control"]
        repl = control.PATCHES[ctl["patch"]](ctl) if "patch" in ctl else {}
        return ctl.get("overrides"), repl
    name, wrap = faults.FAULTS[what]
    return None, {name: wrap(getattr(mgt, name))}


def main(argv=None) -> int:
    from h100_bench import harness
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2

    def seeds(text, what):
        return [(int(s), what) for s in text.split(",") if s]
    runs = (seeds(args.seeds, None) + seeds(args.control_seeds, "control")
            + seeds(args.fault_seeds, args.fault))
    for seed, what in runs:
        t0 = time.time()
        overrides, repl = switched_on(args.workload, what) if what \
            else (None, {})
        with patched(repl):
            r = harness.run(args.workload, seed, args.seconds, False, "cuda",
                            overrides=overrides)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "switched_on": what, "checks": r["checks"],
                          "attempted": r["attempted"], "failed": r["failed"],
                          "correct": r["correct"],
                          "seconds": time.time() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
