"""Run one cell of the benchmark of tpu_multigrid_torch once:

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

A cell of one card runs in this process, on the first CUDA card of this
machine. A cell of more cards runs one process a card, rank r on cuda:r,
rank 0 leading (h100_bench/ranks.py); its result's `device` names every
card used.

The last line of standard output is the result's JSON object (the end-to-
end metrics with --trace 0, the per-layer ones with --trace 1); the last
lines of standard error are the numbers the correctness check compared,
each beside its limit. Exits 2 without a result where the machine lacks
the cards the cell asks for, 3 where a module of JAX or of the JAX
package was loaded (in any rank), and 1 where a rank failed.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def power_limit() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"


def main(argv=None, platform: str = "cuda") -> int:
    """One run; returns the exit code. `platform` "cpu" skips the look for
    cards and runs on the CPU (gloo between ranks): the tests' way in."""
    from h100_bench import harness
    t_start = harness.process_start_time()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    # load from one thread: torch's pool of host threads spun on other
    # cores and made the calls' host time drift (PERF.md, noise)
    torch.set_num_threads(1)
    man = harness.manifest()
    chips = {w["name"]: w["chips"] for w in man["workloads"]}
    if args.workload not in chips:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    if platform == "cuda" and (
            not torch.cuda.is_available()
            or torch.cuda.device_count() < chips[args.workload]):
        print(f"{args.workload} needs {chips[args.workload]} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    if chips[args.workload] == 1:
        result = harness.run(args.workload, args.seed, args.seconds,
                             bool(args.trace), platform, t_start, man=man)
        bad = harness.forbidden_modules()
    else:
        from h100_bench import ranks
        try:
            result, bad = ranks.launch(args.workload, args.seed,
                                       args.seconds, bool(args.trace),
                                       chips[args.workload], platform,
                                       t_start, man)
        except ranks.RankFailed as e:
            print(f"no result: {e}", file=sys.stderr)
            return 1
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 3
    if args.trace:
        from h100_bench.work import model
        pk = model.peaks()
        print(f"peaks: {pk['hbm_bytes_per_s']:.4g} B/s HBM, "
              f"{pk['flops_per_s']} flop/s ({pk['card']}); this card: "
              f"{power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
