"""A run of a cell on several cards: one process (rank) a card, rank 0
leading. run.py comes here for a cell whose `chips` is above 1:

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

`launch` starts `chips` ranks by `torch.multiprocessing.start_processes`
(the spawn start method) and waits for them. Rank r makes cuda:r, of the cards the machine shows, its device
before anything touches a card. Every rank joins one default process
group (NCCL on the cards, gloo on the CPU), the group over which a
traffic kind's set-up builds its mesh (`parallel.multihost.global_mesh`),
and a second group over gloo that carries the harness's own messages on
the host. Both meet at a file store in a temporary directory, with the
program's process-group timeout (`parallel.multihost.TIMEOUT_S`).

Rank 0 runs `harness.run` unchanged, with the launcher's process start as
the run's start, so `setup_s` covers the whole launch. The kind it runs
is wrapped: before each call, and before the release and the check, it
announces the step on the host group (two numbers, no work on a card).
Every other rank builds the same Context from `harness.cell` and
`harness.Context`, runs the kind's `setup`, and then does each step it
is told. So rank 0 alone decides when the window ends, every rank runs
the same calls, and a kind holds no code of this protocol.

Only rank 0's trace gives the per-layer metrics and the breakdown. The
other ranks profile the same calls for their device's busy seconds
alone, so that `busy_s` is averaged over the cards used.

The result is rank 0's, with `device` naming every card: `count` is the
number of ranks, `memory_peak_bytes` the fullest card's peak, and
`cards` lists each rank's card (index, name, UUID, peak bytes). Each
rank writes its report into the temporary directory once its work went
well, and the launcher reads them after every rank has ended. A rank
that raises, ends without its report or loads JAX fails the run: the
others are stopped and no result is printed. A rank that hangs makes the
others' next message time out, and once one rank has ended the rest get
the process-group timeout to end too. A launcher that is killed takes
its ranks with it (torch's spawn sets SIGINT as their parent-death
signal).
"""
from __future__ import annotations

import importlib
import os
import pickle
import statistics
import sys
import tempfile
import time
import types
from pathlib import Path

from h100_bench import harness
from h100_bench import trace as tr

CALL, RELEASE, CHECK = 0, 1, 2


class RankFailed(RuntimeError):
    """A rank raised, was killed, hung or ended without its report."""


def launch(workload: str, seed: int, seconds: float, trace: bool,
           chips: int, platform: str, t_start: float, man: dict):
    """Run the cell on `chips` ranks ('cuda': rank r on cuda:r, NCCL;
    'cpu': gloo, for the tests). Returns (rank 0's result with every
    card in `device`, the forbidden modules any process loaded); raises
    RankFailed where a rank failed."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        ranks = mp.start_processes(
            _rank, args=(chips, tmp, platform, workload, seed, seconds,
                         trace, t_start, man),
            nprocs=chips, join=False, start_method="spawn")
        try:
            _join(ranks)
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            raise RankFailed(str(e).strip()) from None
        reports = [_report(tmp, r) for r in range(chips)]
    result = reports[0]["result"]
    cards = [{k: r[k] for k in ("index", "name", "uuid",
                                "memory_peak_bytes")} for r in reports]
    dev = result["device"]
    dev.update(count=len(cards),
               memory_peak_bytes=max(c["memory_peak_bytes"] for c in cards),
               cards=cards)
    if trace:
        dev["busy_s"] = statistics.fmean(r["busy_s"] for r in reports)
    bad = sorted(set(harness.forbidden_modules()).union(
        *(r["forbidden"] for r in reports)))
    return result, bad


def _join(ranks) -> None:
    """Wait for every rank. torch's join stops the rest and raises as soon
    as one ends with another code than 0; once one has ended, the rest get
    the process-group timeout, and are killed after it."""
    from tpu_multigrid_torch.parallel.multihost import TIMEOUT_S
    deadline = None
    while not ranks.join(None if deadline is None else
                         max(0.0, deadline - time.monotonic())):
        if deadline is None:
            deadline = time.monotonic() + TIMEOUT_S
        elif time.monotonic() >= deadline:
            late = [p for p in ranks.processes if p.is_alive()]
            for p in late:
                p.kill()
                p.join()
            raise RankFailed(f"{len(late)} rank(s) still ran {TIMEOUT_S:g} s "
                             "after another ended")


def _report(tmp: str, rank: int) -> dict:
    """A rank's report, which it writes only once its work went well."""
    try:
        with open(Path(tmp, f"rank{rank}.pkl"), "rb") as f:
            return pickle.load(f)
    except FileNotFoundError:
        raise RankFailed(f"rank {rank} ended with no report") from None


def _rank(rank, world, tmp, platform, workload, seed, seconds, trace,
          t_start, man):
    """One rank: join both groups, lead (rank 0) or follow, and write the
    report (its card, its peak, its busy seconds, what it loaded) into
    `tmp`, where the groups' file store lies too."""
    import datetime

    import torch
    torch.set_num_threads(1)
    cuda = platform == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    import torch.distributed as dist
    from tpu_multigrid_torch.parallel.multihost import TIMEOUT_S
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    dist.init_process_group("nccl" if cuda else "gloo",
                            init_method=f"file://{tmp}/store",
                            world_size=world, rank=rank, timeout=timeout)
    host = dist.new_group(backend="gloo", timeout=timeout)
    device = "cuda" if cuda else "cpu"
    report = (_lead(workload, seed, seconds, trace, device, t_start, man,
                    host) if rank == 0 else
              _follow(workload, seed, trace, device, man, host))
    props = torch.cuda.get_device_properties(rank) if cuda else None
    report.update(index=rank, name=props.name if cuda else "cpu",
                  uuid=str(getattr(props, "uuid", "")) if cuda else "",
                  forbidden=harness.forbidden_modules())
    part = Path(tmp, f"rank{rank}.part")
    with open(part, "wb") as f:
        pickle.dump(report, f)
    os.replace(part, Path(tmp, f"rank{rank}.pkl"))
    # only after a rank's own work went well: a rank that raises exits
    # at once, with no teardown that could wait on the others
    dist.destroy_process_group()


def _announce(host, op: int, i: int = 0) -> None:
    import torch
    import torch.distributed as dist
    dist.broadcast(torch.tensor([op, i], dtype=torch.int64, device="cpu"),
                   0, group=host)


def _led(kind, host):
    """The kind as rank 0 runs it: each call, the release and the check
    announced to the other ranks first."""
    led = types.ModuleType(kind.__name__)
    led.__dict__.update(kind.__dict__)

    def call(state, i):
        _announce(host, CALL, i)
        return kind.call(state, i)

    def release(state):
        _announce(host, RELEASE)
        return kind.release(state)

    def check(state):
        _announce(host, CHECK)
        return kind.check(state)

    led.call, led.release, led.check = call, release, check
    return led


def _lead(workload, seed, seconds, trace, device, t_start, man,
          host) -> dict:
    """Rank 0: harness.run, unchanged, on the announcing kind."""
    name = f"h100_bench.traffic.{harness.cell(workload, man).traffic['kind']}"
    kind = importlib.import_module(name)
    sys.modules[name] = _led(kind, host)
    try:
        result = harness.run(workload, seed, seconds, trace, device, t_start,
                             man=man)
    finally:
        sys.modules[name] = kind
    return {"result": result,
            "memory_peak_bytes": result["device"]["memory_peak_bytes"],
            "busy_s": result["device"].get("busy_s")}


def _follow(workload, seed, trace, device, man, host) -> dict:
    """Every other rank: the cell's set-up as harness.run makes it, then
    each step rank 0 announces, until the check. Its peak is read before
    the release, as rank 0's is; with trace, the calls rank 0 traces are
    profiled for the device's busy seconds."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    c = harness.cell(workload, man)
    kind = importlib.import_module(f"h100_bench.traffic.{c.traffic['kind']}")
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    ctx = harness.Context(c.config, c.traffic, seed, device)
    state = kind.setup(ctx)
    ctx.sync()
    traced = range(1, 1 + c.traffic["profile_calls"])
    out = {"memory_peak_bytes": 0, "busy_s": None}
    step = torch.zeros(2, dtype=torch.int64, device="cpu")
    while True:
        dist.broadcast(step, 0, group=host)
        op, i = step.tolist()
        if op == CALL:
            kind.call(state, i)
            ctx.sync()
            # started before rank 0's traced stretch, so that rank 0 does
            # not wait on a profiler's start in it
            if trace and i == traced.start - 1:
                prof = profile(activities=[ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if cuda else []))
                prof.__enter__()
            if trace and i == traced.stop - 1:
                prof.__exit__(None, None, None)
                out["busy_s"] = tr.union_seconds(tr.events(prof)[0])
        elif op == RELEASE:
            if cuda:
                out["memory_peak_bytes"] = int(
                    torch.cuda.max_memory_allocated(ctx.device))
            kind.release(state)
            if cuda:
                torch.cuda.empty_cache()
        else:
            kind.check(state)
            return out
