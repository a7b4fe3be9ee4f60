"""Traffic kind `probe`, for the tests of the launcher of cells on several
cards (test_h100_ranks.py writes it into a copy of the benchmark, as
traffic/probe.py): each call sleeps `sleep_s` times one plus the rank, so
the ranks' calls take different times, and scales a tensor of
`elements` on the rank's device. The check gathers every rank's count of
calls over the default group and compares their spread with 0.

Parameters beside those: `fail_rank` raises at call `fail_call`;
`forbidden_rank` loads a module named as JAX's library in its set-up;
`pid_dir`, where each rank writes its process id.
"""
import os
import sys
import time
import types
from pathlib import Path
from types import SimpleNamespace

import torch
import torch.distributed as dist


def setup(ctx):
    p, rank = ctx.params, dist.get_rank()
    if p.get("pid_dir"):
        Path(p["pid_dir"], str(rank)).write_text(str(os.getpid()))
    if p.get("forbidden_rank") == rank:
        sys.modules["jaxlib"] = types.ModuleType("jaxlib")
    x = torch.ones(p["elements"], device=ctx.device)
    return SimpleNamespace(ctx=ctx, rank=rank, x=x, calls=0)


def call(st, i):
    p = st.ctx.params
    if p.get("fail_rank") == st.rank and p.get("fail_call") == i:
        raise RuntimeError(f"rank {st.rank} fails at call {i}")
    time.sleep(p["sleep_s"] * (1 + st.rank))
    st.x.mul_(1.0)
    st.calls += 1
    return {"units": 1, "failed": 0, "work": []}


def release(st):
    st.x = None


def check(st):
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, st.calls)
    if st.rank == 0:
        print(f"calls by rank: {counts}", file=sys.stderr)
    return {"calls_apart": (max(counts) - min(counts), 0)}
