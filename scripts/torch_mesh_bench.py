#!/usr/bin/env python3
"""The distributed port (tpu_multigrid_torch.parallel) across the ranks of
one host, against the single-device solve on the same hierarchy.

    torchrun --nproc-per-node=4 scripts/torch_mesh_bench.py [--out FILE]
    torchrun --nproc-per-node=4 scripts/torch_mesh_bench.py \\
        --platform cpu --L 32 --nlevels 2 --null-iters 20   # over gloo

One process a rank: rank r on cuda:LOCAL_RANK over NCCL, or with
--platform cpu on the CPU over gloo. For each mesh shape of --meshes
(default: every MX x MY = world size), on the flagship's config at --L
with --nlevels levels (Wilson, m=-0.005, NTL with 4 copies and min-res
weights, rbgs x4, --null-iters near-null sweeps, complex64, to 1e-6; the
gauge phases 0.2 N(0,1) from default_rng(--seed)):

- the setup by build_hierarchy_sharded: seconds (host clock, each rank
  synchronized; the slowest rank's), in turns with rank 0's single-device
  build_hierarchy;
- the solve by make_sharded_solver: cycles, residual, seconds and the
  kernels it launched;
- ms a sharded cycle with the halo overlap and with the concat baseline,
  in turns (CUDA events on each rank; the median of --reps runs of
  --cycles cycles; the slowest rank's).

Rank 0 also solves on one device the same hierarchy, gathered, with links
off (the dense level 0 that the sharded cycle runs): its cycles, the
relative difference of the two solutions, and its ms a cycle on the
kernels. The other ranks wait. Prints every rank's card name and power
limit, and one JSON object as its last line (written to --out too).
chip_smoke.py's mesh phase calls run_mesh at world size 1.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import tpu_multigrid_torch as mgt  # noqa: E402
from tpu_multigrid_torch.parallel import multihost, setup, sharded  # noqa: E402


def card_line(dev) -> str:
    if dev.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "-i", str(dev.index),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def ms_of(fn, dev, reps):
    """Median ms of fn() over reps runs, after one warm-up run: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    sync(dev)
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def peak_start(dev):
    """Start a peak-memory reading on the card: the bytes allocated now."""
    if dev.type != "cuda":
        return None
    torch.cuda.reset_peak_memory_stats(dev)
    return torch.cuda.memory_allocated(dev)


def peak_gib(dev, base):
    """GiB allocated at the peak since peak_start, beyond its base."""
    if base is None:
        return None
    return (torch.cuda.max_memory_allocated(dev) - base) / 2**30


def slowest(x: float, mesh) -> float:
    t = torch.tensor([x], dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return float(t)


def run_mesh(shape, cfg, dev, D, b, n_cyc=5, reps=3):
    """The sharded setup and solve of cfg on an MX x MY mesh of every rank
    of the default group, beside the single-device path on rank 0 (the
    other ranks wait). Every rank calls it together; returns the mesh's
    row (rank 0's has the single-device numbers too).

    - setup_s: build_hierarchy_sharded, seconds, the slowest rank's; timed
      in turns with rank 0's build_hierarchy (check=False,
      setup_single_s), sharded first, twice: the second pair is kept
      (the first sharded setup also pays the collectives' set-up,
      setup_first_s). D may lie in host memory: the single-device setup
      takes a copy on the card made before it is timed;
    - setup_peak_gib: the most device memory the sharded setup allocated
      beyond what was allocated before it, the largest rank's
      (setup_single_peak_gib: the same for the single-device setup); None
      on the CPU;
    - the solve by make_sharded_solver from this rank's part of the
      hierarchy: cycles, residual, seconds, and the launch counters of
      ops.cuda_stencil set to 0 just before it and read just after
      (launches_solve: the replicated levels' kernels);
    - ms a sharded cycle with the halo overlap and with the concat
      baseline, in turns (CUDA events on each rank, the median of reps
      runs of n_cyc cycles, the slowest rank's);
    - rank 0: the single-device solve on the gathered hierarchy with links
      off (the dense level 0 that the sharded cycle runs): its cycles,
      residual, the relative difference of the two solutions, and its ms
      a cycle on the kernels."""
    cs = mgt.ops.cuda_stencil
    mesh = multihost.global_mesh(shape, device=dev)
    rank0 = mesh.rank == 0
    dense = cfg.replace(links="off")
    D_dev = D.to(dev) if rank0 else None
    t_setup, t_single, peak, peak_single = [], [], [], []
    for _ in range(2):
        hier_s = None
        dist.barrier()
        base = peak_start(dev)
        t0 = time.perf_counter()
        hier_s = setup.build_hierarchy_sharded(D, cfg, mesh)
        sync(dev)
        t_setup.append(slowest(time.perf_counter() - t0, mesh))
        peak.append(peak_gib(dev, base))
        if rank0:
            base = peak_start(dev)
            t0 = time.perf_counter()
            mgt.build_hierarchy(D_dev, cfg, check=False)
            sync(dev)
            t_single.append(time.perf_counter() - t0)
            peak_single.append(peak_gib(dev, base))
    del D_dev
    dist.barrier()
    solver = sharded.make_sharded_solver(cfg, mesh, 100)
    cs.reset_launches()
    t0 = time.perf_counter()
    phis, iters, res = solver(hier_s, mgt.zero_fields(cfg, dev), b)
    sync(dev)
    t_solve = slowest(time.perf_counter() - t0, mesh)
    launches = {k: v for k, v in cs.launches.items() if v}
    b_s = sharded.shard_fields((b,), cfg, mesh)[0]

    def cycles(c):
        cycle = sharded.make_sharded_cycle(c, mesh)
        p0 = sharded.shard_fields(mgt.zero_fields(c, dev), c, mesh)

        def run():
            p = p0
            for _ in range(n_cyc):
                p, _ = cycle(hier_s, p, b_s)
        return run

    runs = {ov: cycles(cfg.replace(halo_overlap=ov)) for ov in (True, False)}
    ms = {True: [], False: []}
    for ov in (False, True, True, False):
        ms[ov].append(ms_of(runs[ov], dev, reps) / n_cyc)
    out = {"mesh": list(shape),
           "sharded_levels": list(sharded.shardable_levels(cfg, mesh)),
           "setup_s": t_setup[1], "setup_first_s": t_setup[0],
           "setup_peak_gib": (None if peak[1] is None
                              else slowest(peak[1], mesh)),
           "cycles": iters, "res": res, "solve_s": t_solve,
           "launches_solve": launches,
           "ms_per_cycle_overlap": slowest(statistics.median(ms[True]), mesh),
           "ms_per_cycle_concat": slowest(statistics.median(ms[False]), mesh)}
    hier = sharded.gather_hierarchy(hier_s, cfg, mesh)
    if rank0:
        ref = mgt.solve(hier, b, dense, max_iters=100)
        rel = float((phis[0] - ref.phi).abs().max() / ref.phi.abs().max())

        def single():
            p = mgt.zero_fields(dense, dev)
            for _ in range(n_cyc):
                p, _ = mgt.cycle(hier, p, b, dense)

        out.update(setup_single_s=t_single[1],
                   setup_single_peak_gib=peak_single[1],
                   single_cycles=ref.iters,
                   single_res=ref.resmag, phi_rel_diff=rel,
                   ms_per_cycle_single=ms_of(single, dev, reps) / n_cyc)
    dist.barrier()
    return out


def main():
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--L", type=int, default=256)
    p.add_argument("--nlevels", type=int, default=3)
    p.add_argument("--null-iters", type=int, default=100)
    p.add_argument("--seed", type=int, default=4302529)
    p.add_argument("--meshes", default=None,
                   help="mesh shapes MXxMY,... (default: every one of the "
                        "world size)")
    p.add_argument("--cycles", type=int, default=5)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--platform", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args()

    cpu = args.platform == "cpu"
    if not cpu and not torch.cuda.is_available():
        raise SystemExit("torch_mesh_bench: no CUDA device (pass "
                         "--platform cpu to rehearse over gloo)")
    if cpu:
        torch.set_num_threads(1)
    multihost.initialize(backend="gloo" if cpu else "nccl", world_size=1)
    world, rank = dist.get_world_size(), dist.get_rank()
    dev = (torch.device("cpu") if cpu else
           torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))))
    cards = [None] * world
    dist.all_gather_object(cards, card_line(dev))
    if args.meshes:
        shapes = [tuple(int(x) for x in m.split("x"))
                  for m in args.meshes.split(",")]
    else:
        shapes = [(mx, world // mx) for mx in range(1, world + 1)
                  if world % mx == 0]
    rng = np.random.default_rng(args.seed)
    # the global operator stays in host memory: each rank's setup moves
    # only its tile of it to the card
    U = mgt.models.gauge.gauge_from_phases(
        0.2 * rng.normal(size=(2, args.L, args.L)), torch.complex64)
    D = mgt.models.operators.assemble("wilson", U, -0.005)
    b = torch.zeros((2, args.L, args.L), dtype=torch.complex64, device=dev)
    b[0, 2, 2] = 5.0
    rows = []
    cfg = mgt.MGConfig(L=args.L, stencil="wilson", m=-0.005,
                       nlevels=args.nlevels, ntl=True, num_iters=4,
                       null_iters=args.null_iters, dtype="complex64",
                       res_threshold=1e-6, smoother="rbgs")
    for shape in shapes:
        rows.append(run_mesh(shape, cfg, dev, D, b, args.cycles, args.reps))
        if rank == 0:
            print(json.dumps(rows[-1]), flush=True)
    if rank == 0:
        for i, c in enumerate(cards):
            print(f"rank {i}: {c}")
        result = {"world_size": world, "backend": dist.get_backend(),
                  "cards": cards, "L": args.L, "nlevels": args.nlevels,
                  "meshes": rows}
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(result) + "\n")
        print(json.dumps(result))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
