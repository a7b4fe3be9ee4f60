#!/usr/bin/env python3
"""Same-card check that another version of the port's package launches the
same kernels and gives the same bits as this checkout's, for a change
that should move neither (the choice of implementation in
ops/dispatch.py, a refactor of the cycle):

    python3 scripts/torch_dispatch_ab.py OTHER_DIR [--out FILE]

OTHER_DIR holds the other `tpu_multigrid_torch` (for example the parent
commit's, `git archive <commit> tpu_multigrid_torch | tar -x -C
OTHER_DIR`), loaded beside this one as scripts/torch_smoother_ab.py loads
it. On the same inputs, complex64, each package runs:

- build_hierarchy of the flagship (Wilson L=256, 3 levels, NTL, 100
  near-null sweeps), from the same links and default near-null starts;
- 10 cycles of its `cycle` on one flagship hierarchy, and 4 on one large
  flagship hierarchy (L=2048, 6 levels, 500 near-null sweeps, as
  h100_bench's wilson_ntl_L2048 cycles);
- build_hierarchies_batched and solve_ensemble (18 cycles) of 8 gauge
  configurations at L=128 (h100_bench's ensemble8_stream);
- one cycle of each flagship captured and replayed as the drivers replay
  their chunks (chip_smoke.replayed_cycle): its launch counters and its
  device ops under torch.profiler.

Each output is held bit for bit against the other package's, and the
other package is run twice, so that where it is not bit-stable against
itself the difference it allows is printed beside. Prints one JSON object
(with the card's name and power limit) as its last line and writes it to
FILE when --out is given; exits 1 when a case differs by more than the
other package differs from itself, or when the replayed cycles' launches
or device ops differ.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE / "scripts"))


def tensors(obj, prefix=""):
    """{name: tensor} of a hierarchy, a tuple of fields or a tensor."""
    import torch
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    if isinstance(obj, (tuple, list)):
        out = {}
        for i, x in enumerate(obj):
            out.update(tensors(x, f"{prefix}[{i}]"))
        return out
    if obj is None:
        return {}
    out = {}
    for name in ("levels", "ntl", "gauge", "D", "D0inv", "phi_null"):
        if hasattr(obj, name):
            out.update(tensors(getattr(obj, name), f"{prefix}.{name}"))
    return out


def worst(a, b):
    """(same bits, largest |a - b| / max |b|) over the tensors of a and b."""
    ta, tb = tensors(a), tensors(b)
    assert ta.keys() == tb.keys(), (sorted(ta), sorted(tb))
    same, rel = True, 0.0
    for k in ta:
        x, y = ta[k], tb[k]
        if not (x.shape == y.shape and x.dtype == y.dtype):
            return False, float("inf")
        if not bool((x == y).all()):
            same = False
            d = float((x - y).abs().max()) / max(float(y.abs().max()), 1e-300)
            rel = max(rel, d)
    return same, rel


def compare(tag, run, this, other):
    """run(p) for each package, the other's twice: the change's difference
    against the other's difference from itself."""
    got_o = run(other)
    got_t = run(this)
    again = run(other)
    same, rel = worst(got_t, got_o)
    same_o, rel_o = worst(again, got_o)
    ok = same or rel <= rel_o
    print(f"{tag}: {'same bits' if same else f'rel diff {rel:.3e}'}; the "
          f"other package against itself: "
          f"{'same bits' if same_o else f'rel diff {rel_o:.3e}'}"
          f"{'' if ok else '  DIFFERS'}", flush=True)
    return {"case": tag, "same_bits": same, "rel_diff": rel,
            "other_same_bits_as_itself": same_o, "other_rel_diff": rel_o,
            "ok": ok}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path)
    ap.add_argument("--out", type=Path, default=None)
    ns = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("torch_dispatch_ab: no CUDA device")
    import tpu_multigrid_torch as this
    from chip_smoke import ensemble_cfg, flagship, replayed_cycle
    from torch_smoother_ab import load_package
    other = load_package(ns.other.resolve() / "tpu_multigrid_torch",
                         "tmg_other")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    rows = []

    cfg, gauges = flagship(torch, this, dev)
    _, U, D = gauges[0]
    rows.append(compare(
        "build_hierarchy L=256",
        lambda p: p.build_hierarchy(D, p.MGConfig(**vars(cfg)), U=U),
        this, other))
    hier = this.build_hierarchy(D, cfg, U=U)
    b = this.point_source(cfg, device=dev)

    def cycles(h, c, rhs, k):
        def run(p):
            phis, a = this.zero_fields(c, dev), None
            for _ in range(k):
                phis, a = p.cycle(h, phis, rhs, p.MGConfig(**vars(c)))
            return phis, a
        return run

    rows.append(compare("10 flagship cycles L=256",
                        cycles(hier, cfg, b, 10), this, other))
    replays = {}
    for p, name in ((other, "other"), (this, "this")):
        replays[f"flagship_{name}"] = replayed_cycle(
            torch, p, dev, p.MGConfig(**vars(cfg)), hier, b, 10, 5,
            f"flagship ({name})")

    lcfg, lgauges = flagship(torch, this, dev, L=2048, nlevels=6,
                             null_iters=500)
    _, lU, lD = lgauges[0]
    del lgauges
    lhier = this.build_hierarchy(lD, lcfg, U=lU)
    lb = this.point_source(lcfg, device=dev)
    rows.append(compare("4 large flagship cycles L=2048",
                        cycles(lhier, lcfg, lb, 4), this, other))
    for p, name in ((other, "other"), (this, "this")):
        replays[f"large_{name}"] = replayed_cycle(
            torch, p, dev, p.MGConfig(**vars(lcfg)), lhier, lb, 4, 3,
            f"large flagship ({name})")
    del lhier, lD, lU

    ecfg = ensemble_cfg(this, 128)
    rng = np.random.default_rng(ecfg.seed)
    ph = np.stack([0.2 * rng.normal(size=(2, 128, 128)) for _ in range(8)])
    Us = this.models.gauge.gauge_from_phases(ph, ecfg.cdtype, dev)
    bs = this.point_source(ecfg, device=dev).expand(8, -1, -1, -1).clone()

    def ensemble(p):
        c = p.MGConfig(**vars(ecfg))
        hb = p.build_hierarchies_batched(Us, c)
        return hb, p.solve_ensemble(hb, bs, c, 18)

    rows.append(compare("solve_ensemble x8 L=128 (setup and solve)",
                        ensemble, this, other))

    same_replays = {}
    for key in ("flagship", "large"):
        o, t = replays[f"{key}_other"], replays[f"{key}_this"]
        same_replays[key] = (o["launches"] == t["launches"]
                             and o["device_ops"] == t["device_ops"])
        print(f"replayed {key} cycle: launches other {o['launches']}, this "
              f"{t['launches']}; device ops other {o['device_ops']}, this "
              f"{t['device_ops']}"
              f"{'' if same_replays[key] else '  DIFFERS'}")
    out = {"card": card, "cases": rows, "replayed_cycles": replays,
           "same_replays": same_replays,
           "ok": all(r["ok"] for r in rows) and all(same_replays.values())}
    if ns.out is not None:
        ns.out.parent.mkdir(parents=True, exist_ok=True)
        ns.out.write_text(json.dumps(out, indent=1, default=str))
    print(json.dumps({k: out[k] for k in ("card", "cases", "same_replays",
                                          "ok")}, default=str))
    sys.exit(0 if out["ok"] else 1)


if __name__ == "__main__":
    main()
