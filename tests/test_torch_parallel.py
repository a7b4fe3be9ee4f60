"""The port's distributed layer (tpu_multigrid_torch/parallel) on the CPU
over gloo, against the port's single-device ops and solves and against
the JAX package's (tests/test_parallel.py and
__graft_entry__.dryrun_multichip, mirrored).

Two spawn groups run every distributed check once: 2 ranks on the meshes
(1, 2) and (2, 1) (axes of size 1; the NTL copies smoothed as one batch
on every rank; the ensemble sharded over 2 ranks) and 4 ranks on (2, 2)
(the NTL copies one a rank). Each rank pins torch to one thread, joins
its group through a FileStore under the test's temporary directory, with
a 60 s process-group timeout, and never imports jax. The parent starts
both groups as soon as their inputs are written, computes JAX's answers
(on its 8 CPU devices, its (2, 2) mesh) while they run, joins them with a
timeout and asserts each check as its own parametrised test.

Bars: ops and smoothers at the complex128 bar (1e-12 relative) against
both packages' single-device versions; the sharded solves (L=16, 2
levels, complex128) take JAX's single-device cycle count and JAX's
(2, 2)-mesh count, with fields within JAX's own atol 1e-10 of the
single-device solve (test_parallel.py:98) and within 1e-12 relative of
JAX's sharded one; the sharded setup from JAX's starts matches JAX's
sharded setup and the port's single-device one to 1e-12 relative;
dryrun_multichip's complex64 rows hold phi to the complex64 bar (2e-5
relative) against JAX's sharded answers, and the 20-cycle residual to
that function's own 5e-3.
"""
import dataclasses
import pickle
import time
import traceback
import warnings

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from torch_port_helpers import C64_BAR, C128_BAR, crandn, np_of, rel_err, t_of

L = 16
PG_TIMEOUT_S = 60
JOIN_TIMEOUT_S = 240
MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}
SOLVES = {   # name -> (setup, MGConfig keywords): test_parallel.py's, at L=16
    "laplace": ("laplace", dict(ntl=False)),
    "laplace_ntl": ("laplace", dict()),
    "wilson_ntl": ("wilson", dict()),
    "avg_coarse": ("laplace", dict(min_res=False, ntl_combine="avg_coarse")),
    "chebyshev": ("wilson", dict()),
}
# name -> (stencil, L, seed of its gauge or None for the shared stream).
# At L=12 level 1's tiles are odd on every mesh, so it is replicated and
# the NTL copies take the single-device build_ntl; at L=16 they are tiles.
SETUPS = {"laplace": ("laplace", L, None), "wilson": ("wilson", L, None),
          "wilson_L12": ("wilson", 12, 12)}
SMOOTHERS = (("jacobi", 0.8), ("rbgs", 1.0), ("chebyshev", 1.0))
CHEBY = (0.3, 2.2)


def _setup_cfg(stencil, config_cls):
    return config_cls(L=L, stencil=stencil, m=0.1, nlevels=2, ntl=True,
                      num_iters=6, null_iters=60, res_threshold=1e-9)


# --- the ranks -------------------------------------------------------------

def _rank_main(rank, world, store, inputs, out):
    """One rank of a spawn group: every check of its world size, each
    result (or the error it raised) in a dict that rank 0 writes to
    `out`."""
    torch.set_num_threads(1)
    from tpu_multigrid_torch import solver as tsolver
    from tpu_multigrid_torch.config import XP, XM, YP, YM
    from tpu_multigrid_torch.parallel import halo, multihost, setup, sharded
    from tpu_multigrid_torch.utils.convert import (config_from_dict,
                                                   hierarchy_from_numpy)
    import tpu_multigrid_torch as mgt

    multihost.initialize(f"file://{store}", world, rank, backend="gloo",
                         timeout_s=PG_TIMEOUT_S)
    with open(inputs, "rb") as f:
        inp = pickle.load(f)
    res = {}

    def record(key, fn):
        # every check runs and reports, whatever an earlier one raised: the
        # parent turns a recorded error into that check's failure
        try:
            res[key] = fn()
        except Exception:      # noqa: BLE001
            res[key] = RuntimeError(traceback.format_exc())

    t = torch.from_numpy
    for shape in MESHES[world]:
        mesh = sharded.make_mesh(shape)
        m = f"{shape[0]}x{shape[1]}"

        def gathered(x, mesh=mesh):
            return np_of(sharded._gather_lattice(x, mesh))

        def tile(a, mesh=mesh):
            return sharded._my_tile(t(a), mesh)

        o = inp["ops"]
        for d in (XP, XM, YP, YM):
            record((m, "shift", d), lambda d=d: gathered(
                halo.shift_halo(tile(o["v"]), d, mesh)))
        for ov in (True, False):
            record((m, "apply", ov), lambda ov=ov: gathered(
                halo.apply_D_sharded(tile(o["D"]), tile(o["v"]), mesh, ov)))
        for kind, omega in SMOOTHERS:
            record((m, "smooth", kind), lambda kind=kind, omega=omega:
                   gathered(halo.smooth_sharded(
                       tile(o["Dl"]), tile(o["Dl_inv"]),
                       torch.zeros_like(tile(o["r"])), tile(o["r"]), 5, kind,
                       mesh, omega, cheby_interval=CHEBY)))
        record((m, "global_norm"), lambda: float(
            halo.global_norm_sharded(tile(o["v"]), mesh)))

        for name, (cfg_d, levels, ntl, b) in inp["solves"].items():
            cfg = config_from_dict(cfg_d)
            hier = hierarchy_from_numpy(levels, ntl, None)
            overlaps = (True, False) if name == "wilson_ntl" else (True,)
            for ov in overlaps:
                c = cfg.replace(halo_overlap=ov)

                def solve(c=c, hier=hier, b=b):
                    solver = sharded.make_sharded_solver(c, mesh, 100)
                    hs = sharded.shard_hierarchy(hier, c, mesh)
                    phis, it, r = solver(hs, mgt.zero_fields(c), t(b))
                    return np_of(phis[0]), it, r
                record((m, "solve", name, ov), solve)

        for stencil, (cfg_d, D, starts) in inp["setup"].items():
            def build(cfg_d=cfg_d, D=D, starts=starts):
                cfg = config_from_dict(cfg_d)
                h = setup.build_hierarchy_sharded(t(D), cfg, mesh,
                                                  starts=starts)
                g = sharded.gather_hierarchy(h, cfg, mesh)
                return dict(
                    phi_null=[np_of(l.phi_null) for l in g.levels[:-1]],
                    D=[np_of(l.D) for l in g.levels],
                    ntl_phi_null=np_of(g.ntl.phi_null), ntl_D=np_of(g.ntl.D),
                    local=[tuple(l.D.shape) for l in h.levels]
                    + [tuple(h.ntl.phi_null.shape)])
            record((m, "setup", stencil), build)

        cfg_d, levels, ntl, b = inp["overlap_flag"]

        def overlap_flag():
            """test_sharded_solve_overlap_flag: 3 c64 cycles each way."""
            cfg = config_from_dict(cfg_d)
            hier = hierarchy_from_numpy(levels, ntl, None,
                                        dtype=torch.complex64)
            outs = []
            for ov in (True, False):
                c = cfg.replace(halo_overlap=ov)
                ph, _, r = sharded.make_sharded_solver(c, mesh, 3)(
                    sharded.shard_hierarchy(hier, c, mesh),
                    mgt.zero_fields(c), t(b))
                outs.append((np_of(ph[0]), r))
            return outs
        record((m, "overlap_flag"), overlap_flag)

    if world == 2:
        record(("ensemble",), lambda: _ensemble(mgt, tsolver, sharded,
                                                inp["ensemble"]))
    if world == 4:
        record(("dryrun",), lambda: _dryrun(mgt, sharded, setup,
                                            inp["dryrun"]))
    torch.distributed.destroy_process_group()
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)


def _ensemble(mgt, tsolver, sharded, inp):
    """dryrun_multichip's second row: an ensemble of 2 configurations
    (the JAX package's starts) sharded over a 1-axis mesh of 2 ranks, and
    the same solve unsharded; and a batch the mesh does not divide,
    refused."""
    from tpu_multigrid_torch.utils.convert import config_from_dict
    cfg_d, th, starts = inp
    cfg = config_from_dict(cfg_d)
    B = th.shape[0]
    Us = mgt.models.gauge.gauge_from_phases(torch.from_numpy(th), cfg.cdtype)
    hier_b = mgt.build_hierarchies_batched(Us, cfg, starts=starts)
    bs = mgt.point_source(cfg).expand(B, -1, -1, -1).contiguous()
    mesh = sharded.make_mesh((B,))
    phi_s, res_s = mgt.solve_ensemble(hier_b, bs, cfg, n_cycles=6, mesh=mesh)
    phi_r, res_r = mgt.solve_ensemble(hier_b, bs, cfg, n_cycles=6)
    refused = None
    try:
        mgt.solve_ensemble(tsolver.ensemble.stack_hierarchies(
            [tsolver.ensemble.unstack_hierarchy(hier_b, 0)] * 3),
            bs[:1].expand(3, -1, -1, -1), cfg, 1, mesh=mesh)
    except ValueError as e:
        refused = str(e)
    part = tsolver.ensemble.shard_ensemble((hier_b, bs), mesh, batch=B)
    return dict(phi_s=np_of(phi_s), res_s=res_s, phi_r=np_of(phi_r),
                res_r=res_r, refused=refused,
                part_shapes=(tuple(part[0].levels[0].D.shape),
                             tuple(part[1].shape)))


def _dryrun(mgt, sharded, setup, inp):
    """dryrun_multichip's first row on the (2, 2) mesh: the flagship's
    shape at L=32 with 3 levels in complex64, set up by
    build_hierarchy_sharded from the JAX package's D and starts, solved
    sharded to 1e-5, then single-device on the same hierarchy,
    gathered."""
    from tpu_multigrid_torch.utils.convert import config_from_dict
    cfg_d, D, starts = inp
    cfg = config_from_dict(cfg_d)
    mesh = sharded.make_mesh((2, 2))
    hier_s = setup.build_hierarchy_sharded(torch.from_numpy(D), cfg, mesh,
                                           starts=starts)
    b = mgt.point_source(cfg)
    phis, it, r = sharded.make_sharded_solver(cfg, mesh, 50)(
        hier_s, mgt.zero_fields(cfg), b)
    ref = mgt.solve(sharded.gather_hierarchy(hier_s, cfg, mesh), b, cfg,
                    max_iters=50)
    return dict(iters=it, res=r, phi=np_of(phis[0]), ref_iters=ref.iters,
                ref_res=ref.resmag, ref_phi=np_of(ref.phi),
                sharded=sharded.shardable_levels(cfg, mesh),
                local_D0=tuple(hier_s.levels[0].D.shape))


def _start(world, tmp, inputs):
    """Start _rank_main on `world` ranks; returns the process context."""
    store, out = tmp / f"store{world}", tmp / f"out{world}.pkl"
    return mp.start_processes(_rank_main, args=(world, str(store),
                                                str(inputs), str(out)),
                              nprocs=world, join=False, start_method="spawn")


def _kill(ctx):
    for p in ctx.processes:
        if p.is_alive():
            p.terminate()


def _join(world, ctx, tmp, deadline):
    """Wait for a group started by _start; rank 0's results."""
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks still running after "
                                   f"{JOIN_TIMEOUT_S} s")
    finally:
        _kill(ctx)
    with open(tmp / f"out{world}.pkl", "rb") as f:
        return pickle.load(f)


# --- the references (JAX only in the parent, inside these functions) --------

def _jax_starts(cfg, batch=None):
    """The near-null starts the JAX package's setups draw from
    PRNGKey(cfg.seed): per level a split of the key (build_hierarchy and
    build_hierarchy_sharded), then, for an ensemble of `batch`
    configurations, one subkey a configuration (build_hierarchies_
    batched)."""
    import jax
    from tpu_multigrid.ops.nearnull import random_starts
    key, out = jax.random.PRNGKey(cfg.seed), []
    for lvl in range(cfg.nlevels):
        key, sub = jax.random.split(key)
        nc = cfg.n_dof[lvl + 1]
        k = nc // 2 if cfg.stencil == "wilson" else nc

        def draw(kk, lvl=lvl, k=k):
            return random_starts(kk, k, cfg.n_dof[lvl], cfg.sizes[lvl],
                                 cfg.cdtype)
        out.append(np.array(draw(sub) if batch is None else
                            jax.vmap(draw)(jax.random.split(sub, batch))))
    return out


def _dryrun_cfg(config_cls):
    """dryrun_multichip's first row on 4 devices: the flagship at L=32."""
    return config_cls(L=32, stencil="wilson", m=-0.005, nlevels=3, ntl=True,
                      n_copies=4, num_iters=4, null_iters=12,
                      dtype="complex64", smoother="rbgs", res_threshold=1e-5)


def _ensemble_cfg(config_cls):
    """dryrun_multichip's second row."""
    return config_cls(L=16, stencil="wilson", m=-0.005, nlevels=2, ntl=True,
                      n_copies=4, num_iters=4, null_iters=12,
                      dtype="complex64", smoother="rbgs")


def _inputs():
    """The ranks' inputs, made from seeds with numpy and the JAX package
    (its hierarchies for the solves, its operators and starts for the
    setups), and what _answers needs to hold them to JAX."""
    import tpu_multigrid as mg
    from tpu_multigrid.models import gauge as jg, operators as jo
    from tpu_multigrid.ops import stencil as jst
    from tpu_multigrid.solver import eigs as jeigs
    from tpu_multigrid.solver.hierarchy import build_hierarchy as jbuild
    from torch_port_helpers import jax_hierarchy_leaves

    rng = np.random.default_rng(4302529)
    U = jg.gauge_from_phases(0.3 * rng.normal(size=(2, L, L)))
    D = np.asarray(jo.assemble_wilson(U, -0.05))
    Dl = jo.assemble_laplace(U, 0.2)
    Dl_inv = jst.site_inverse(Dl[0])
    ops = dict(v=crandn(rng, (2, L, L)), D=D, Dl=np.asarray(Dl),
               Dl_inv=np.asarray(Dl_inv), r=crandn(rng, (1, L, L)))

    hiers = {}
    for stencil in ("laplace", "wilson"):
        cfg = _setup_cfg(stencil, mg.MGConfig)
        Uc = jg.gauge_from_phases(0.3 * rng.normal(size=(2, L, L)),
                                  cfg.cdtype)
        hiers[stencil] = jbuild(jo.assemble(stencil, Uc, cfg.m), cfg,
                                check=False)
    solves, jsolves = {}, {}
    for name, (stencil, kw) in SOLVES.items():
        hier = hiers[stencil]
        cfg = _setup_cfg(stencil, mg.MGConfig).replace(**kw)
        if name == "chebyshev":
            cfg = jeigs.chebyshev_config(cfg, hier)
        b = mg.point_source(cfg)
        levels, ntl, _ = jax_hierarchy_leaves(hier)
        solves[name] = (dataclasses.asdict(cfg), levels, ntl, np.asarray(b))
        jsolves[name] = (cfg, hier, b)

    setups, cfgs = {}, {}
    for name, (stencil, Ls, r) in SETUPS.items():
        r = rng if r is None else np.random.default_rng(r)
        cfgs[name] = cfg = mg.MGConfig(
            L=Ls, stencil=stencil, m=0.1, nlevels=2, ntl=True, num_iters=6,
            null_iters=40)
        Uc = jg.gauge_from_phases(0.3 * r.normal(size=(2, Ls, Ls)),
                                  cfg.cdtype)
        setups[name] = (dataclasses.asdict(cfg),
                        np.asarray(jo.assemble(stencil, Uc, cfg.m)),
                        _jax_starts(cfg))

    # dryrun_multichip's rows: its gauge draws from default_rng(cfg.seed)
    cfgs["dryrun"] = cfg = _dryrun_cfg(mg.MGConfig)
    drng = np.random.default_rng(cfg.seed)
    Ud = jg.gauge_from_phases(0.2 * drng.normal(size=(2, cfg.L, cfg.L)),
                              cfg.cdtype)
    dryrun = (dataclasses.asdict(cfg),
              np.asarray(jo.assemble(cfg.stencil, Ud, cfg.m)),
              _jax_starts(cfg))
    cfgs["ensemble"] = ecfg = _ensemble_cfg(mg.MGConfig)
    th = 0.2 * drng.normal(size=(2, 2, ecfg.L, ecfg.L))
    ensemble = (dataclasses.asdict(ecfg), th, _jax_starts(ecfg, len(th)))

    # the overlap-flag solve runs on a hierarchy of the port's own setup
    import tpu_multigrid_torch as mgt
    cfg = mgt.MGConfig(L=L, stencil="wilson", m=-0.005, nlevels=2, ntl=True,
                       n_copies=4, num_iters=3, null_iters=16,
                       dtype="complex64", smoother="rbgs", res_threshold=1e-20)
    Uc = mgt.models.gauge.gauge_from_phases(
        0.2 * rng.normal(size=(2, L, L)), cfg.cdtype)
    hier = mgt.build_hierarchy(mgt.models.operators.assemble(
        cfg.stencil, Uc, cfg.m), cfg, check=False)
    levels = [tuple(None if x is None else np_of(x) for x in
                    (l.D, l.D0inv, l.phi_null)) for l in hier.levels]
    ntl = (np_of(hier.ntl.phi_null), np_of(hier.ntl.D), np_of(hier.ntl.D0inv))
    overlap_flag = (dataclasses.asdict(cfg), levels, ntl,
                    np_of(mgt.point_source(cfg)))
    inputs = dict(ops=ops, solves=solves, setup=setups, dryrun=dryrun,
                  ensemble=ensemble, overlap_flag=overlap_flag)
    return inputs, dict(jsolves=jsolves, cfgs=cfgs)


def _answers(inputs, state):
    """The JAX package's answers on the ranks' inputs: its single-device
    ops, smoothers and solves, and on its (2, 2) mesh of CPU devices its
    sharded solves, setups and dryrun_multichip's rows."""
    import jax
    import jax.numpy as jnp
    import tpu_multigrid as mg
    from jax.sharding import Mesh as JMesh
    from tpu_multigrid.ops import smoothers as jsm, stencil as jst
    from tpu_multigrid.parallel import sharded as jsh
    from tpu_multigrid.parallel.setup import build_hierarchy_sharded
    from tpu_multigrid.solver import ensemble as jens
    from tpu_multigrid.solver.driver import solve as jsolve

    o = inputs["ops"]
    ops = {"apply": np.asarray(jst.apply_D(jnp.asarray(o["D"]),
                                           jnp.asarray(o["v"])))}
    for kind, omega in SMOOTHERS:
        ops[kind] = np.asarray(jsm.smooth(
            jnp.asarray(o["Dl"]), jnp.asarray(o["Dl_inv"]),
            jnp.zeros_like(o["r"]), jnp.asarray(o["r"]), 5, kind, omega,
            cheby_interval=CHEBY))

    mesh22 = jsh.make_mesh((2, 2))
    solves = {}
    for name, (cfg, hier, b) in state["jsolves"].items():
        ref = jsolve(hier, b, cfg, max_iters=100)
        phis, it, r = jsh.make_sharded_solver(cfg, mesh22, max_iters=100)(
            hier)(jsh.shard_hierarchy(hier, cfg, mesh22), mg.zero_fields(cfg),
                  b)
        solves[name] = dict(iters=ref.iters, phi=np.asarray(ref.phi),
                            converged=ref.converged, sharded_iters=int(it),
                            sharded_phi=np.asarray(phis[0]),
                            sharded_res=float(r))

    setups = {}
    cfgs = state["cfgs"]
    for stencil, (_, D, _) in inputs["setup"].items():
        # the default key PRNGKey(cfg.seed) draws _jax_starts(cfg)
        h = build_hierarchy_sharded(jnp.asarray(D), cfgs[stencil], mesh22)
        setups[stencil] = dict(
            phi_null=[np.asarray(l.phi_null) for l in h.levels[:-1]],
            D=[np.asarray(l.D) for l in h.levels],
            ntl_phi_null=np.asarray(h.ntl.phi_null),
            ntl_D=np.asarray(h.ntl.D))

    D, cfg = inputs["dryrun"][1], cfgs["dryrun"]
    h = build_hierarchy_sharded(jnp.asarray(D), cfg, mesh22)
    b = mg.point_source(cfg)
    phis, it, r = jsh.make_sharded_solver(cfg, mesh22, max_iters=50)(h)(
        jsh.shard_hierarchy(h, cfg, mesh22), mg.zero_fields(cfg), b)
    dryrun = dict(iters=int(it), res=float(r), phi=np.asarray(phis[0]))

    th, cfg = inputs["ensemble"][1], cfgs["ensemble"]
    Us = jnp.stack([mg.models.gauge.gauge_from_phases(p, cfg.cdtype)
                    for p in th])
    hier_b = jens.build_hierarchies_batched(Us, cfg)
    bs = jnp.broadcast_to(mg.point_source(cfg),
                          (len(th),) + tuple(mg.point_source(cfg).shape))
    cmesh = JMesh(np.asarray(jax.devices()[:len(th)]), ("config",))
    phi, res = jens.solve_ensemble(hier_b, bs, cfg, n_cycles=6, mesh=cmesh)
    ensemble = dict(phi=np.asarray(phi), res=np.asarray(res))
    return dict(ops=ops, solves=solves, setup=setups, dryrun=dryrun,
                ensemble=ensemble)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """(tmp, inputs file, inputs, JAX's answers, {world size: (group,
    deadline)}): both spawn groups start as soon as their inputs are
    written, and run while the parent computes JAX's answers."""
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("parallel")
    inputs, state = _inputs()
    path = tmp / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(inputs, f)
    groups = {w: (_start(w, tmp, path), time.monotonic() + JOIN_TIMEOUT_S)
              for w in MESHES}
    try:
        jax_out = _answers(inputs, state)
    except BaseException:
        for ctx, _ in groups.values():
            _kill(ctx)
        raise
    return tmp, path, inputs, jax_out, groups


@pytest.fixture(scope="module")
def ranks(refs):
    """{world size: rank 0's results}."""
    tmp, groups = refs[0], refs[4]
    return {w: _join(w, ctx, tmp, deadline)
            for w, (ctx, deadline) in groups.items()}


def _got(ranks, world, key):
    v = ranks[world][key]
    if isinstance(v, Exception):
        raise v
    return v


CASES = [(w, s) for w, shapes in MESHES.items() for s in shapes]
IDS = [f"{w}ranks-{s[0]}x{s[1]}" for w, s in CASES]


def _m(shape):
    return f"{shape[0]}x{shape[1]}"


# --- the tests -------------------------------------------------------------

@pytest.mark.parametrize("world,shape", CASES, ids=IDS)
@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_shift_halo_matches_roll(ranks, refs, world, shape, d):
    from tpu_multigrid_torch.ops import stencil as tst
    v = refs[2]["ops"]["v"]
    want = np_of(tst.shift(t_of(v), d))
    np.testing.assert_array_equal(_got(ranks, world, (_m(shape), "shift", d)),
                                  want)


@pytest.mark.parametrize("world,shape", CASES, ids=IDS)
@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "concat"])
def test_apply_d_sharded_matches(ranks, refs, world, shape, overlap):
    """Both hop schedules against the port's apply_D and JAX's."""
    from tpu_multigrid_torch.ops import stencil as tst
    o = refs[2]["ops"]
    got = _got(ranks, world, (_m(shape), "apply", overlap))
    assert rel_err(got, tst.apply_D(t_of(o["D"]),
                                    t_of(o["v"]))) < C128_BAR
    assert rel_err(got, refs[3]["ops"]["apply"]) < C128_BAR
    other = _got(ranks, world, (_m(shape), "apply", not overlap))
    assert rel_err(got, other) < C128_BAR


@pytest.mark.parametrize("world,shape", CASES, ids=IDS)
@pytest.mark.parametrize("kind,omega", SMOOTHERS,
                         ids=[k for k, _ in SMOOTHERS])
def test_smoother_sharded_matches(ranks, refs, world, shape, kind, omega):
    from tpu_multigrid_torch.ops import smoothers as tsm
    o = refs[2]["ops"]
    r = t_of(o["r"])
    want = tsm.smooth(t_of(o["Dl"]), t_of(o["Dl_inv"]),
                      torch.zeros_like(r), r, 5, kind, omega,
                      cheby_interval=CHEBY)
    got = _got(ranks, world, (_m(shape), "smooth", kind))
    assert rel_err(got, want) < C128_BAR
    assert rel_err(got, refs[3]["ops"][kind]) < C128_BAR


@pytest.mark.parametrize("world,shape", CASES, ids=IDS)
def test_global_norm_sharded(ranks, refs, world, shape):
    got = _got(ranks, world, (_m(shape), "global_norm"))
    want = np.linalg.norm(refs[2]["ops"]["v"])
    assert abs(got - want) < C128_BAR * want


SOLVE_CASES = [(w, s, n, ov) for w, s in CASES for n in SOLVES
               for ov in ((True, False) if n == "wilson_ntl" else (True,))]


@pytest.mark.parametrize("world,shape,name,overlap", SOLVE_CASES,
                         ids=[f"{w}ranks-{s[0]}x{s[1]}-{n}"
                              + ("" if ov else "-concat")
                              for w, s, n, ov in SOLVE_CASES])
def test_sharded_solve_matches_jax(ranks, refs, world, shape, name, overlap):
    """test_sharded_solve_matches_single_device, ..._avg_coarse_... and
    ..._chebyshev_...: JAX's single-device cycle count and its (2, 2)
    sharded count; the field within 1e-10 of the single-device solve and
    1e-12 relative of the JAX sharded one."""
    j = refs[3]["solves"][name]
    phi, it, res = _got(ranks, world, (_m(shape), "solve", name, overlap))
    assert j["converged"] and res < 1e-9
    assert it == j["iters"] == j["sharded_iters"]
    np.testing.assert_allclose(phi, j["phi"], rtol=0, atol=1e-10)
    assert rel_err(phi, j["sharded_phi"]) < C128_BAR
    assert abs(res - j["sharded_res"]) < 1e-6 * j["sharded_res"]


@pytest.mark.parametrize("world,shape", CASES, ids=IDS)
@pytest.mark.parametrize("stencil", list(SETUPS))
def test_sharded_setup_matches_jax(ranks, refs, world, shape, stencil):
    """build_hierarchy_sharded from JAX's starts against JAX's
    build_hierarchy_sharded on its (2, 2) mesh and against the port's
    build_hierarchy from the same starts: phi_null, the coarse operators
    and the NTL copies, gathered; and each rank held only its tiles of
    the sharded levels."""
    import tpu_multigrid_torch as mgt
    from tpu_multigrid_torch.parallel.sharded import shardable_levels
    from tpu_multigrid_torch.utils.convert import config_from_dict
    cfg_d, D, starts = refs[2]["setup"][stencil]
    cfg = config_from_dict(cfg_d)
    j = refs[3]["setup"][stencil]
    h = mgt.build_hierarchy(t_of(D), cfg, starts=starts, check=False)
    got = _got(ranks, world, (_m(shape), "setup", stencil))
    for l in range(cfg.nlevels):
        assert rel_err(got["phi_null"][l], j["phi_null"][l]) < C128_BAR, l
        assert rel_err(got["phi_null"][l], h.levels[l].phi_null) < C128_BAR
    for l in range(cfg.nlevels + 1):
        assert rel_err(got["D"][l], j["D"][l]) < C128_BAR, l
        assert rel_err(got["D"][l], h.levels[l].D) < C128_BAR, l
    for name in ("phi_null", "D"):
        assert rel_err(got["ntl_" + name], j["ntl_" + name]) < C128_BAR
        assert rel_err(got["ntl_" + name],
                       getattr(h.ntl, name)) < C128_BAR
    sh = shardable_levels(cfg, _bare_mesh(shape))
    assert sh[cfg.nlevels - 1] == (cfg.L == L)   # the NTL path each case takes
    for l, dims in enumerate(got["local"][:-1]):
        S = cfg.sizes[l]
        assert dims[-2:] == ((S // shape[0], S // shape[1]) if sh[l]
                             else (S, S)), (l, dims)
    S = cfg.sizes[cfg.nlevels - 1]
    assert got["local"][-1][-2:] == ((S // shape[0], S // shape[1])
                                     if sh[cfg.nlevels - 1] else (S, S))


@pytest.mark.parametrize("world,shape", CASES, ids=IDS)
def test_sharded_solve_overlap_flag(ranks, world, shape):
    """The overlap schedule and the concat baseline, 3 complex64 NTL
    cycles each: the same trajectory (test_parallel.py:242-265)."""
    (p1, r1), (p2, r2) = _got(ranks, world, (_m(shape), "overlap_flag"))
    np.testing.assert_allclose(p1, p2, atol=1e-5)
    assert abs(r1 - r2) < 1e-6


def test_sharded_ensemble_matches_jax(ranks, refs):
    """dryrun_multichip's ensemble row, over 2 ranks from JAX's starts:
    JAX's ensemble solve sharded over its 2 devices and the port's
    unsharded one, phi and residuals to the complex64 bar; each rank held
    one configuration; a batch of 3 over 2 ranks refused."""
    e = _got(ranks, 2, ("ensemble",))
    j = refs[3]["ensemble"]
    assert e["phi_s"].shape == e["phi_r"].shape == j["phi"].shape \
        == (2, 2, 16, 16)
    assert rel_err(e["phi_s"], j["phi"]) < C64_BAR
    np.testing.assert_allclose(e["res_s"], j["res"], rtol=C64_BAR)
    assert rel_err(e["phi_s"], e["phi_r"]) < C64_BAR
    np.testing.assert_allclose(e["res_s"], e["res_r"], rtol=C64_BAR)
    assert np.isfinite(e["res_s"]).all() and (e["res_s"] < 0.1).all()
    assert e["part_shapes"][0][0] == 1 and e["part_shapes"][1][0] == 1
    assert e["refused"] and "divide" in e["refused"]


def test_sharded_flagship_shape_dryrun(ranks, refs):
    """dryrun_multichip's first row on (2, 2): Wilson NTL, L=32, 3
    levels, complex64, the distributed setup from JAX's D and starts,
    solved to 1e-5 in the cycle count of JAX's sharded solve and of the
    port's single-device solve on the same hierarchy; against both, phi to
    the complex64 bar and the residual to that row's bar between JAX's
    sharded and single-device solves (5e-3 relative: 20 complex64 cycles
    in another order of sums)."""
    r = _got(ranks, 4, ("dryrun",))
    j = refs[3]["dryrun"]
    assert r["sharded"] == (True, True, True, False)
    assert r["local_D0"][-2:] == (16, 16)
    assert r["res"] < 1e-5 and r["iters"] == j["iters"] == r["ref_iters"]
    for res, phi in ((j["res"], j["phi"]), (r["ref_res"], r["ref_phi"])):
        assert abs(r["res"] - res) < 5e-3 * res
        assert rel_err(r["phi"], phi) < C64_BAR


def _bare_mesh(shape):
    """A Mesh of rank 0 with no process group: for what needs none."""
    from tpu_multigrid_torch.parallel.sharded import Mesh
    return Mesh(shape=shape, device=torch.device("cpu"), rank=0,
                backend="gloo")


def test_shardable_levels():
    """test_parallel.py:127-134 on its (2, 4) mesh, and the (2, 2) one."""
    import tpu_multigrid_torch as mgt
    from tpu_multigrid_torch.parallel import sharded
    cfg = mgt.MGConfig(L=32, stencil="laplace", m=0.1, nlevels=3)
    assert sharded.shardable_levels(cfg, _bare_mesh((2, 4))) == (
        True, True, True, False)
    # 32 -> (16, 16), 16 -> (8, 8), 8 -> (4, 4) blocked by 2: sharded
    assert sharded.shardable_levels(cfg, _bare_mesh((2, 2))) == (
        True, True, True, False)
    # L=12 on (2, 2): level 0's tiles are 6 x 6, level 1's 3 x 3 (odd):
    # replicated from level 1 on
    cfg = mgt.MGConfig(L=12, stencil="laplace", m=0.1, nlevels=2, block_x=2,
                       block_y=2)
    assert sharded.shardable_levels(cfg, _bare_mesh((2, 2))) == (
        True, False, False)


def test_sharded_smoother_downgrade_warns():
    """gs_lex runs as rbgs in the sharded cycle, and says so
    (test_parallel.py:162-182)."""
    import tpu_multigrid_torch as mgt
    from tpu_multigrid_torch.parallel import sharded
    mesh = _bare_mesh((2, 4))
    cfg = mgt.MGConfig(L=16, stencil="laplace", m=0.1, nlevels=1,
                       smoother="gs_lex")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sharded.make_sharded_cycle(cfg, mesh)
    assert any("downgrades smoother 'gs_lex'" in str(x.message) for x in w)
    cfg_ok = cfg.replace(smoother="rbgs")
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        sharded.make_sharded_cycle(cfg_ok, mesh)
    assert not any("downgrades" in str(x.message) for x in w)


CLI = ["--L", "16", "--stencil", "wilson", "--m", "0.1", "--nlevels", "2",
       "--ntl", "--num-iters", "6", "--null-iters", "60", "--res-threshold",
       "1e-9", "--max-iters", "100", "--gauge", "random", "--platform", "cpu",
       "--skip-tests"]


@pytest.mark.parametrize("extra", [[], ["--no-halo-overlap"]],
                         ids=["overlap", "concat"])
def test_cli_mesh_1x1_matches_single_device(tmp_path, extra):
    """--mesh 1,1 without torchrun: a one-rank gloo group in this process,
    the distributed solve in the single-device run's cycle count; the
    group is left afterwards."""
    import json
    import torch.distributed as dist
    from tpu_multigrid_torch import cli
    assert cli.main(CLI + ["--out-dir", str(tmp_path / "one")]) == 0
    assert cli.main(CLI + extra + ["--mesh", "1,1",
                                   "--out-dir", str(tmp_path / "mesh")]) == 0
    assert not dist.is_initialized()
    one, mesh = (json.loads((tmp_path / d / "solve_summary.json").read_text())
                 for d in ("one", "mesh"))
    assert mesh["converged"] and mesh["iters"] == one["iters"]
    assert abs(mesh["resmag"] - one["resmag"]) < 1e-4 * one["resmag"]
    assert (tmp_path / "mesh" / "results_gen_scaling.txt").exists()


def test_cli_mesh_under_torchrun(tmp_path):
    """The CLI as a user starts it on two ranks: torchrun (a free local
    port), --mesh 2,1 over gloo with the mass as --mass; the single-device
    run's cycle count, and rank 0 alone writes the summary."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path
    from tpu_multigrid_torch import cli
    flags = [a if a != "--m" else "--mass" for a in CLI]
    assert cli.main(CLI + ["--out-dir", str(tmp_path / "one")]) == 0
    root = Path(__file__).resolve().parent.parent
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node=2", "-m", "tpu_multigrid_torch.cli", "--mesh",
         "2,1"] + flags + ["--out-dir", str(tmp_path / "mesh")],
        cwd=root, capture_output=True, text=True, timeout=240,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-2000:]
    one, mesh = (json.loads((tmp_path / d / "solve_summary.json").read_text())
                 for d in ("one", "mesh"))
    assert mesh["converged"] and mesh["iters"] == one["iters"]
    assert out.stdout.count("converged in") == 1


@pytest.mark.parametrize("mesh", ["1,2", "2,2", "2", "0,1"])
def test_cli_mesh_world_size_mismatch_exits_2(tmp_path, mesh, capsys,
                                              monkeypatch):
    """A mesh that is not this run's world size (1 here, or torchrun's
    WORLD_SIZE) or is malformed: exit 2, before any process group."""
    import torch.distributed as dist
    from tpu_multigrid_torch import cli
    if mesh == "2,2":
        monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit) as e:
        cli.main(CLI + ["--mesh", mesh, "--out-dir", str(tmp_path)])
    assert e.value.code == 2
    assert "--mesh" in capsys.readouterr().err
    assert not dist.is_initialized()
    assert not (tmp_path / "solve_summary.json").exists()


def test_multihost_off_a_cluster(monkeypatch):
    """initialize() outside torchrun and without an init method joins
    nothing and says so, as JAX's off a pod; mesh_shape_for is JAX's
    near-square split; a mesh needs a process group."""
    import torch.distributed as dist
    from tpu_multigrid.parallel import multihost as jmh
    from tpu_multigrid_torch.parallel import multihost, sharded
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize(backend="gloo") is False
    assert not dist.is_initialized() and multihost.is_coordinator()
    for n in (1, 2, 4, 6, 7, 8, 12):
        assert multihost.mesh_shape_for(n) == jmh.mesh_shape_for(n)
    with pytest.raises(RuntimeError, match="initialize"):
        sharded.make_mesh((1, 1))


@pytest.mark.parametrize("shape,rank,want", [
    ((2, 2), 0, {1: 2, 2: 2, 3: 1, 4: 1}),
    ((2, 2), 3, {1: 1, 2: 1, 3: 2, 4: 2}),
    ((1, 4), 1, {1: 1, 2: 1, 3: 2, 4: 0}),
    ((4, 1), 3, {1: 0, 2: 2, 3: 3, 4: 3}),
])
def test_mesh_neighbours(shape, rank, want):
    """Rank r sits at divmod(r, my), the row-major order of JAX's device
    mesh; its neighbour in direction d (1..4 = +x, -x, +y, -y) wraps
    around the torus."""
    from tpu_multigrid_torch.parallel.sharded import Mesh
    mesh = Mesh(shape=shape, device=torch.device("cpu"), rank=rank,
                backend="gloo")
    assert {d: mesh.neighbour(d, 1) for d in want} == want
    opposite = {1: 2, 2: 1, 3: 4, 4: 3}
    assert all(mesh.neighbour(d, -1) == want[opposite[d]] for d in want)
