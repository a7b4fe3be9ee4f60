"""The port's drivers as device programs (utils/compile.py).

On CPU tensors each driver runs its chunk's body eagerly. Every driver
whose loop was restructured into such bodies (solve's block of cycles
with a stop flag on the device, solve_chunked / solve_fmg, solve_ir,
solve_batched, solve_ensemble, mr_solve, eo_mr_solve, cgnr_solve,
fgmres_solve) is held to the JAX package's driver on the same inputs in
complex128: JAX's hierarchy carried across by utils.convert, the
iteration count exactly JAX's, the solution within 1e-12 of JAX's
(relative to its largest entry) and the residual it reports within
1e-9 of JAX's, relative, or 1e-14 absolute (a ratio to |b| of the
rounded difference b - D x: its rounding, eps |D| |x| / |b|, is a few
eps here, and is large beside a small residual). `solve` also where its
while_loop stops at a max_iters that is no multiple of the program's
cycles, on divergence, and on a NaN.

The launch counters' bookkeeping (the additions a capture makes, taken
out and added once per replay) runs on a stub graph here. The tests
marked `cuda` run on the card: every driver captured against the same
bodies run eagerly, a capture that syncs raising, and a replayed
flagship cycle counting chip_smoke.FLAGSHIP_CYCLE, and each driver's
spans (a warm-up, a capture and a release a chunk key, a replay a
program run, the warm-up's device time; solve_ir's program kept with
its hierarchy, reused bit for bit as a fresh one, also after other
drivers' captures in the shared pool). JAX is imported by
the fixtures that need it, so that the card's tests run without it:

    python -m pytest --noconftest -m cuda tests/test_torch_compile.py
"""
import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from torch_port_helpers import (crandn, jax_hierarchy_leaves, np_of,
                                phases, rel_err, t_of)

import tpu_multigrid_torch as mgt
from tpu_multigrid_torch import profiling
from tpu_multigrid_torch.ops import cuda_stencil as cs
from tpu_multigrid_torch.solver import driver as tdriver
from tpu_multigrid_torch.utils import compile as tcompile
from tpu_multigrid_torch.utils.convert import (config_from_dict,
                                               hierarchy_from_numpy)

PHI_BAR = 1e-12
RES_RTOL, RES_ATOL = 1e-9, 1e-14


@pytest.fixture(scope="module")
def jax_pkg():
    """The JAX package and jax.numpy (imported here, not by the module)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    import tpu_multigrid as mg
    return types.SimpleNamespace(mg=mg, jnp=jnp)


@pytest.fixture(scope="module")
def flagship(jax_pkg):
    """Wilson NTL (4 copies, min-res) at L=16, 2 levels, rbgs x4, the
    links on the hierarchy, complex128: JAX's hierarchy and the port's
    copy of it."""
    mg, L = jax_pkg.mg, 16
    jcfg = mg.MGConfig(L=L, stencil="wilson", m=-0.005, nlevels=2, ntl=True,
                       n_copies=4, num_iters=4, null_iters=16,
                       dtype="complex128", smoother="rbgs",
                       res_threshold=1e-7, links="on")
    rng = np.random.default_rng(jcfg.seed)
    jU = mg.models.gauge.gauge_from_phases(phases(rng, L), jcfg.cdtype)
    jD = mg.models.operators.assemble(jcfg.stencil, jU, jcfg.m)
    jhier = mg.build_hierarchy(jD, jcfg, U=jU, check=False)
    thier = hierarchy_from_numpy(*jax_hierarchy_leaves(jhier),
                                 dtype=torch.complex128)
    return types.SimpleNamespace(
        jcfg=jcfg, tcfg=config_from_dict(dataclasses.asdict(jcfg)),
        jhier=jhier, thier=thier, b=np.asarray(mg.point_source(jcfg)),
        D=np.asarray(jD))


def _same_phi(port, ref):
    """The solutions agree within PHI_BAR, or are NaN at the same places
    and agree elsewhere."""
    p, r = np_of(port), np.asarray(ref)
    nan = np.isnan(r)
    np.testing.assert_array_equal(np.isnan(p), nan)
    if nan.all():
        return
    assert rel_err(np.where(nan, 0, p), np.where(nan, 0, r)) < PHI_BAR


def _same_res(port, ref):
    if math.isnan(ref):
        assert math.isnan(port)
    else:
        assert port == pytest.approx(ref, rel=RES_RTOL, abs=RES_ATOL)


@pytest.mark.parametrize("case", ["converges", "max_iters", "diverges",
                                  "nan"])
def test_solve_matches_jax_while_loop(flagship, jax_pkg, case):
    """solve (SOLVE_BLOCK cycles a program, the stop flag read once a
    program) stops where JAX's while_loop stops, with its phi, iters and
    resmag: on convergence (39 cycles), at max_iters=13 with no
    threshold, on divergence past div_threshold=1e3 at m=-0.3 (3 cycles),
    and at a NaN in the right-hand side (1 cycle, all NaN)."""
    f, mg = flagship, jax_pkg.mg
    jcfg, max_iters, b = f.jcfg, 40, f.b.copy()
    if case == "max_iters":
        jcfg, max_iters = jcfg.replace(res_threshold=0.0), 13
    elif case == "diverges":
        jcfg = jcfg.replace(m=-0.3, div_threshold=1e3)
    elif case == "nan":
        b[1, 3, 5] = np.nan
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    ref = mg.solve(f.jhier, jax_pkg.jnp.asarray(b), jcfg,
                   max_iters=max_iters)
    out = tdriver.solve(f.thier, t_of(b), tcfg, max_iters=max_iters)
    assert out.iters == ref.iters
    assert out.converged == ref.converged
    _same_res(out.resmag, ref.resmag)
    _same_phi(out.phi, ref.phi)
    want = {"converges": ref.converged, "max_iters": ref.iters == 13,
            "diverges": 1e3 < ref.resmag < 1e6,
            "nan": ref.iters == 1 and math.isnan(ref.resmag)}[case]
    assert want and ref.iters % tdriver.SOLVE_BLOCK


@pytest.mark.parametrize("driver", ["solve_chunked", "solve_fmg"])
def test_solve_chunked_and_fmg_match_jax(flagship, jax_pkg, driver):
    """A program of `chunk` cycles and its check: JAX's chunk-granular
    count, phi and residual (solve_fmg: after the FMG guess)."""
    f = flagship
    jfn, tfn = getattr(jax_pkg.mg, driver), getattr(mgt, driver)
    ref = jfn(f.jhier, jax_pkg.jnp.asarray(f.b), f.jcfg, max_iters=40,
              chunk=3)
    out = tfn(f.thier, t_of(f.b), f.tcfg, max_iters=40, chunk=3)
    assert ref.converged and out.converged
    assert out.iters == ref.iters
    _same_res(out.resmag, ref.resmag)
    _same_phi(out.phi, ref.phi)


def test_solve_ir_matches_jax(flagship, jax_pkg):
    """One program an outer step (complex128 inner cycles): JAX's outer
    steps, history and phi; with outer_chunk=3 the read-backs are every
    third of them."""
    f = flagship
    jcfg, tcfg = (c.replace(res_threshold=1e-10) for c in (f.jcfg, f.tcfg))
    ref = jax_pkg.mg.solve_ir(f.jhier, jax_pkg.jnp.asarray(f.b), jcfg,
                              inner_cycles=2, max_iters=60,
                              inner_dtype="complex128", planes=False)
    out = mgt.solve_ir(f.thier, t_of(f.b), tcfg, inner_cycles=2,
                       max_iters=60, inner_dtype="complex128")
    assert ref.converged and out.converged
    assert out.iters == ref.iters
    np.testing.assert_allclose(out.history, ref.history, rtol=RES_RTOL,
                               atol=RES_ATOL)
    _same_phi(out.phi, ref.phi)
    root = profiling.roots()[-1]
    assert root.name == "solve_ir" and root.spans["solve_ir"][0] == 1
    assert root.spans["driver.read_back"][0] == out.iters // 2
    out3 = mgt.solve_ir(f.thier, t_of(f.b), tcfg, inner_cycles=2,
                        max_iters=60, inner_dtype="complex128",
                        outer_chunk=3)
    assert profiling.roots()[-1].spans["driver.read_back"][0] == \
        out3.iters // 6
    steps = len(ref.history)
    assert out3.iters == 2 * 3 * math.ceil(steps / 3)
    np.testing.assert_allclose(out3.history[:steps // 3],
                               ref.history[2::3][:steps // 3],
                               rtol=RES_RTOL, atol=RES_ATOL)


def test_solve_batched_matches_jax(flagship, jax_pkg):
    """12 cycles for 3 right-hand sides (a program of a cycle and the
    check, replayed): JAX's vmapped solve, phi and per-RHS residuals."""
    f = flagship
    bs = crandn(np.random.default_rng(3), (3, 2, 16, 16))
    from tpu_multigrid.solver.driver import solve_batched
    jphi, jres = solve_batched(f.jhier, jax_pkg.jnp.asarray(bs), f.jcfg,
                               n_cycles=12)
    phi, res = mgt.solve_batched(f.thier, t_of(bs), f.tcfg, n_cycles=12)
    assert phi.shape == (3, 2, 16, 16) and res.shape == (3,)
    _same_phi(phi, jphi)
    np.testing.assert_allclose(res, jres, rtol=RES_RTOL,
                               atol=RES_ATOL)


def test_solve_ensemble_matches_jax(jax_pkg):
    """solve_ensemble (mesh=None) on JAX's batched hierarchy of 2 gauge
    configurations, 7 cycles: JAX's phi and residuals."""
    mg, jnp = jax_pkg.mg, jax_pkg.jnp
    from tpu_multigrid.solver import ensemble as jens
    jcfg = mg.MGConfig(L=8, stencil="wilson", m=0.2, nlevels=2, ntl=True,
                       num_iters=4, null_iters=16, dtype="complex128",
                       res_threshold=1e-8)
    rng = np.random.default_rng(5)
    jUs = jnp.stack([mg.models.gauge.gauge_from_phases(phases(rng, 8),
                                                       jcfg.cdtype)
                     for _ in range(2)])
    jhier = jens.build_hierarchies_batched(jUs, jcfg)
    thier = hierarchy_from_numpy(*jax_hierarchy_leaves(jhier))
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    b = np.asarray(mg.point_source(jcfg))
    bs = np.stack([b, (1 + 1j) * b])
    jphi, jres = jens.solve_ensemble(jhier, jnp.asarray(bs), jcfg,
                                     n_cycles=7)
    phi, res = mgt.solve_ensemble(thier, t_of(bs), tcfg, n_cycles=7)
    _same_phi(phi, jphi)
    np.testing.assert_allclose(res, jres, rtol=RES_RTOL,
                               atol=RES_ATOL)


@pytest.mark.parametrize("solver", ["mr_solve", "eo_mr_solve",
                                    "cgnr_solve"])
def test_krylov_chunks_match_jax(flagship, jax_pkg, solver):
    """A chunk of 120 steps as programs of KRYLOV_BLOCK steps and one of
    the rest: JAX's count at chunk granularity, x and residual."""
    f = flagship
    D = f.D
    jfn, tfn = getattr(jax_pkg.mg, solver), getattr(mgt, solver)
    jx, jit, jrel = jfn(jax_pkg.jnp.asarray(D), jax_pkg.jnp.asarray(f.b),
                        tol=1e-8, max_iters=20000, chunk=120)
    x, it, rel = tfn(t_of(D), t_of(f.b), tol=1e-8, max_iters=20000,
                     chunk=120)
    assert jrel < 1e-8 and it == jit
    assert rel == pytest.approx(jrel, rel=RES_RTOL, abs=RES_ATOL)
    _same_phi(x, jx)


def test_fgmres_matches_jax(flagship, jax_pkg):
    """FGMRES(5) preconditioned by one cycle (its preconditioner and its
    apply one program each): JAX's Arnoldi steps, x and residual."""
    f = flagship
    jx, jit, jrel = jax_pkg.mg.fgmres_solve(
        f.jhier, jax_pkg.jnp.asarray(f.b), f.jcfg, tol=1e-10, restart=5)
    x, it, rel = mgt.fgmres_solve(f.thier, t_of(f.b), f.tcfg, tol=1e-10,
                                  restart=5)
    assert jrel < 1e-10 and it == jit
    assert rel == pytest.approx(jrel, rel=RES_RTOL, abs=RES_ATOL)
    _same_phi(x, jx)


# ---- the helper itself ----

@pytest.fixture
def counters():
    """The launch counters, set back to their values after the test."""
    saved = tcompile._counts()
    yield
    tcompile._add({k: saved[k] - v for k, v in tcompile._counts().items()},
                  1)


class _StubGraph:
    def __init__(self):
        self.replays, self.resets = 0, 0

    def replay(self):
        self.replays += 1

    def reset(self):
        self.resets += 1


class _StubChunk(tcompile.CapturedChunk):
    """CapturedChunk on the CUDA branch with a stub graph: the capture runs
    the body once (where the wrappers add to the counters, as they do
    under capture) and a replay runs nothing."""

    def __init__(self, *state, fail=False):
        super().__init__(*state)
        self.cuda, self.fail = True, fail
        self.warm_ups, self.graphs = 0, []

    def _warm_up(self, body):
        self.warm_ups += 1

    def _capture(self, body):
        new, out = body(*self.state)
        if self.fail:
            raise RuntimeError("capture failed")
        self.graphs.append(_StubGraph())
        return self.graphs[-1], out


def _wrapper_calls(x):
    """What a body's wrappers add to the counters for one step."""
    cs.launches["links_update"] += 2
    cs.launches["dense_apply"] += 1
    cs.band_launches["dense_update"]["streamed"] += 3
    cs.group_launches["dense_update"] += 1
    cs.rb_sweeps["multi"] += 4
    return (x + 1,), x.sum()


def test_counters_count_each_replay_once(counters):
    """n replays add n x the capture's additions, and the capture itself
    adds nothing; a second key captures its own graph."""
    before = tcompile._counts()
    chunk = _StubChunk(torch.zeros(3))
    for _ in range(5):
        chunk("step", _wrapper_calls)
    chunk("other", lambda x: ((x,), None))
    got = {k: v - before[k] for k, v in tcompile._counts().items()
           if v != before[k]}
    assert got == {("launches", "links_update"): 10,
                   ("launches", "dense_apply"): 5,
                   ("band", "dense_update", "streamed"): 15,
                   ("group", "dense_update"): 5, ("rb", "multi"): 20}
    assert [g.replays for g in chunk.graphs] == [5, 1]
    assert chunk.warm_ups == 2


def test_a_failed_capture_raises_and_counts_nothing(counters):
    """A capture that fails raises its error, leaves the counters as they
    were and runs nothing in its place."""
    before = tcompile._counts()
    chunk = _StubChunk(torch.zeros(3), fail=True)
    with pytest.raises(RuntimeError, match="capture failed"):
        chunk("step", _wrapper_calls)
    assert tcompile._counts() == before
    assert chunk.graphs == [] and chunk._graphs == {}
    assert torch.equal(chunk.state[0], torch.zeros(3))


def test_chunk_spans_and_close(counters):
    """Under one root: a warm-up and a capture a key, a replay a call;
    close resets each graph in a release span of its own, keeps the
    state and leaves the chunk to capture again."""
    chunk = _StubChunk(torch.zeros(3))
    with profiling.span("t.driver"):
        for _ in range(4):
            chunk("step", _wrapper_calls)
        chunk("other", lambda x: ((x,), None))
        graphs = list(chunk.graphs)
        chunk.close()
    root = profiling.roots()[-1]
    assert root.name == "t.driver"
    assert {k: v[0] for k, v in root.spans.items()
            if k.startswith("chunk.")} == {
        "chunk.warm_up": 2, "chunk.capture": 2, "chunk.replay": 5,
        "chunk.release": 2}
    assert [g.resets for g in graphs] == [1, 1] and not chunk._graphs
    assert torch.equal(chunk.state[0], torch.zeros(3))
    chunk("step", _wrapper_calls)
    assert len(chunk.graphs) == 3


def test_cpu_chunk_opens_no_chunk_span():
    """On CPU tensors a body runs eagerly: no chunk.* span, and close
    does nothing."""
    chunk = tcompile.CapturedChunk(torch.zeros(()))
    with profiling.span("t.cpu_driver"):
        chunk("step", lambda x: ((x + 1,), x))
        chunk.close()
    assert set(profiling.roots()[-1].spans) == {"t.cpu_driver"}
    assert float(chunk.state[0]) == 1.0


def test_cpu_state_chains_eagerly():
    """On CPU tensors every call runs the body on the current state and
    keeps its new state; load sets the first entries; run_steps makes
    n // block calls of block steps and one of the rest."""
    calls = []

    def steps(n):
        def body(x, y):
            calls.append(n)
            return (x + n, y), x + n
        return body

    chunk = tcompile.CapturedChunk(torch.zeros(()), torch.ones(()))
    out = tcompile.run_steps(chunk, 23, 10, steps)
    assert calls == [10, 10, 3] and float(out) == 23.0
    assert float(chunk.state[0]) == 23.0 and not chunk._graphs
    chunk.load(torch.full((), 7.0))
    assert [float(t) for t in chunk.state] == [7.0, 1.0]
    assert float(tcompile.run_steps(chunk, 0, 10, steps)) == 7.0


# ---- solve_ir's program, kept with its hierarchy ----

class _ReplayGraph(_StubGraph):
    """A stub graph whose replay runs its body eagerly on the chunk's
    buffers and writes the new state and the out in place, as a replay
    of the captured body does."""

    def __init__(self, state, body, out):
        super().__init__()
        self.state, self.body, self.out = state, body, out

    def replay(self):
        super().replay()
        new, out = self.body(*self.state)
        for s, t in zip(self.state, new):
            if t is not s:
                s.copy_(t)
        self.out.copy_(out)


class _ReplayChunk(_StubChunk):
    """_StubChunk with its state in buffers of its own (as on the card),
    whose graphs replay their body eagerly."""

    def __init__(self, *state):
        super().__init__(*state)
        self._state = tuple(t.clone() for t in state)

    def _capture(self, body):
        _, out = body(*self.state)
        self.graphs.append(_ReplayGraph(self.state, body, out.clone()))
        return self.graphs[-1], self.graphs[-1].out


@pytest.fixture
def replayed(monkeypatch):
    """solve_ir's chunks on _ReplayChunk: the CUDA branch, on the CPU."""
    monkeypatch.setattr(tdriver, "CapturedChunk", _ReplayChunk)


def _fresh(f):
    """A new port hierarchy of the flagship (a program of its own)."""
    return hierarchy_from_numpy(*jax_hierarchy_leaves(f.jhier),
                                dtype=torch.complex128)


def _ir(hier, b, cfg, **kw):
    return mgt.solve_ir(hier, b, cfg, **{"inner_cycles": 2, "max_iters": 60,
                                         "inner_dtype": "complex128", **kw})


def _chunk_spans():
    return {k: v[0] for k, v in profiling.roots()[-1].spans.items()
            if k.startswith("chunk.")}


def _kept_chunk(hier):
    return hier.__dict__[tdriver._KEPT].chunk


def test_solve_ir_keeps_its_program(flagship, replayed):
    """Two calls on one hierarchy make one warm-up and one capture; the
    second opens chunk.reuse once and replays, and answers its b as a
    fresh program does, bit for bit."""
    f = flagship
    cfg = f.tcfg.replace(res_threshold=1e-10)
    hier = _fresh(f)
    b2 = t_of(crandn(np.random.default_rng(5), f.b.shape))
    first = _ir(hier, t_of(f.b), cfg)
    spans = _chunk_spans()
    second = _ir(hier, b2, cfg)
    assert spans == {"chunk.warm_up": 1, "chunk.capture": 1,
                     "chunk.replay": first.iters // 2}
    assert _chunk_spans() == {"chunk.reuse": 1,
                              "chunk.replay": second.iters // 2}
    chunk = _kept_chunk(hier)
    assert chunk.warm_ups == 1 and len(chunk.graphs) == 1
    assert chunk.graphs[0].resets == 0
    fresh = _ir(_fresh(f), b2, cfg)
    assert first.converged and second.converged
    assert (second.iters, second.resmag) == (fresh.iters, fresh.resmag)
    np.testing.assert_array_equal(second.history, fresh.history)
    assert torch.equal(second.phi, fresh.phi)


@pytest.mark.parametrize("change", ["D_outer", "inner_cycles", "b_dtype"])
def test_solve_ir_new_key_recaptures(flagship, replayed, change):
    """A call with another D_outer object, inner_cycles or b dtype
    releases the kept graph (reset once, in a chunk.release span) and
    captures anew; a repeat of that call reuses the new program."""
    f = flagship
    cfg = f.tcfg.replace(res_threshold=1e-10)
    hier = _fresh(f)
    b = t_of(f.b)
    _ir(hier, b, cfg)
    old = _kept_chunk(hier)
    kw = {"D_outer": {"D_outer": t_of(f.D)},
          "inner_cycles": {"inner_cycles": 3}, "b_dtype": {}}[change]
    if change == "b_dtype":
        b = b.to(torch.complex64)
    out = _ir(hier, b, cfg, **kw)
    spans = _chunk_spans()
    assert _kept_chunk(hier) is not old
    assert [g.resets for g in old.graphs] == [1]
    assert spans["chunk.release"] == spans["chunk.warm_up"] == \
        spans["chunk.capture"] == 1 and "chunk.reuse" not in spans
    again = _ir(hier, b, cfg, **kw)
    assert _chunk_spans()["chunk.reuse"] == 1
    assert out.converged and torch.equal(again.phi, out.phi)


def test_solve_ir_program_dies_with_its_hierarchy(flagship, replayed):
    """The kept program holds no reference to its hierarchy: dropping the
    hierarchy frees the program and its graph by reference counting
    alone, with the collector off."""
    import gc
    import weakref
    f = flagship
    hier = _fresh(f)
    _ir(hier, t_of(f.b), f.tcfg.replace(res_threshold=1e-10))
    prog = hier.__dict__[tdriver._KEPT]
    refs = [weakref.ref(x) for x in (prog, prog.chunk, prog.chunk.graphs[0])]
    del prog
    gc.disable()
    try:
        del hier
        assert [r() for r in refs] == [None, None, None]
    finally:
        gc.enable()


def test_solve_ir_phi_is_a_copy(flagship, replayed):
    """The phi a call returns is not the kept program's buffer: a second
    call with another b leaves it as it was."""
    f = flagship
    cfg = f.tcfg.replace(res_threshold=1e-10)
    hier = _fresh(f)
    first = _ir(hier, t_of(f.b), cfg)
    kept = first.phi.clone()
    second = _ir(hier, (2 - 1j) * t_of(f.b), cfg)
    assert torch.equal(first.phi, kept)
    assert not torch.equal(second.phi, first.phi)
    assert first.phi.data_ptr() != _kept_chunk(hier).state[0].data_ptr()


# ---- on the card ----

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def eager(monkeypatch):
    """A context in which CapturedChunk runs its bodies eagerly on CUDA
    tensors too (the reference of a captured run), and solve_ir makes a
    program of its own, neither using nor keeping one on the
    hierarchy."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        init = tcompile.CapturedChunk.__init__

        def eager_init(self, *state):
            init(self, *state)
            self.cuda = False

        with monkeypatch.context() as m:
            m.setattr(tcompile.CapturedChunk, "__init__", eager_init)
            m.setattr(tdriver, "_kept_program",
                      lambda hier, held, key, make: (make(), False))
            yield
    return ctx


def _card_flagship(dev, L=64, dtype="complex64"):
    cfg = mgt.MGConfig(L=L, stencil="wilson", m=-0.005, nlevels=2, ntl=True,
                       num_iters=4, null_iters=40, dtype=dtype,
                       smoother="rbgs", res_threshold=1e-6)
    rng = np.random.default_rng(cfg.seed)
    U = mgt.models.gauge.gauge_from_phases(phases(rng, L), cfg.cdtype, dev)
    D = mgt.models.operators.assemble(cfg.stencil, U, cfg.m)
    return cfg, mgt.build_hierarchy(D, cfg, U=U, check=False), D


def _drivers(dev):
    """name -> fn() returning (count, field) of each driver on the card."""
    cfg, hier, D = _card_flagship(dev)
    b = mgt.point_source(cfg, device=dev)
    bs = torch.stack([b, 2 * b, (1 + 1j) * b])
    c128 = cfg.replace(dtype="complex128", res_threshold=1e-8)
    D128 = D.to(torch.complex128)
    b128 = b.to(torch.complex128)
    ens = mgt.solver.ensemble.stack_hierarchies([hier, hier])

    def krylov(fn, **kw):
        def run():
            x, it, _ = fn(D128, b128, tol=1e-8, max_iters=20000, **kw)
            return it, x
        return run

    def result(fn):
        def run():
            out = fn()
            return out.iters, out.phi
        return run

    return {
        "solve": result(lambda: mgt.solve(hier, b, cfg, max_iters=40)),
        "solve_chunked": result(lambda: mgt.solve_chunked(
            hier, b, cfg, max_iters=40, chunk=1)),
        "solve_fmg": result(lambda: mgt.solve_fmg(hier, b, cfg,
                                                  max_iters=40, chunk=2)),
        "solve_ir": result(lambda: mgt.solve_ir(
            hier, b128, c128, inner_cycles=2, max_iters=60)),
        "solve_with_history": result(lambda: mgt.solve_with_history(
            hier, b, cfg, max_iters=40)),
        "solve_batched": lambda: (12, mgt.solve_batched(hier, bs, cfg,
                                                        12)[0]),
        "solve_ensemble": lambda: (7, mgt.solve_ensemble(ens, bs[:2], cfg,
                                                         7)[0]),
        "mr_solve": krylov(mgt.mr_solve, chunk=120),
        "eo_mr_solve": krylov(mgt.eo_mr_solve, chunk=120),
        "cgnr_solve": krylov(mgt.cgnr_solve, chunk=120),
        "cgnr_solve_ir": lambda: (lambda o: (
            o["inner_iters"], torch.complex(*o["phi_planes"])))(
            mgt.cgnr_solve_ir(D, D128, b128, tol=1e-8, chunk=120)),
        "fgmres_solve": lambda: (lambda o: (o[1], o[0]))(
            mgt.fgmres_solve(hier, b, cfg, tol=1e-6)),
    }


DRIVERS = ["solve", "solve_chunked", "solve_fmg", "solve_ir",
           "solve_with_history", "solve_batched", "solve_ensemble",
           "mr_solve", "eo_mr_solve", "cgnr_solve", "cgnr_solve_ir",
           "fgmres_solve"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", DRIVERS)
def test_captured_driver_equals_eager(dev, eager, name):
    """Each driver's captured programs against the same bodies run
    eagerly on the card: the same count, the field within c64 1e-5 (or
    c128 1e-12)."""
    run = _drivers(dev)[name]
    n, got = run()
    with eager():
        n_eager, want = run()
    torch.cuda.synchronize()
    assert n == n_eager
    bar = 1e-12 if got.dtype == torch.complex128 else 1e-5
    assert rel_err(got, want) < bar


@pytest.mark.cuda
@pytest.mark.parametrize("name", DRIVERS)
def test_captured_driver_spans(dev, name):
    """Each driver call is one root (cgnr_solve_ir's inner cgnr_solve
    calls are children; solve_fmg's root is the solve_chunked it calls)
    with as many warm-ups, captures and releases as its chunks have keys,
    a replay a program run, and the warm-ups' time between their events,
    above 0, read with no sync. solve_ir's repeat call on its hierarchy
    replays the kept program: one chunk.reuse, no warm-up, capture or
    release."""
    run = _drivers(dev)[name]
    run()
    before = len(profiling.roots())
    run()
    root = profiling.roots()[-1]
    assert len(profiling.roots()) == min(before + 1, profiling.RING)
    assert root.name == {"solve_fmg": "solve_chunked"}.get(name, name)
    n = {k: v[0] for k, v in root.spans.items()}
    if name == "solve_ir":
        assert n["chunk.reuse"] == 1 and n["chunk.replay"] >= 1
        assert not {"chunk.warm_up", "chunk.capture", "chunk.release"} & \
            set(n) and "chunk.warm_up" not in root.device_ms
        return
    assert n["chunk.warm_up"] == n["chunk.capture"] == n["chunk.release"]
    assert n["chunk.replay"] >= n["chunk.capture"] >= 1
    assert root.device_ms["chunk.warm_up"] > 0


@pytest.mark.cuda
def test_solve_ir_spans_on_the_card(dev):
    """solve_ir's first call on a hierarchy: one warm-up and one capture,
    and no release (the program is kept); its repeat call: one
    chunk.reuse and no warm-up, capture or release. A replay and a
    read-back an outer step in each."""
    cfg, hier, D = _card_flagship(dev)
    c128 = cfg.replace(dtype="complex128", res_threshold=1e-8)
    b = mgt.point_source(cfg, device=dev).to(torch.complex128)
    for call in ("first", "repeat"):
        out = mgt.solve_ir(hier, b, c128, inner_cycles=2, max_iters=60)
        root = profiling.roots()[-1]
        n = {k: v[0] for k, v in root.spans.items()}
        assert out.converged and root.name == "solve_ir"
        assert n["chunk.replay"] == n["driver.read_back"] == out.iters // 2
        if call == "first":
            assert n["chunk.warm_up"] == n["chunk.capture"] == 1
            assert "chunk.release" not in n and "chunk.reuse" not in n
            assert 0 < root.device_ms["chunk.warm_up"]
        else:
            assert n["chunk.reuse"] == 1 and not {
                "chunk.warm_up", "chunk.capture", "chunk.release"} & set(n)


def _same_result(got, want):
    assert (got.iters, got.resmag) == (want.iters, want.resmag)
    np.testing.assert_array_equal(got.history, want.history)
    assert torch.equal(got.phi, want.phi)


@pytest.mark.cuda
def test_solve_ir_reuse_equals_a_fresh_capture(dev):
    """On one hierarchy, a second solve_ir call with another b answers as
    that b solved by a fresh program (the kept one released first): the
    same count, residual and history, and the same bits; the first
    call's phi stays as it was."""
    cfg, hier, D = _card_flagship(dev)
    c128 = cfg.replace(dtype="complex128", res_threshold=1e-8)
    b = mgt.point_source(cfg, device=dev).to(torch.complex128)
    b2 = torch.roll(b, (5, 9), (-2, -1)) * (1 - 2j)
    D128 = D.to(torch.complex128)

    def run(rhs):
        return mgt.solve_ir(hier, rhs, c128, inner_cycles=2, max_iters=60,
                            D_outer=D128)
    first = run(b)
    kept = first.phi.clone()
    again = run(b2)
    assert profiling.roots()[-1].spans["chunk.reuse"][0] == 1
    tdriver.release_kept(hier)
    fresh = run(b2)
    assert "chunk.reuse" not in profiling.roots()[-1].spans
    torch.cuda.synchronize()
    _same_result(again, fresh)
    assert torch.equal(first.phi, kept) and again.converged


@pytest.mark.cuda
def test_solve_ir_reuse_across_other_captures(dev):
    """Hierarchy A's kept program, replayed after solve and solve_batched
    captured (and released) graphs on hierarchy B in the same memory
    pool, answers bit for bit as a fresh program on A."""
    cfg, hier_a, _ = _card_flagship(dev)
    cfg_b, hier_b, _ = _card_flagship(dev, L=128)
    c128 = cfg.replace(dtype="complex128", res_threshold=1e-8)
    b = mgt.point_source(cfg, device=dev).to(torch.complex128)
    b_b = mgt.point_source(cfg_b, device=dev)

    def run_a(rhs):
        return mgt.solve_ir(hier_a, rhs, c128, inner_cycles=2, max_iters=60)
    run_a(b)
    mgt.solve(hier_b, b_b, cfg_b, max_iters=40)
    mgt.solve_batched(hier_b, torch.stack([b_b, 2 * b_b]), cfg_b, 6)
    b2 = (1 + 1j) * torch.roll(b, 7, -1)
    again = run_a(b2)
    assert profiling.roots()[-1].spans["chunk.reuse"][0] == 1
    after = run_a(b)
    tdriver.release_kept(hier_a)
    _same_result(again, run_a(b2))
    tdriver.release_kept(hier_a)
    _same_result(after, run_a(b))


@pytest.mark.cuda
def test_capture_of_a_host_sync_raises(dev, counters):
    """A body that reads a value back fails its capture with an error;
    nothing runs eagerly in its place, the state is as it was, and the
    counters hold the warm-up's addition (it ran, on copies) and not the
    capture's."""
    chunk = tcompile.CapturedChunk(torch.ones(4, device=dev))
    before = tcompile._counts()

    def body(x):
        cs.launches["dense_apply"] += 1
        return (x * float(x.sum()),), None

    with pytest.raises(RuntimeError):
        chunk("sync", body)
    torch.cuda.synchronize()
    key = ("launches", "dense_apply")
    assert tcompile._counts() == {**before, key: before[key] + 1}
    assert not chunk._graphs
    assert torch.equal(chunk.state[0].cpu(), torch.ones(4))


@pytest.mark.cuda
def test_replayed_flagship_cycle_launches(dev, counters):
    """Replays of one captured flagship cycle (L=256, 3 levels, the
    smoke's) count FLAGSHIP_CYCLE each."""
    import chip_smoke
    cfg = mgt.MGConfig(L=256, stencil="wilson", m=-0.005, nlevels=3,
                       ntl=True, num_iters=4, null_iters=20,
                       dtype="complex64", smoother="rbgs",
                       res_threshold=1e-6)
    rng = np.random.default_rng(cfg.seed)
    U = mgt.models.gauge.gauge_from_phases(phases(rng, 256), cfg.cdtype,
                                           dev)
    hier = mgt.build_hierarchy(mgt.models.operators.assemble(
        cfg.stencil, U, cfg.m), cfg, U=U, check=False)
    b = mgt.point_source(cfg, device=dev)
    chunk = tcompile.CapturedChunk(*mgt.zero_fields(cfg, dev))

    def body(*phis):
        return mgt.cycle(hier, phis, b, cfg)[0], None

    chunk("cycle", body)
    cs.reset_launches()
    for _ in range(3):
        chunk("cycle", body)
    torch.cuda.synchronize()
    want = {k: 3 * v for k, v in chip_smoke.FLAGSHIP_CYCLE.items()}
    assert {k: cs.launches[k] for k in want} == want
