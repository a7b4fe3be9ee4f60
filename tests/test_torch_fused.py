"""The fused level-0 residual-restriction (B2 with the restriction of its
output) and the dense residual (B7a / B7b with a residual epilogue, the
batch in groups that share one D) against the JAX package.

The port's side is ops/dispatch, which runs the plain versions on CPU
tensors; the kernels themselves are held against those on the card
(tests/test_torch_cuda.py).
The Pallas kernels compute in float32 planes, so complex64 is held against
them (interpret mode) at 2e-5, and complex128 against the JAX package's
plain functions (transfer.restrict of gauge_stencil.residual_u, and
stencil.residual) at 1e-12.

Also: the cycles call these dispatchers with their cfg.pallas (ntl_cycle,
v_cycle, gamma_cycle, min_res_weights), and the shape rules of the dense
SpMV's groups (dense_groups)."""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from torch_port_helpers import (C128_BAR, C64_BAR, crandn, phases,  # noqa: E402
                                rel_err, spy_dispatch, t_of)

from tpu_multigrid.models import gauge as jgauge  # noqa: E402
from tpu_multigrid.ops import gauge_stencil as jgs  # noqa: E402
from tpu_multigrid.ops import pallas_stencil as ps  # noqa: E402
from tpu_multigrid.ops import stencil as jst  # noqa: E402
from tpu_multigrid.ops import transfer as jtr  # noqa: E402
import tpu_multigrid_torch as mgt  # noqa: E402
from tpu_multigrid_torch.ops import cuda_stencil as cs  # noqa: E402
from tpu_multigrid_torch.ops import dispatch  # noqa: E402
from tpu_multigrid_torch.solver import cycles as tcy  # noqa: E402

M = -0.005


@pytest.fixture
def interpret_pallas(monkeypatch):
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _links(rng, L, dtype):
    return jgauge.gauge_from_phases(phases(rng, L), dtype)


# ---- the fused residual-restriction (B2 + restrict)


@pytest.mark.parametrize("B", [None, 4, 8])
@pytest.mark.parametrize("nc", [1, 2, 4])
@pytest.mark.parametrize("quad", [1, 2, 3, 4])
def test_residual_restrict_c128_matches_jax(quad, nc, B):
    """restrict(phi_null, r - D_U phi) of JAX's plain path, each entry of a
    batch against its own; blocks 2 x 2 (nc=4), 4 x 2 (nc=2), 2 x 4
    (nc=1)."""
    rng = np.random.default_rng(100 * quad + 10 * nc + (B or 1))
    L = 8
    bx, by = {4: (2, 2), 2: (4, 2), 1: (2, 4)}[nc]
    jU = _links(rng, L, jnp.complex128)
    lead = (B,) if B else ()
    phi, r = crandn(rng, lead + (2, L, L)), crandn(rng, lead + (2, L, L))
    pn = crandn(rng, (nc, 2, L, L))
    got = dispatch.links_residual_restrict(t_of(jU), M, t_of(phi), t_of(r),
                                           t_of(pn), quad, bx, by)

    def jax_one(p, q):
        return jtr.restrict(pn, jgs.residual_u("wilson", jU, M, p, q), quad,
                            bx, by)

    want = (np.stack([np.asarray(jax_one(phi[b], r[b])) for b in range(B)])
            if B else jax_one(phi, r))
    assert got.shape == lead + (nc, L // bx, L // by)
    assert rel_err(got, want) < C128_BAR


@pytest.mark.parametrize("quad", [1, 2, 3, 4])
@pytest.mark.parametrize("nc", [1, 2, 4])
def test_residual_restrict_c64_matches_pallas(interpret_pallas, quad, nc):
    """JAX's level-0 path on the Pallas residual kernel (interpret mode),
    then restrict, against the port's dispatched residual-restriction."""
    rng = np.random.default_rng(200 + 10 * quad + nc)
    L = 16
    jU = _links(rng, L, jnp.complex64)
    phi = crandn(rng, (2, L, L), np.complex64)
    r = crandn(rng, (2, L, L), np.complex64)
    pn = crandn(rng, (nc, 2, L, L), np.complex64)
    res = ps.wilson_u_residual_pallas(jU, M, jnp.asarray(phi), jnp.asarray(r),
                                      "vmem")
    want = jtr.restrict(jnp.asarray(pn), res, quad, 2, 2)
    got = dispatch.links_residual_restrict(t_of(jU), M, t_of(phi), t_of(r),
                                           t_of(pn), quad, 2, 2)
    assert got.dtype == torch.complex64
    assert rel_err(got, want) < C64_BAR


def test_residual_restrict_shared_r():
    """r shared by a batch of phi: each entry's residual of the one r."""
    rng = np.random.default_rng(7)
    L = 8
    U = t_of(np.exp(1j * phases(rng, L)))
    phi, r = t_of(crandn(rng, (3, 2, L, L))), t_of(crandn(rng, (2, L, L)))
    pn = t_of(crandn(rng, (4, 2, L, L)))
    got = dispatch.links_residual_restrict(U, M, phi, r, pn, 3, 2, 2)
    for b in range(3):
        one = dispatch.links_residual_restrict(U, M, phi[b], r, pn, 3, 2, 2)
        assert torch.equal(got[b], one)


# ---- the dense residual in groups (B7a / B7b residual epilogue)


def _dense(rng, n, L, dtype=np.complex128, lead=()):
    D = 0.25 * crandn(rng, lead + (5, n, n, L, L))
    D[..., 0, :, :, :, :] += 4.0 * np.eye(n)[:, :, None, None]
    return D.astype(dtype)


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("n,B,G", [(4, 1, 1), (4, 8, 1), (4, 8, 4),
                                   (4, 8, 8), (2, 4, 4), (1, 4, 1),
                                   (2, 8, 4)])
def test_dense_residual_c128_matches_jax(n, B, G, tiled):
    """B entries in groups of G sharing one D (G = B: D without a batch
    axis) against JAX's stencil.residual entry by entry."""
    rng = np.random.default_rng(300 + 10 * n + B + G)
    L = 8
    E = B // G
    D = _dense(rng, n, L, lead=() if G == B else (E,))
    lead = (B,) if B > 1 else ()
    phi, r = crandn(rng, lead + (n, L, L)), crandn(rng, lead + (n, L, L))
    # tiled: phi a view one element into its storage, as an operand the
    # global kernel refuses would be in complex64
    ph = t_of(phi)
    if tiled:
        ph = torch.cat([ph.reshape(-1)[:1], ph.reshape(-1)])[1:].view(
            ph.shape)
    got = dispatch.residual(t_of(D), ph, t_of(r))
    if B == 1:
        want = jst.residual(D, phi, r)
    else:
        want = np.stack([np.asarray(jst.residual(
            D if G == B else D[b // G], phi[b], r[b])) for b in range(B)])
    assert rel_err(got, want) < C128_BAR


@pytest.mark.parametrize("G", [1, 4, 8])
def test_dense_residual_c64_matches_pallas(interpret_pallas, G):
    """r - D v with D v from the Pallas SpMV kernel (interpret mode), per
    entry, against the port's residual on the batch of 8 in groups of G."""
    rng = np.random.default_rng(400 + G)
    n, L, B = 4, 8, 8
    D = _dense(rng, n, L, np.complex64, lead=() if G == B else (B // G,))
    phi = crandn(rng, (B, n, L, L), np.complex64)
    r = crandn(rng, (B, n, L, L), np.complex64)
    if G == B:
        Dv = jax.vmap(ps.apply_D_pallas, in_axes=(None, 0))(
            jnp.asarray(D), jnp.asarray(phi))
    else:       # each entry's copy of D, one vmapped call for the batch
        Dv = jax.vmap(ps.apply_D_pallas)(jnp.asarray(np.repeat(D, G, 0)),
                                         jnp.asarray(phi))
    want = r - np.asarray(Dv)
    got = dispatch.residual(t_of(D), t_of(phi), t_of(r))
    assert rel_err(got, want) < C64_BAR


def test_grouped_apply_and_refusals():
    """dense_groups: a D without a batch axis serves every entry; E copies
    serve groups of B / E; v without a batch axis is shared by the copies;
    shapes that do not fit raise ValueError (on CPU tensors too)."""
    rng = np.random.default_rng(500)
    L = 8
    D2, v8 = t_of(_dense(rng, 2, L, lead=(2,))), t_of(crandn(rng, (8, 2, L, L)))
    g = cs.dense_groups("t", D2, v8)
    assert (g.B, g.G, g.lead, g.d_bs, g.v_bs) == (8, 4, (8,), 5 * 4 * 64,
                                                  2 * 64)
    got = dispatch.apply_D(D2, v8)
    for b in range(8):
        assert torch.equal(got[b], mgt.ops.stencil.apply_D(D2[b // 4], v8[b]))
    g = cs.dense_groups("t", D2, v8[0])
    assert (g.B, g.G, g.v_bs) == (2, 1, 0)
    g = cs.dense_groups("t", D2[0], v8, v8[0])
    assert (g.B, g.G, g.d_bs, g.r_bs) == (8, 8, 0, 0)
    v3 = t_of(crandn(rng, (3, 2, L, L)))
    for call in (lambda: dispatch.apply_D(D2, v3),
                 lambda: dispatch.residual(D2, v8, v3),
                 lambda: dispatch.apply_D(D2[..., :4], v8)):
        with pytest.raises(ValueError):
            call()


# ---- the cycles route through the new wrappers


@pytest.fixture(scope="module")
def small_hierarchy():
    """Wilson L=16, 3 levels (2 x 2 blocks, 4 near-null rows), NTL with 4
    copies, complex128, the links on the hierarchy."""
    cfg = mgt.MGConfig(L=16, stencil="wilson", m=0.1, nlevels=3, ntl=True,
                       num_iters=2, null_iters=8, dtype="complex128",
                       links="on")
    rng = np.random.default_rng(11)
    U = mgt.models.gauge.gauge_from_phases(phases(rng, 16), cfg.cdtype)
    D = mgt.models.operators.assemble("wilson", U, cfg.m)
    return cfg, mgt.build_hierarchy(D, cfg, U=U, check=False)


DISPATCHERS = ("links_residual_restrict", "residual", "apply_D")


@pytest.mark.parametrize("cycle,want", [
    # level 0's residual-restriction, levels 1-2 dense residuals, one
    # min-res apply
    ("ntl", {"links_residual_restrict": 1, "residual": 2, "apply_D": 1}),
    # the V- and W-cycle restrict at levels 0-2 (the W-cycle visits
    # level 1 twice and level 2 four times)
    ("v", {"links_residual_restrict": 1, "residual": 2}),
    ("gamma", {"links_residual_restrict": 1, "residual": 6}),
])
@pytest.mark.parametrize("pallas", ["auto", "off"])
def test_cycles_call_the_new_wrappers(monkeypatch, small_hierarchy, cycle,
                                      want, pallas):
    cfg, hier = small_hierarchy
    cfg = cfg.replace(pallas=pallas, ntl=cycle == "ntl",
                      cycle_gamma=2 if cycle == "gamma" else 1)
    b = mgt.point_source(cfg)
    fn = {"ntl": tcy.ntl_cycle, "v": tcy.v_cycle,
          "gamma": tcy.gamma_cycle}[cycle]
    phis = mgt.zero_fields(cfg)
    plain = fn(hier, phis, b, cfg.replace(pallas="off"))
    calls = spy_dispatch(monkeypatch, *DISPATCHERS)
    got = fn(hier, phis, b, cfg)
    names = [name for name, _ in calls]
    assert {k: names.count(k) for k in DISPATCHERS if k in names} == want
    assert {p for _, p in calls} == {pallas}
    phi, phi_plain = (got[0][0], plain[0][0]) if cycle == "ntl" else (
        got[0], plain[0])
    assert rel_err(phi, phi_plain) < C128_BAR


@pytest.mark.parametrize("batched", [False, True])
def test_min_res_weights_on_the_spmv_wrapper(monkeypatch, small_hierarchy,
                                             batched):
    """One apply_D call on the copies flattened to one batch axis, the
    weights equal to the plain path's."""
    cfg, hier = small_hierarchy
    rng = np.random.default_rng(12)
    D_f = hier.levels[2].D
    S, nf = D_f.shape[-1], D_f.shape[1]
    lead = (3,) if batched else ()
    xs = t_of(crandn(rng, lead + (4, nf, S, S)))
    r_f = t_of(crandn(rng, lead + (nf, S, S)))
    plain = tcy.min_res_weights(D_f, r_f, xs, cfg.replace(pallas="off"))
    calls = spy_dispatch(monkeypatch, "apply_D")
    got = tcy.min_res_weights(D_f, r_f, xs, cfg)
    assert calls == [("apply_D", "auto")] and got.shape == lead + (4,)
    assert rel_err(got, plain) < C128_BAR
