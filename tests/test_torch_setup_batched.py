"""The port's setup on a leading configuration axis against the JAX
package's, which vmaps it (solver/ensemble._batched_setup_traced): on the
CPU in complex128 at 1e-12, B=3 configurations at L=16, Wilson and
Laplace, null_joint_qr off and on.

Each batched piece (relax_null_vectors, normalize_rows, ortho_pass,
check_ortho, coarse_operator, hierarchy._setup_level and build_ntl) is
held against jax.vmap of its JAX counterpart on the same numpy inputs;
the whole build_hierarchies_batched against JAX's from JAX's starts; each
configuration of the batched setup against build_hierarchy on that
configuration alone; the plain smoother with one operator a group of
fields against a loop over the groups; and the batched setup against its
launches: one smooth call a renormalization for the whole batch.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from torch_port_helpers import C128_BAR, crandn, phases, rel_err, t_of  # noqa: E402

import tpu_multigrid as mg  # noqa: E402
from tpu_multigrid.ops import galerkin as jgal, nearnull as jnn  # noqa: E402
from tpu_multigrid.ops import stencil as jst, transfer as jtr  # noqa: E402
from tpu_multigrid.ops.nearnull import random_starts as jax_random_starts  # noqa: E402
from tpu_multigrid.solver import ensemble as jens, hierarchy as jhier  # noqa: E402
import tpu_multigrid_torch as mgt  # noqa: E402
from tpu_multigrid_torch.ops import galerkin as tgal, nearnull as tnn  # noqa: E402
from tpu_multigrid_torch.ops import smoothers as tsm, transfer as ttr  # noqa: E402
from tpu_multigrid_torch.solver import hierarchy as thier  # noqa: E402
from tpu_multigrid_torch.utils.convert import config_from_dict  # noqa: E402

B, L = 3, 16
STENCILS = ["wilson", "laplace"]
QR = [False, True]


def _cfgs(stencil, joint_qr):
    jcfg = mg.MGConfig(L=L, stencil=stencil, m=0.1, nlevels=2, ntl=True,
                       num_iters=4, null_iters=40, null_joint_qr=joint_qr,
                       res_threshold=1e-10)
    return jcfg, config_from_dict(dataclasses.asdict(jcfg))


def _jax_starts(cfg, batch):
    """The starts jens.build_hierarchies_batched draws from
    PRNGKey(cfg.seed): per level a split of the key, then one subkey per
    configuration."""
    key = jax.random.PRNGKey(cfg.seed)
    out = []
    for lvl in range(cfg.nlevels):
        key, sub = jax.random.split(key)
        nc = cfg.n_dof[lvl + 1]
        k = nc // 2 if cfg.stencil == "wilson" else nc
        out.append(np.array(jax.vmap(lambda kk: jax_random_starts(
            kk, k, cfg.n_dof[lvl], cfg.sizes[lvl], cfg.cdtype))(
                jax.random.split(sub, batch))))
    return out


def _operators(stencil, cfg, seed=0):
    """B level-0 operators [B, 5, n, n, L, L] from gauge phases drawn with
    numpy, and their site inverses."""
    rng = np.random.default_rng(seed)
    Us = np.stack([np.asarray(mg.models.gauge.gauge_from_phases(
        phases(rng, L, 0.3), cfg.cdtype)) for _ in range(B)])
    D = np.stack([np.asarray(mg.models.operators.assemble(stencil, U, cfg.m))
                  for U in Us])
    return Us, D, np.asarray(jax.vmap(lambda d: jst.site_inverse(d[0]))(D))


def _phi_null(rng, stencil, cfg):
    """Near-null stacks [B, nc, nf, L, L] of level 0 (chirally split for
    Wilson, as candidates_to_phi_null makes them)."""
    nc, nf = cfg.n_dof[1], cfg.n_dof[0]
    k = nc // 2 if stencil == "wilson" else nc
    vecs = crandn(rng, (B, k, nf, L, L))
    return np.asarray(jax.vmap(lambda v: jnn.candidates_to_phi_null(
        v, stencil, nc))(vecs))


@pytest.mark.parametrize("joint_qr", QR, ids=["indep", "joint_qr"])
@pytest.mark.parametrize("stencil", STENCILS)
def test_relax_null_vectors_batched_matches_jax(stencil, joint_qr):
    jcfg, tcfg = _cfgs(stencil, joint_qr)
    _, D, Dinv = _operators(stencil, jcfg)
    starts = _jax_starts(jcfg, B)[0]
    want = np.asarray(jax.vmap(lambda d, di, s: jnn.relax_null_vectors(
        d, di, s, 20, 4, "rbgs", 1.0, joint_qr))(D, Dinv, starts))
    got = tnn.relax_null_vectors(t_of(D), t_of(Dinv), t_of(starts), 20, 4,
                                 "rbgs", 1.0, joint_qr)
    assert got.shape == (B,) + starts.shape[1:]
    assert rel_err(got, want) < C128_BAR
    nc = jcfg.n_dof[1]
    assert rel_err(tnn.candidates_to_phi_null(got, stencil,
                                              nc).resolve_conj(),
                   jax.vmap(lambda v: jnn.candidates_to_phi_null(
                       v, stencil, nc))(want)) < C128_BAR


@pytest.mark.parametrize("quad", [1, 3])
@pytest.mark.parametrize("stencil", STENCILS)
def test_transfer_setup_ops_batched_match_jax(stencil, quad):
    """normalize_rows, two ortho passes, check_ortho and the Galerkin
    coarse operator over the configuration axis."""
    jcfg, _ = _cfgs(stencil, False)
    _, D, _ = _operators(stencil, jcfg, seed=1)
    pn = _phi_null(np.random.default_rng(2), stencil, jcfg)
    bx = by = 2
    j_norm = jax.vmap(lambda p: jtr.normalize_rows(p, quad, bx, by))(pn)
    t_norm = ttr.normalize_rows(t_of(pn), quad, bx, by)
    assert rel_err(t_norm, j_norm) < C128_BAR
    j_orth = jax.vmap(lambda p: jtr.ortho_pass(jtr.ortho_pass(
        p, quad, bx, by), quad, bx, by))(j_norm)
    t_orth = ttr.ortho_pass(ttr.ortho_pass(t_norm, quad, bx, by), quad, bx,
                            by)
    assert rel_err(t_orth, j_orth) < C128_BAR
    # check_ortho: one worst a configuration, before and after the passes
    for t_p, j_p in ((t_norm, j_norm), (t_orth, j_orth)):
        tw = ttr.check_ortho(t_p, quad, bx, by)
        jw = np.asarray(jax.vmap(lambda p: jtr.check_ortho(
            p, quad, bx, by))(j_p))
        assert tw.shape == (B,)
        np.testing.assert_allclose(tw.numpy(), jw, rtol=1e-10, atol=1e-14)
    j_dc = jax.vmap(lambda d, p: jgal.coarse_operator(d, p, quad, bx, by))(
        D, j_orth)
    t_dc = tgal.coarse_operator(t_of(D), t_orth, quad, bx, by)
    assert t_dc.shape == (B, 5) + pn.shape[1:2] * 2 + (L // 2, L // 2)
    assert rel_err(t_dc, j_dc) < C128_BAR


@pytest.mark.parametrize("joint_qr", QR, ids=["indep", "joint_qr"])
@pytest.mark.parametrize("stencil", STENCILS)
def test_setup_level_and_build_ntl_batched_match_jax(stencil, joint_qr):
    """hierarchy._setup_level and build_ntl on the configuration axis
    against jax.vmap of _setup_level_core and _build_ntl_core."""
    jcfg, tcfg = _cfgs(stencil, joint_qr)
    _, D, _ = _operators(stencil, jcfg, seed=3)
    starts = _jax_starts(jcfg, B)[0]
    jD0inv, jpn, jDc, _ = jax.vmap(lambda d, s: jhier._setup_level_core(
        d, s, jcfg, 0, jcfg.quad, True))(D, starts)
    tD0inv, tpn, tDc = thier._setup_level(t_of(D), tcfg, 0, tcfg.quad,
                                          t_of(starts), check=True)
    for t, j in ((tD0inv, jD0inv), (tpn, jpn), (tDc, jDc)):
        assert rel_err(t, j) < C128_BAR
    # build_ntl re-sets up level nlevels - 1 (here 1): give it level 0's
    # operator and near-nulls there
    jntl, _ = jax.vmap(lambda p, d: jhier._build_ntl_core(p, d, jcfg))(
        jpn, D)
    lvl = thier.LevelOps(D=t_of(D), D0inv=tD0inv, phi_null=tpn)
    tntl = thier.build_ntl([lvl] * tcfg.nlevels, tcfg, check=True)
    for name in ("phi_null", "D", "D0inv"):
        got, want = getattr(tntl, name), getattr(jntl, name)
        assert got.shape == want.shape
        assert rel_err(got, want) < C128_BAR


@pytest.mark.parametrize("stencil", STENCILS)
def test_build_hierarchies_batched_matches_jax(stencil):
    """The whole batched setup from JAX's starts against JAX's
    build_hierarchies_batched: every level's D, D0inv and phi_null and the
    NTL copies at 1e-12."""
    jcfg, tcfg = _cfgs(stencil, False)
    Us, _, _ = _operators(stencil, jcfg, seed=4)
    jh = jens.build_hierarchies_batched(jnp.asarray(Us), jcfg)
    th = mgt.build_hierarchies_batched(t_of(Us), tcfg,
                                       starts=_jax_starts(jcfg, B))
    assert th.gauge is None
    for jl, tl in zip(jh.levels, th.levels):
        for name in ("D", "D0inv", "phi_null"):
            want = getattr(jl, name)
            if want is not None:
                assert rel_err(getattr(tl, name), want) < C128_BAR
    for name in ("phi_null", "D", "D0inv"):
        assert rel_err(getattr(th.ntl, name),
                       getattr(jh.ntl, name)) < C128_BAR


@pytest.mark.parametrize("joint_qr", QR, ids=["indep", "joint_qr"])
@pytest.mark.parametrize("stencil", STENCILS)
def test_batched_setup_is_each_configurations_own(stencil, joint_qr):
    """Configuration i of build_hierarchies_batched against build_hierarchy
    on its operator alone from the same starts (the single-configuration
    setup is the same code without the axis)."""
    jcfg, tcfg = _cfgs(stencil, joint_qr)
    Us, D, _ = _operators(stencil, jcfg, seed=5)
    starts = _jax_starts(jcfg, B)
    hb = mgt.build_hierarchies_batched(t_of(Us), tcfg, starts=starts)
    for i in range(B):
        h = mgt.build_hierarchy(t_of(D[i]), tcfg, check=False,
                                starts=[s[i] for s in starts])
        for lb, l1 in zip(hb.levels, h.levels):
            for name in ("D", "D0inv", "phi_null"):
                if getattr(l1, name) is not None:
                    assert rel_err(getattr(lb, name)[i],
                                   getattr(l1, name)) < 1e-13
        for name in ("phi_null", "D", "D0inv"):
            assert rel_err(getattr(hb.ntl, name)[i],
                           getattr(h.ntl, name)) < 1e-13


@pytest.mark.parametrize("kind", ["rbgs", "jacobi", "gs_lex"])
@pytest.mark.parametrize("shared_r", [True, False], ids=["r_shared",
                                                         "r_batched"])
def test_plain_smoother_groups_equal_a_loop(kind, shared_r):
    """The dispatched smooth of CPU tensors (smooth_plain) with D [C, ...]
    and fields [C, k, ...] (each operator broadcast over its group of k)
    equals a loop over the C groups."""
    rng = np.random.default_rng(6)
    C, k, n, Ls = 3, 2, 4, 8
    D = 0.25 * crandn(rng, (C, 5, n, n, Ls, Ls))
    D[:, 0] += 4.0 * np.eye(n)[:, :, None, None]
    D = t_of(D)
    Dinv = mgt.ops.stencil.site_inverse(D[:, 0])
    phi = t_of(crandn(rng, (C, k, n, Ls, Ls)))
    r = t_of(crandn(rng, (n, Ls, Ls) if shared_r else (C, k, n, Ls, Ls)))
    got = mgt.ops.dispatch.smooth(D, Dinv, phi, r, 3, kind, 0.9)
    for c in range(C):
        want = tsm.smooth_plain(D[c], Dinv[c], phi[c],
                                r if shared_r else r[c], 3, kind, 0.9)
        assert rel_err(got[c], want) < 1e-14


def test_batched_setup_makes_one_smooth_call_a_renormalization(monkeypatch):
    """build_hierarchies_batched relaxes every configuration's candidates
    in one smooth call a renormalization, null_iters // iters_per_norm
    calls a level, each over the whole batch [B, k, nf, S, S]."""
    jcfg, tcfg = _cfgs("wilson", False)
    Us, _, _ = _operators("wilson", jcfg, seed=7)
    calls = []
    real = mgt.ops.dispatch.smooth

    def counted(D, D0inv, phi, *a, **kw):
        calls.append((tuple(D.shape), tuple(phi.shape)))
        return real(D, D0inv, phi, *a, **kw)

    monkeypatch.setattr(mgt.ops.dispatch, "smooth", counted)
    mgt.build_hierarchies_batched(t_of(Us), tcfg)
    per_level = tcfg.null_iters // tcfg.iters_per_norm
    assert len(calls) == tcfg.nlevels * per_level
    for lvl in range(tcfg.nlevels):
        nf, S = tcfg.n_dof[lvl], tcfg.sizes[lvl]
        k = tcfg.n_dof[lvl + 1] // 2
        for d_shape, phi_shape in calls[lvl * per_level:(lvl + 1) * per_level]:
            assert phi_shape == (B, k, nf, S, S)
            assert d_shape == (B, 5, nf, nf, S, S)
