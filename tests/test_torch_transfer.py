"""Setup and transfer modules of the port against the JAX package,
complex128 at 1e-12: restrict / prolong / ortho_pass / coarse_operator in
each blocking quadrant, near-null relaxation from injected starts, and the
NTL min-res weights."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from torch_port_helpers import C128_BAR, crandn, phases, rel_err, t_of  # noqa: E402

import tpu_multigrid as mg  # noqa: E402
from tpu_multigrid.models import gauge as jgauge, operators as jops  # noqa: E402
from tpu_multigrid.ops import galerkin as jgal, nearnull as jnn  # noqa: E402
from tpu_multigrid.ops import stencil as jst, transfer as jtr  # noqa: E402
from tpu_multigrid.solver import cycles as jcy  # noqa: E402
import tpu_multigrid_torch as mgt  # noqa: E402
from tpu_multigrid_torch.ops import galerkin as tgal, nearnull as tnn  # noqa: E402
from tpu_multigrid_torch.ops import dispatch  # noqa: E402
from tpu_multigrid_torch.ops import stencil as tst, transfer as ttr  # noqa: E402
from tpu_multigrid_torch.solver import cycles as tcy  # noqa: E402

L, NC, NF, B = 16, 4, 2, 2


def _wilson_D(seed, L=L, m=-0.005):
    ph = phases(np.random.default_rng(seed), L)
    return jops.assemble("wilson", jgauge.gauge_from_phases(ph), m)


@pytest.mark.parametrize("quad", [1, 2, 3, 4])
def test_restrict_prolong_ortho(quad):
    rng = np.random.default_rng(20 + quad)
    pn = crandn(rng, (NC, NF, L, L))
    vf = crandn(rng, (NF, L, L))
    vc = crandn(rng, (NC, L // B, L // B))
    assert rel_err(dispatch.restrict(t_of(pn), t_of(vf), quad, B, B),
                   jtr.restrict(pn, vf, quad, B, B)) < C128_BAR
    assert rel_err(dispatch.prolong(t_of(pn), t_of(vc), quad, B, B),
                   jtr.prolong(pn, vc, quad, B, B)) < C128_BAR
    assert rel_err(ttr.block_norms(t_of(vf), quad, B, B),
                   jtr.block_norms(vf, quad, B, B)) < C128_BAR
    tp = ttr.normalize_rows(t_of(pn), quad, B, B)
    jp = jtr.normalize_rows(pn, quad, B, B)
    assert rel_err(tp, jp) < C128_BAR
    for _ in range(2):
        tp = ttr.ortho_pass(tp, quad, B, B)
        jp = jtr.ortho_pass(jp, quad, B, B)
    assert rel_err(tp, jp) < C128_BAR
    assert float(ttr.check_ortho(tp, quad, B, B)) < C128_BAR
    # restriction then prolongation with orthonormal rows is the identity
    # on the coarse space (reference self-test 1)
    back = dispatch.restrict(tp, dispatch.prolong(tp, t_of(vc), quad, B, B),
                             quad, B, B)
    assert rel_err(back, vc) < C128_BAR


@pytest.mark.parametrize("quad", [1, 2, 3, 4])
def test_coarse_operator(quad):
    rng = np.random.default_rng(30 + quad)
    jD = _wilson_D(31)
    pn = jtr.ortho_pass(jtr.normalize_rows(crandn(rng, (NC, NF, L, L)),
                                           quad, B, B), quad, B, B)
    want = jgal.coarse_operator(jD, pn, quad, B, B)
    got = tgal.coarse_operator(t_of(jD), t_of(pn), quad, B, B)
    assert tuple(got.shape) == (5, NC, NC, L // B, L // B)
    assert rel_err(got, want) < C128_BAR


@pytest.mark.parametrize("smoother", ["rbgs", "jacobi"])
def test_relax_null_vectors_from_injected_starts(smoother):
    """The k candidates relax as one batch through smooth == JAX's vmap."""
    jD = _wilson_D(40)
    jDinv = jst.site_inverse(jD[0])
    starts = jnn.random_starts(jax.random.PRNGKey(41), NC // 2, NF, L,
                               jnp.complex128)
    want = jnn.relax_null_vectors(jD, jDinv, starts, 16, 4, smoother)
    got = tnn.relax_null_vectors(t_of(jD), t_of(jDinv), t_of(starts), 16, 4,
                                 smoother)
    assert rel_err(got, want) < C128_BAR
    assert rel_err(tnn.candidates_to_phi_null(got, "wilson", NC),
                   jnn.candidates_to_phi_null(want, "wilson", NC)) < C128_BAR


def test_random_starts_shape_and_range():
    import torch
    g = torch.Generator().manual_seed(7)
    s = tnn.random_starts(g, 2, NF, 8, torch.complex64)
    assert tuple(s.shape) == (2, NF, 8, 8) and s.dtype == torch.complex64
    assert float(s.real.abs().max()) <= np.pi and float(s.imag.abs().max()) == 0
    again = tnn.random_starts(torch.Generator().manual_seed(7), 2, NF, 8,
                              torch.complex64)
    assert torch.equal(s, again)


@pytest.mark.parametrize("stencil", ["wilson", "laplace"])
def test_min_res_weights(stencil):
    """Both min-res sources, including the reference's wilson/laplace
    asymmetry (cfg.minres_src='auto')."""
    rng = np.random.default_rng(50)
    n = 2 if stencil == "wilson" else 1
    ph = phases(rng, L)
    jD = jops.assemble(stencil, jgauge.gauge_from_phases(ph), 0.05)
    xs, r = crandn(rng, (4, n, L, L)), crandn(rng, (n, L, L))
    for src in ("auto", "x_dot_r", "r_dot_dx"):
        jcfg = mg.MGConfig(L=L, stencil=stencil, minres_src=src)
        tcfg = mgt.MGConfig(L=L, stencil=stencil, minres_src=src)
        want = jcy.min_res_weights(jD, r, xs, jcfg)
        got = tcy.min_res_weights(t_of(jD), t_of(r), t_of(xs), tcfg)
        assert rel_err(got, want) < C128_BAR


def test_apply_D_batched_matches_per_copy():
    """min_res_weights applies D to all copies at once (JAX vmaps)."""
    rng = np.random.default_rng(51)
    jD = _wilson_D(52)
    xs = crandn(rng, (3, NF, L, L))
    got = tst.apply_D(t_of(jD), t_of(xs))
    for q in range(3):
        assert rel_err(got[q], jst.apply_D(jD, xs[q])) < C128_BAR


# --- the cycle's transfers: the kernels' index map, forms and dispatch ---

import torch  # noqa: E402

from tpu_multigrid_torch.ops import cuda_stencil as tcs  # noqa: E402


def _fine(L, b, o):
    """[L / b, b] fine indices (b X + a + o) mod L of each coarse index X."""
    return (b * torch.arange(L // b)[:, None] + torch.arange(b)[None, :]
            + o) % L


def _mirror_restrict(pn, vf, quad, bx, by):
    """csrc/transfer.cu's restriction in plain torch, by its index map: the
    fine sites s = (bx X + a + ox, by Y + b + oy) mod L gathered by wrapped
    indices, multiplied and summed over (f, a, b); no roll, no einsum."""
    ox, oy = ttr.QUAD_OFFSETS[quad]
    ix = _fine(pn.shape[-2], bx, ox)[:, :, None, None]
    iy = _fine(pn.shape[-1], by, oy)[None, None, :, :]
    p, v = pn[..., ix, iy], vf[..., ix, iy]     # [..., (c,) f, X, a, Y, b]
    return (p * v.unsqueeze(-6)).sum(dim=(-5, -3, -1))


def _mirror_prolong(pn, vc, quad, bx, by, base=None):
    """csrc/transfer.cu's prolongation in plain torch: fine site (x, y)
    reads coarse site ((x - ox) mod L / bx, (y - oy) mod L / by)."""
    ox, oy = ttr.QUAD_OFFSETS[quad]
    Lx, Ly = pn.shape[-2], pn.shape[-1]
    X = ((torch.arange(Lx) - ox) % Lx) // bx
    Y = ((torch.arange(Ly) - oy) % Ly) // by
    w = vc[..., X[:, None], Y[None, :]]                 # [..., c, Lx, Ly]
    out = (torch.conj(pn) * w.unsqueeze(-3)).sum(dim=-4)
    return out if base is None else base + out


# complex64: the mirror and the einsum sum the nf bx by (<= 32) products of
# a coarse site, or the nc of a fine one, in another order
_BARS = {"complex64": 1e-5, "complex128": C128_BAR}


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
@pytest.mark.parametrize("nf", [1, 2, 4])
@pytest.mark.parametrize("bx,by", [(2, 2), (4, 2)])
@pytest.mark.parametrize("quad", [1, 2, 3, 4])
def test_transfer_index_map_matches_the_einsum(quad, bx, by, nf, dtype):
    """The kernels' index map (the quadrant in the index arithmetic) gives
    the einsum over the rolled blocks: restrict, prolong, and prolong onto
    a base, at every quadrant."""
    rng = np.random.default_rng(60 + quad + 7 * nf + bx)
    dt = getattr(torch, dtype)
    pn = t_of(crandn(rng, (NC, nf, L, L))).to(dt)
    vf = t_of(crandn(rng, (nf, L, L))).to(dt)
    vc = t_of(crandn(rng, (NC, L // bx, L // by))).to(dt)
    base = t_of(crandn(rng, (nf, L, L))).to(dt)
    bar = _BARS[dtype]
    assert rel_err(_mirror_restrict(pn, vf, quad, bx, by),
                   dispatch.restrict(pn, vf, quad, bx, by)) < bar
    assert rel_err(_mirror_prolong(pn, vc, quad, bx, by),
                   dispatch.prolong(pn, vc, quad, bx, by)) < bar
    assert rel_err(_mirror_prolong(pn, vc, quad, bx, by, base),
                   dispatch.prolong(pn, vc, quad, bx, by, base=base)) < bar


def _forms(rng, form, nq=4, nf=NF):
    """(phi_null, fine field, coarse field, quad) of one batch form of a
    transfer call, torch tensors; quad None: the NTL copies."""
    def c(shape):
        return t_of(crandn(rng, shape))

    pn = c((NC, nf, L, L))
    vf, vc = c((3, nf, L, L)), c((3, NC, L // B, L // B))
    if form == "shared phi_null, a batch of fields":
        return pn, vf, vc, 3
    if form == "a batch of hierarchies":
        return c((3, NC, nf, L, L)), vf, vc, 2
    if form == "batched phi_null, one field":
        return c((3, NC, nf, L, L)), vf[0], vc[0], 4
    qc = c((3, nq, NC, L // B, L // B))
    if form == "copies":
        return c((nq, NC, nf, L, L)), vf[0], qc[0], None
    if form == "copies, a batch of fields":
        return c((nq, NC, nf, L, L)), vf, qc, None
    assert form == "copies, a batch of hierarchies"
    # the copies' view of an ensemble's NTL stack: strided between entries
    return c((3, 4, NC, nf, L, L))[:, :nq], vf, qc, None


FORMS = ["shared phi_null, a batch of fields", "a batch of hierarchies",
         "batched phi_null, one field", "copies", "copies, a batch of fields",
         "copies, a batch of hierarchies"]


@pytest.mark.parametrize("form", FORMS)
def test_transfer_batch_forms(form):
    """Every batch form the kernels take, c128: against the mirror, entry by
    entry; the copies' form against the stack of one call a quadrant."""
    rng = np.random.default_rng(70 + FORMS.index(form))
    pn, vf, vc, quad = _forms(rng, form)
    if quad is None:
        nq = pn.shape[-5]
        rq = dispatch.restrict(pn, vf, None, B, B)
        pq = dispatch.prolong(pn, vc, None, B, B)
        for q in range(nq):
            p_q = pn[..., q, :, :, :, :]
            assert torch.equal(rq[..., q, :, :, :],
                               dispatch.restrict(p_q, vf, q + 1, B, B))
            assert torch.equal(pq[..., q, :, :, :],
                               dispatch.prolong(p_q, vc[..., q, :, :, :],
                                                q + 1, B, B))
            assert rel_err(rq[..., q, :, :, :],
                           _mirror_restrict(p_q, vf, q + 1, B, B)) < C128_BAR
            assert rel_err(pq[..., q, :, :, :],
                           _mirror_prolong(p_q, vc[..., q, :, :, :], q + 1,
                                           B, B)) < C128_BAR
        lead = tuple(torch.broadcast_shapes(pn.shape[:-5], vf.shape[:-3]))
        assert tuple(rq.shape) == lead + (nq, NC, L // B, L // B)
        assert tuple(pq.shape) == lead + (nq, NF, L, L)
        return
    got_r = dispatch.restrict(pn, vf, quad, B, B)
    got_p = dispatch.prolong(pn, vc, quad, B, B)
    assert rel_err(got_r, _mirror_restrict(pn, vf, quad, B, B)) < C128_BAR
    assert rel_err(got_p, _mirror_prolong(pn, vc, quad, B, B)) < C128_BAR
    assert got_r.shape[0] == got_p.shape[0] == 3


@pytest.mark.parametrize("quad", [1, 2, 3, 4, None])
def test_prolong_onto_base_is_base_plus_prolong(quad):
    """prolong(..., base=b) is b + prolong(...), bit for bit (the cycle's
    phis[l - 1] + correction in one call)."""
    rng = np.random.default_rng(80)
    if quad is None:
        pn, vc = t_of(crandn(rng, (4, NC, NF, L, L))), t_of(
            crandn(rng, (4, NC, L // B, L // B)))
        base = t_of(crandn(rng, (4, NF, L, L)))
        want = base + dispatch.prolong(pn, vc, None, B, B)
        assert torch.equal(ttr.prolong_plain(pn, vc, None, B, B, base),
                           want)
        return
    pn, vc = t_of(crandn(rng, (NC, NF, L, L))), t_of(
        crandn(rng, (NC, L // B, L // B)))
    base = t_of(crandn(rng, (NF, L, L)))
    assert torch.equal(dispatch.prolong(pn, vc, quad, B, B, base=base),
                       base + dispatch.prolong(pn, vc, quad, B, B))


def _refusal(case):
    """(phi_null, field, quad, copies on the field[, bx]) of a call the
    kernels do not take."""
    pn = torch.zeros((NC, NF, 8, 8), dtype=torch.complex64)
    vf = torch.zeros((NF, 8, 8), dtype=torch.complex64)
    vc = torch.zeros((NC, 4, 4), dtype=torch.complex64)
    return {
        "non-contiguous phi_null": (pn.transpose(-1, -2), vf, 1, False),
        "non-contiguous field": (pn, vf.transpose(-1, -2), 1, False),
        "blocks that do not divide L": (pn, vf, 1, False, 3),
        "two batch axes": (pn.expand(2, 2, *pn.shape), vf, 1, False),
        "batches that differ": (pn.expand(2, *pn.shape), vf.expand(3, *vf.shape),
                                1, False),
        "another dtype": (pn, vf.to(torch.complex128), 1, False),
        "another device": (pn, vf.to("meta"), 1, False),
        "copies without a copy axis": (pn, vf, None, False),
        "copies of the coarse field that differ": (
            pn.expand(4, *pn.shape), vc.expand(3, *vc.shape), None, True),
    }[case]


@pytest.mark.parametrize("case", [
    "non-contiguous phi_null", "non-contiguous field",
    "blocks that do not divide L", "two batch axes", "batches that differ",
    "another dtype", "another device", "copies without a copy axis",
    "copies of the coarse field that differ"])
def test_transfer_wrapper_refuses(case):
    """The checks the wrappers make before a launch (cuda_stencil.
    _transfer_call, run here on CPU tensors) raise on what the kernels do
    not take."""
    pn, field, quad, copies, *blk = _refusal(case)
    bx = blk[0] if blk else B
    with pytest.raises((ValueError, TypeError)):
        tcs._transfer_call(pn, field, quad, bx, B, copies)


def test_transfer_wrapper_launch_shapes():
    """The launch arguments of the forms the cycle takes: entries, copies,
    quadrant masks and the per-operand strides (0: shared)."""
    pn = torch.zeros((3, 4, NC, NF, 8, 8), dtype=torch.complex64)
    vf = torch.zeros((3, NF, 8, 8), dtype=torch.complex64)
    lead, nq, args = tcs._transfer_call(pn[:, :4], vf, None, 2, 2, False)
    entry = NC * NF * 64
    assert (lead, nq) == ((3,), 4)
    # copy q at quadrant q + 1: x offsets at copies 1, 2; y at 2, 3
    assert args == (3, 4, NC, NF, 8, 8, 2, 2, 0b0110, 0b1100, 4 * entry,
                    entry, NF * 64, 0)
    lead, nq, args = tcs._transfer_call(pn[0, 0], vf, 3, 2, 2, False)
    assert (lead, nq) == ((3,), None)
    assert args == (3, 1, NC, NF, 8, 8, 2, 2, 1, 1, 0, 0, NF * 64, 0)
