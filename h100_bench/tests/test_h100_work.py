"""The frozen work model against counts made by hand from the shapes."""
import pytest

from h100_bench.work import model

PK = model.peaks()


@pytest.mark.parametrize("kernel,kw,words,flops_site", [
    # B1: the links smoother, rbgs x4 at L=256 c64: U 2, r 2, phi in and
    # out 4 words a site; (48 + 8) flops a sweep
    ("links_update", dict(n=2, L=256, n_sweeps=4), 8, 56 * 4),
    # B3: the dense smoother n=4 L=128: D 80, r 4, phi in and out 8
    ("dense_update", dict(n=4, L=128, n_sweeps=4), 92, (8 * 80 + 8) * 4),
    # B6: the same at L=1024, its x-tiled shape
    ("dense_update_tiled", dict(n=4, L=1024, n_sweeps=4), 92,
     (8 * 80 + 8) * 4),
    # B7a: the min-res apply on 4 copies, n=4 L=64: D 80, 4 x (v, out) 32
    ("dense_apply", dict(n=4, L=64, batch=4), 112, 8 * 80 * 4),
])
def test_hand_counts(kernel, kw, words, flops_site):
    L = kw["L"]
    it = model.Item(kernel, dtype="complex64", **kw)
    nbytes, flops = it.work()
    assert nbytes == words * L * L * 8
    assert flops == flops_site * L * L
    t, what = model.bound_seconds(nbytes, flops, "complex64", PK)
    assert what == "bytes" and t == pytest.approx(nbytes / 3.35e12)


def test_bounds_match_the_kernel_table_of_perf_md():
    """B1 1.25, B3 3.60, B6 230.4, B7a 1.10 microseconds (PERF.md §6, rounded)."""
    us = [model.bound([model.Item(k, dtype="complex64", **kw)])[0] * 1e6
          for k, kw in [("links_update", dict(n=2, L=256, n_sweeps=4)),
                        ("dense_update", dict(n=4, L=128, n_sweeps=4)),
                        ("dense_update", dict(n=4, L=1024, n_sweeps=4)),
                        ("dense_apply", dict(n=4, L=64, batch=4))]]
    assert [round(u, 2) for u in us] == [1.25, 3.6, 230.37, 1.1]


def count(items, kernel):
    return sum(it.count for it in items if it.kernel == kernel)


def test_flagship_cycle_is_the_launch_structure():
    """One flagship cycle: 2 links smooths, 5 dense smooths (levels 1-2
    twice, the copies once), 3 residuals (the level-0 one fused with its
    restriction in the program), 1 min-res apply."""
    cfg = dict(L=256, nlevels=3, n_copies=4, num_iters=4, block_x=2,
               stencil="wilson")
    items = model.ntl_cycle(cfg, "complex64")
    assert count(items, "links_update") == 2
    assert count(items, "dense_update") == 5
    assert count(items, "links_residual") == 1
    assert count(items, "dense_residual") == 2
    assert count(items, "dense_apply") == 1
    large = model.ntl_cycle(dict(cfg, L=2048, nlevels=6), "complex64")
    assert count(large, "dense_update") == 11
    assert count(large, "dense_residual") == 5


def test_setup_work():
    """The setup relaxes nc / 2 = 2 candidates a configuration, 25 calls
    of 4 sweeps at each of the 3 levels above the coarsest; level 0 as
    links work on each configuration's links."""
    cfg = dict(L=256, nlevels=3, null_iters=100, iters_per_norm=4,
               block_x=2, stencil="wilson")
    items = model.setup(cfg, "complex64", configs=8)
    assert [(it.kernel, it.n, it.L, it.count, it.batch, it.op_batch,
             it.u_batch) for it in items] == [
        ("links_update", 2, 256, 25, 16, 1, 8),
        ("dense_update", 4, 128, 25, 16, 8, 1),
        ("dense_update", 4, 64, 25, 16, 8, 1)]


def test_wilson_level0_is_links_work_wherever_it_runs():
    """The ensemble's level 0 and solve_ir's outer residual run dense
    kernels in the program; the yardstick charges the links' bytes: U 2
    words a site a configuration, not the dense operator's 5 n^2 = 20."""
    cfg = dict(L=128, nlevels=2, n_copies=4, num_iters=4, block_x=2,
               stencil="wilson")
    items = model.ntl_cycle(cfg, "complex64", batch=8, ensemble=True)
    smooth = [it for it in items if it.kernel == "links_update"][0]
    # U 2 x 8 configurations, r 2 x 8, phi in and out 4 x 8
    assert smooth.work()[0] == 2 * (2 * 8 + 2 * 8 + 4 * 8) * 128 * 128 * 8
    assert count(items, "dense_residual") == 1  # level 1 only
    (outer,) = model.level0_residual(dict(cfg, L=256), "complex128")
    assert outer.kernel == "links_residual"
    assert outer.work()[0] == (2 + 2 + 4) * 256 * 256 * 16
    laplace = model.level0_residual(dict(cfg, stencil="laplace"),
                                    "complex64")
    assert laplace[0].kernel == "dense_residual"


def test_kernel_table_rows():
    table = model.kernel_table()
    assert {"links_update_kernel", "dense_update_kernel",
            "dense_rb_tiled_kernel", "links_rb_tiled_kernel",
            "dense_apply_kernel"} <= set(table)
    assert all(set(r) == {"kernel", "tpu", "work", "what"}
               for r in table.values())
