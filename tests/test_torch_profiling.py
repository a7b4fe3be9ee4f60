"""The port's profiling module against the JAX package's: the byte and
nonzero accounting agree, roofline_table on CPU tensors has JAX's plain
rows (and, with no card, no roofline fraction), the card's HBM peak comes
from its name and an unknown card raises, and trace() writes a Chrome
trace."""
import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

import torch  # noqa: E402

from torch_port_helpers import t_of  # noqa: E402

import tpu_multigrid as mg  # noqa: E402
from tpu_multigrid import profiling as jprof  # noqa: E402
import tpu_multigrid_torch as mgt  # noqa: E402
from tpu_multigrid_torch import profiling as tprof  # noqa: E402


@pytest.mark.parametrize("n,L,nbytes", [(1, 16, 8), (2, 256, 8),
                                        (4, 1024, 16), (2, 4096, 8)])
def test_bytes_and_nnz_match_jax(n, L, nbytes):
    assert tprof.stencil_bytes(n, L, nbytes) == jprof.stencil_bytes(n, L,
                                                                    nbytes)
    assert tprof.stencil_bytes(n, L) == jprof.stencil_bytes(n, L)
    # the port keeps no stencil_nnz (nothing read it)
    assert not hasattr(tprof, "stencil_nnz")


def test_roofline_table_on_cpu_has_jax_plain_rows():
    cfg = mg.MGConfig(L=16, stencil="laplace", m=0.1, nlevels=1)
    U = mg.models.gauge.identity_gauge(16, cfg.cdtype)
    D = mg.models.operators.assemble("laplace", U, cfg.m)
    v = np.random.default_rng(8).normal(size=(1, 16, 16)) + 0j
    want = jprof.roofline_table(cfg, D, jax.numpy.asarray(v))
    tcfg = mgt.MGConfig(L=16, stencil="laplace", m=0.1, nlevels=1)
    got = tprof.roofline_table(tcfg, t_of(np.asarray(D)), t_of(v), reps=5)
    assert [r["name"] for r in got["rows"]] == [r["name"]
                                                for r in want["rows"]]
    assert [r["bytes"] for r in got["rows"]] == [r["bytes"]
                                                 for r in want["rows"]]
    assert got["device"] == "cpu" and got["peak_bytes_per_s"] is None
    for r in got["rows"]:
        assert r["sec"] > 0 and r["bw_frac"] is None


@pytest.mark.parametrize("name,peak", [
    ("NVIDIA H100 80GB HBM3", 3.35e12), ("NVIDIA H100 SXM5 80GB", 3.35e12),
    ("NVIDIA H100 PCIe", 2.0e12), ("NVIDIA H200", 4.8e12)])
def test_peak_bandwidth_by_card_name(monkeypatch, name, peak):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert tprof.peak_bandwidth() == peak


def test_peak_bandwidth_refuses_an_unknown_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError):
        tprof.peak_bandwidth()


def test_time_op_chains_reps():
    calls = []

    def fn(a, x):
        calls.append(1)
        return x + a

    x = torch.zeros(4)
    sec = tprof.time_op(fn, torch.ones(4), x, reps=7, passes=2)
    assert sec > 0 and len(calls) == 7 * 3            # warm-up + 2 passes
    row = tprof.RooflineRow("x", 1e-3, 10**9).finish(2e12)
    assert row.bw_frac == pytest.approx(0.5)


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as prof:
        torch.ones(8) @ torch.ones(8)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert "traceEvents" in events
    assert len(prof.key_averages()) > 0
