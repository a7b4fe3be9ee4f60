"""One short run of each cell on the card, through run.py as every
benchmark run goes:

    python -m pytest -m cuda h100_bench/tests/test_h100_cuda.py

Skips without a card (decided in the fixture)."""
import json
import subprocess
import sys

import pytest

from h100_bench import harness


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.manifest()["workloads"]])
def test_short_run(card, cell):
    import torch
    chips = {w["name"]: w["chips"] for w in harness.manifest()["workloads"]}
    if chips[cell] > torch.cuda.device_count():
        pytest.skip(f"{cell} needs {chips[cell]} cards")
    res = subprocess.run(
        [sys.executable, "h100_bench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=900, cwd=harness.REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["platform"] == "gpu"
