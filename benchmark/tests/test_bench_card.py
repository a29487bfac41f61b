"""One short run of a cell on the card, started as its command line starts it (marked
`cuda`; skips without a card): `python -m pytest -m cuda benchmark/tests`."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent.parent


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the port's CUDA path")


@pytest.mark.cuda
def test_a_short_serving_run_is_correct(card):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "kitti360.serve",
                          "--seed", "4294967311", "--seconds", "3", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
