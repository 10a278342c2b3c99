"""On the card: a short run of each cell judged correct, and the control at
a cell's own size judged not correct, each in a process of its own as the
driver starts them.  Skips without a CUDA device.

    python -m pytest -q portbench/tests/test_portbench_card.py
"""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, bench


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _run(*args) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=900)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_runs_correct(card, cell):
    p = _run("portbench/run.py", "--workload", cell, "--seed", str((1 << 31) + 99),
             "--seconds", "2", "--trace", "0")
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu", result


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_control_is_not_correct(card, cell):
    p = _run("portbench/control.py", "--workload", cell, "--seed", str((1 << 31) + 98))
    assert p.returncode == 0, p.stderr[-4000:]
    assert not json.loads(p.stdout.strip().splitlines()[-1])["readings"][0]["correct"]
