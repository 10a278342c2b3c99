"""Fixtures of the benchmark's CPU tests: the repository on the path, and a
copy of the benchmark with tiny configurations (d = 16, n = 32; m = 8, and
m = 64 for the batch mix, whose W - 1 pivot rows need free rows) and a tiny
cell of each traffic mix, found by name as any other.

    python -m pytest -q portbench/tests
"""

import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

MIXES = {"prove": "prove_serial", "setup": "setup_serial", "verify": "verify_mixed",
         "prove_batch": "prove_batch10"}
CONFIGS = {"prove_batch": "tiny64"}  # the tiny cell's configuration, where not "tiny"
REAL = {"prove": "release.prove", "setup": "release.setup", "verify": "release.verify",
        "prove_batch": "release.prove_batch10"}  # whose metrics each tiny cell reports


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")
    import torch

    # one thread, as run.py takes: a whole run's window is seconds long, and under pytest-xdist each
    # worker's default threads oversubscribe the cores and leave a window too few requests
    torch.set_num_threads(1)


def bench() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(root of a copy of the benchmark that holds the tiny configurations,
    BENCHMARK.json's object with the cells tiny.prove, tiny.setup,
    tiny.verify and tiny.prove_batch beside the real ones)."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(ROOT / "portbench" / "configs" / "release.json") as f:
        cfg = json.load(f)
    b = bench()
    for name, m in (("tiny", 8), ("tiny64", 64)):
        with open(root / "portbench" / "configs" / f"{name}.json", "w") as f:
            json.dump(dict(cfg, d=16, m=m, n=32), f)
        b["configs"].append({"name": name, "source": f"the release macros at d = 16, m = {m}, n = 32",
                             "file": f"portbench/configs/{name}.json", "reduced": ["d", "m", "n"],
                             "why": "CPU tests"})
    for kind, mix in MIXES.items():
        name = f"tiny.{kind}"
        b["workloads"].append({"name": name, "config": CONFIGS.get(kind, "tiny"), "traffic": mix,
                               "chips": 1, "why": "CPU tests"})
        for m in b["end_to_end"] + b["per_layer"]:
            if REAL[kind] in m.get("workloads", []):
                m["workloads"].append(name)
    return root, b
